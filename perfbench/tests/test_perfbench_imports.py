"""Nothing the benchmark runs holds JAX or the JAX package: each module's
top-level name is compared whole (the measured package's name begins with
the JAX package's); and the plain reference imports nothing of the
measured package."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness

PERFBENCH = Path(harness.__file__).resolve().parent
PORT = "wc_path_tracer_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources():
    return sorted(PERFBENCH.rglob("*.py"))


def test_no_source_imports_jax_or_the_jax_package():
    found = {(str(p.relative_to(PERFBENCH)), m) for p in _sources()
             for m in _imports(p) if m.split(".")[0] in harness.FORBIDDEN}
    assert not found


def test_the_top_level_name_is_compared_whole():
    assert PORT.split(".")[0] not in harness.FORBIDDEN
    assert "wc_path_tracer_tpu" in harness.FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = sorted((PERFBENCH / "reference").rglob("*.py"))
    assert ref
    for p in ref:
        mods = set(_imports(p))
        assert all(m.split(".")[0] in {"__future__", "contextlib",
                                       "dataclasses", "math", "numpy",
                                       "torch"} for m in mods), (p, mods)


def test_a_run_holds_no_jax_module():
    """A whole cell run in a fresh process, then sys.modules."""
    code = (
        "import json, torch\n"
        "from perfbench import harness\n"
        "from perfbench.tests.helpers import run_small\n"
        "line = run_small('bunny-train', size=16, seconds=0.5)\n"
        "print(json.dumps({'correct': line['correct'], "
        "'found': harness.forbidden_modules(), "
        "'port': 'wc_path_tracer_tpu_torch' in __import__('sys').modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(harness.ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "found": [], "port": True}


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing on
    standard output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    bench = harness.spec()
    out = subprocess.run(bench["command"] + [
        "--workload", "cornell-train", "--seed", "5123456789", "--seconds",
        "1", "--trace", "0"], capture_output=True, text=True,
        cwd=str(harness.ROOT), timeout=300)
    assert out.returncode != 0 and out.stdout == ""
