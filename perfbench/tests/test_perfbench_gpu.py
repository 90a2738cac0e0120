"""The benchmark's command on the card: one short run of each cell and its
result line.  Marked ``gpu``; the fixture skips
where there is no CUDA card (decided when the test runs, not at import).

    python -m pytest -p no:cacheprovider perfbench/tests/test_perfbench_gpu.py
"""

import json
import subprocess

import pytest
import torch

from perfbench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["bunny-serve", "cornell-serve"])
def test_a_short_run_on_the_card(card, cell, trace):
    bench = harness.spec()
    out = subprocess.run(bench["command"] + [
        "--workload", cell, "--seed", "6123456789", "--seconds", "3",
        "--trace", str(trace)], capture_output=True, text=True,
        cwd=str(harness.ROOT), timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"], line
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    want = {m["name"] for m in harness.cell_metrics(bench, cell, bool(trace))}
    assert set(line["metrics"]) == want
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
