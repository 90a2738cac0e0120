"""BENCHMARK.json against the benchmark's contract, and the finding of
configurations, traffic mixes, limits, metrics and references by name."""

import importlib
import json
import re
import shutil
import sys

import pytest
import torch

import perfbench.reference
from perfbench import harness, program

from .helpers import SEED, small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.spec()


def test_top_level(bench):
    assert set(bench) == KEYS
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["perfbench"]
    assert len(bench["command"]) <= 32
    assert all(TEXT.match(w) for w in bench["command"])
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_texts(bench):
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]] + \
        [w["traffic"] for w in bench["workloads"]] + \
        [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["why"] for c in bench["configs"]] + \
            [c["source"] for c in bench["configs"]] + \
            [w["why"] for w in bench["workloads"]] + \
            [m["layer"] for m in bench["per_layer"]]:
        assert TEXT.match(text), text
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names))


def test_entries_have_the_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_it_must(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        cell = w["name"]
        mine = [m["name"] for m in harness.cell_metrics(bench, cell, False)]
        assert "setup_s" in mine and len(mine) >= 2, cell
        layer = harness.cell_metrics(bench, cell, True)
        assert layer, cell
        for m in layer:          # each reports the metric it moves
            assert m["moves"] in mine, (cell, m["name"])
        harness.cell_parts(bench, cell)      # its files exist
        assert harness.loop_module(harness.cell_parts(bench, cell)[2])
    for m in bench["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        for cell in m["workloads"]:
            assert cell in {w["name"] for w in bench["workloads"]}


def test_configs_state_their_cut(bench):
    for c in bench["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["precision"]
        assert harness.load_scene(cfg)["vertices"].shape[1] == 3


def test_added_files_are_found_by_name(tmp_path, bench):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as files in another tree are found with no edit."""
    here = tmp_path / "perfbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (here / d).mkdir(parents=True)
    cfg = json.loads((harness.ROOT / "perfbench/configs/cornell.json")
                     .read_text())
    cfg["render"] = dict(cfg["render"], width=64, height=64)
    (here / "configs/tiny.json").write_text(json.dumps(cfg))
    (here / "traffic/slow.json").write_text(json.dumps(
        {"kind": "train", "world": 1, "trainable": ["albedo"],
         "warmup_steps": 1, "check_steps": 1, "trace_skip": 1,
         "trace_steps": 1}))
    (here / "limits/tiny-slow.json").write_text('{"loss_rel": 1e-4}')
    (here / "metrics/units.train.py").write_text(
        "def read(view):\n    return view.stretch.units\n")
    spec = dict(bench, configs=bench["configs"] + [dict(
        bench["configs"][0], name="tiny", file="perfbench/configs/tiny.json")],
        workloads=bench["workloads"] + [dict(
            bench["workloads"][0], name="tiny-slow", config="tiny",
            traffic="slow")])
    cell, config, traffic, limits = harness.cell_parts(
        spec, "tiny-slow", root=tmp_path, here=here)
    assert config["render"]["width"] == 64 and traffic["kind"] == "train"
    assert limits == {"loss_rel": 1e-4}
    assert harness.loop_module(traffic).__name__ == "perfbench.loops.train"
    assert len(harness.load_scene(config)["indices"]) == 96
    view = harness.MetricView(stretch=type("S", (), {"units": 7})(),
                              render=config["render"], world=1,
                              scene_sizes={}, spans={})
    assert harness.metric_reader("units.train", here=here)(view) == 7
    shutil.rmtree(here)


SERVE_LIMITS = {"hdr_px_share": 1e-4, "u8_px_share": 1e-4}
TRANSPORT = "perfbench.reference.transport"
TINY_REF = """\
from perfbench.reference.transport import (accumulate, covers, exact_matmuls,
                                           prepare, with_camera,
                                           with_material)
from perfbench.reference.transport import render_frame as _render_frame

FRAMES = []


def render_frame(sc, render, frame):
    FRAMES.append(frame)
    return _render_frame(sc, render, frame)
"""


def _cell_in(tmp_path, bench, **changes):
    """BENCHMARK.json with one more configuration, the Cornell box's file
    with ``changes``, written under ``tmp_path``, and one serving cell of it
    ("tiny-serve")."""
    cfg = json.loads((harness.ROOT / "perfbench/configs/cornell.json")
                     .read_text())
    cfg.update(changes)
    path = tmp_path / "perfbench" / "configs" / "tiny.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cfg))
    return str(path), dict(
        bench, configs=bench["configs"] + [dict(
            bench["configs"][0], name="tiny", file=str(path))],
        workloads=bench["workloads"] + [dict(
            bench["workloads"][0], name="tiny-serve", config="tiny")])


def _ctx(name, spec=None, seconds=1.5, **render):
    ov = dict(small(16), limits=SERVE_LIMITS)
    ov["render"] = {**ov["render"], **render}
    return harness.make_ctx(name, SEED, seconds, False, torch.device("cpu"),
                            harness.process_started(), overrides=ov,
                            bench=spec)


def test_a_configuration_runs_through_the_reference_it_names(
        tmp_path, bench, monkeypatch):
    """A reference module added as a file, and a configuration that names
    it, are found with no edit, and the cell's check runs through it."""
    ref_dir = tmp_path / "perfbench" / "reference"
    ref_dir.mkdir(parents=True)
    (ref_dir / "tiny_ref.py").write_text(TINY_REF)
    monkeypatch.setattr(perfbench.reference, "__path__",
                        [*perfbench.reference.__path__, str(ref_dir)])
    importlib.invalidate_caches()
    _, spec = _cell_in(tmp_path, bench, reference="tiny_ref")
    try:
        ctx = _ctx("tiny-serve", spec)
        assert ctx.reference.__name__ == "perfbench.reference.tiny_ref"
        line = harness.run_cell(ctx)
        assert line["correct"], line["checks"]
        assert ctx.reference.FRAMES
    finally:
        sys.modules.pop("perfbench.reference.tiny_ref", None)


def test_a_configuration_without_a_reference_takes_transport(bench):
    assert harness.reference_module({}, "x").__name__ == TRANSPORT
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        c = configs[w["config"]]
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        module = harness.reference_module(cfg, c["file"])
        assert module.__name__ == ("perfbench.reference."
                                   + cfg.get("reference", "transport"))
        assert _ctx(w["name"], seconds=0).reference is module


@pytest.mark.parametrize("name", ["no_such_ref", "post"])
def test_an_unknown_reference_names_the_module_and_the_file(tmp_path,
                                                            bench, name):
    """A name with no module, or with a module that is no reference (the
    shared post-processing), is refused with the module and the file."""
    file, spec = _cell_in(tmp_path, bench, reference=name)
    with pytest.raises(SystemExit) as e:
        _ctx("tiny-serve", spec)
    assert f"perfbench.reference.{name}" in str(e.value.code)
    assert file in str(e.value.code)


@pytest.mark.parametrize("outside", ["dielectric", "russian_roulette"])
def test_a_configuration_outside_its_reference_fails_before_the_window(
        tmp_path, bench, monkeypatch, outside):
    """Refused with ``covers``'s reason and the configuration's file while
    the run's context is built: the program's scene, and so its Renderer
    and any timed frame, are never reached."""
    built = []
    monkeypatch.setattr(program, "build_scene",
                        lambda *a, **k: built.append(a))
    if outside == "dielectric":
        cfg = json.loads((harness.ROOT / "perfbench/configs/cornell.json")
                         .read_text())
        mats = [dict(m) for m in cfg["scene"]["materials"]]
        mats[1] = {"mtype": 1, "albedo": [1.0, 1.0, 1.0], "ior": 1.5}
        file, spec = _cell_in(tmp_path, bench,
                              scene=dict(cfg["scene"], materials=mats))
        name, render = "tiny-serve", {}
    else:
        file, spec = "perfbench/configs/cornell.json", None
        name, render = "cornell-serve", {"use_rr": True}
    config = json.loads((harness.ROOT / file).read_text())
    why = harness.reference_module(config, file).covers(
        harness.load_scene(config), {**config["render"], **render})
    assert why
    with pytest.raises(SystemExit) as e:
        harness.run_cell(_ctx(name, spec, **render))
    assert why in str(e.value.code) and file in str(e.value.code)
    assert not built
