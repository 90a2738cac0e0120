"""BENCHMARK.json against the benchmark's contract, and the finding of
configurations, traffic mixes, limits and metrics by name."""

import json
import re
import shutil

import pytest

from perfbench import harness

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
