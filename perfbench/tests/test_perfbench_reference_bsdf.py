"""The full-BSDF configuration's plain reference (perfbench/reference/
bsdf.py) against the measured program's plain path on the CPU, whose
shading the fused kernel T1 matches bit for bit on the card: the scene the
configuration builds, frames of the four material models with Russian
roulette and compaction, the bfloat16 control, agreement with
``transport`` where both apply, what ``covers`` refuses, and the cell
through its own loop, check and faults."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench import calibrate, check, harness, program
from perfbench.reference import bsdf, transport
from perfbench.reference import post as ref_post

from .helpers import SEED, run_small, small

CELL = "bsdf-serve"


def _config(name="bsdf"):
    return json.loads((harness.ROOT / f"perfbench/configs/{name}.json")
                      .read_text())


def _limits():
    return harness.cell_parts(harness.spec(), CELL)[3]


def _leaves(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    else:
        yield prefix, obj


def _assert_same_leaves(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == b[k].dtype and torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def test_the_configuration_builds_full_bsdf_scene():
    from wc_path_tracer_tpu_torch.models import builtin

    scene, cam = program.build_scene(harness.load_scene(_config()), "cpu")
    want_scene, want_cam = builtin.full_bsdf_scene(device="cpu")
    _assert_same_leaves(scene, want_scene)
    _assert_same_leaves(cam, want_cam)


def _random_materials(seed, materials):
    """The configuration's materials with every row but the light drawn
    from ``seed``; each of the four types appears."""
    rng = np.random.default_rng(seed)
    rows = [i for i in range(len(materials)) if i != 3]
    kinds = rng.permutation([0, 1, 2, 3] + list(rng.integers(0, 4,
                                                             len(rows) - 4)))
    out = [dict(m) for m in materials]
    for i, kind in zip(rows, kinds):
        out[i] = dict(mtype=int(kind),
                      albedo=rng.uniform(0.05, 1.0, 3).tolist(),
                      roughness=float(rng.uniform(0.0, 1.0)),
                      metallic=float(rng.uniform(0.0, 1.0)),
                      ior=float(rng.uniform(1.1, 2.0)),
                      absorption=rng.uniform(0.0, 1.0, 3).tolist(),
                      absorption_strength=float(rng.uniform(0.0, 0.05)))
    return out


def _frames_against_reference(raw, render, frames):
    """The program's frames and the reference's, accumulated, -> the check's
    numbers (largest over ``frames``)."""
    from wc_path_tracer_tpu_torch.render import golden
    from wc_path_tracer_tpu_torch.scene.camera import camera_matrices

    post = harness.cell_parts(harness.spec(), CELL)[2]["post"]
    scene, cam = program.build_scene(raw, "cpu")
    cfg = program.render_config(render)
    mats = camera_matrices(cam, render["width"] / render["height"])
    ref = bsdf.prepare(raw, "cpu")
    img = ref_img = None
    worst = {}
    with torch.no_grad(), bsdf.exact_matmuls():
        for f in range(frames):
            img = golden.accumulate(img, golden.render_frame(scene, mats,
                                                             cfg, f), f)
            ref_img = bsdf.accumulate(ref_img,
                                      bsdf.render_frame(ref, render, f), f)
            n = check.serve_numbers(
                img, ref_post.finalize(img, post["tonemap"], post["gamma"],
                                       post["bloom"]),
                ref_img, ref_post.finalize(ref_img, post["tonemap"],
                                           post["gamma"], post["bloom"]))
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in n.items()}
    return worst, img


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compact"])
@pytest.mark.parametrize("table", [None, 1, 2, 3],
                         ids=["bsdf", "random1", "random2", "random3"])
def test_program_frames_match_the_reference(compact, table):
    """48 x 32, 8 bounces, roulette from bounce 3, compaction off and on:
    the accumulated frames agree within the cell's limits, on the
    configuration's materials and on seeded random tables of all four
    types (ior 1.1-2.0, absorption, roughness, metallic)."""
    cfg = _config()
    raw = harness.load_scene(cfg)
    if table is not None:
        raw = dict(raw, materials=_random_materials(
            SEED + table, raw["materials"]))
    assert {m["mtype"] for m in raw["materials"]} == {0, 1, 2, 3}
    render = dict(cfg["render"], width=48, height=32, compact=compact)
    assert render["max_bounces"] == 8 and render["use_rr"]
    worst, img = _frames_against_reference(raw, render, 3)
    limits = _limits()
    assert all(worst[k] <= limits[k] for k in limits), worst
    assert float(img.amax()) > 0.0


def test_the_bfloat16_control_fails_the_limits():
    numbers = calibrate.control_reading(CELL, SEED, torch.device("cpu"),
                                        small(16))
    limits = _limits()
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("name", ["cornell", "bunny", "bsdf"])
def test_metal_and_lambertian_scenes_equal_transport(name):
    """Where ``transport`` applies too (metal and Lambertian, roulette
    off), the two references give the same pixels; on the full-BSDF box
    its glass and GGX rows are made metal and Lambertian."""
    cfg = _config(name)
    raw = harness.load_scene(cfg)
    if name == "bsdf":
        raw = dict(raw, materials=[
            dict(m, mtype={1: 0, 3: 2}.get(m["mtype"], m["mtype"]))
            for m in raw["materials"]])
    render = dict(cfg["render"], width=24, height=16, use_rr=False,
                  max_bounces=min(cfg["render"]["max_bounces"], 4))
    assert transport.covers(raw, render) is None
    ours, theirs = bsdf.prepare(raw, "cpu"), transport.prepare(raw, "cpu")
    with bsdf.exact_matmuls():
        for f in (0, 3):
            assert torch.equal(bsdf.render_frame(ours, render, f),
                               transport.render_frame(theirs, render, f))


@pytest.mark.parametrize("field", ["use_nee", "pixel_jitter"])
def test_covers_refuses_nee_and_jitter(field):
    cfg = _config()
    raw = harness.load_scene(cfg)
    assert bsdf.covers(raw, cfg["render"]) is None
    why = bsdf.covers(raw, dict(cfg["render"], **{field: True}))
    assert why and field in why


def test_the_cell_matches_its_reference():
    line = run_small(CELL, size=16, seconds=2.0)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert line["checks"]["hdr_px_share"]["value"] == 0.0
    assert line["checks"]["u8_px_share"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_the_cells_faults_fail(fault):
    line = run_small(CELL, fault=fault, size=16, seconds=3.0)
    assert not line["correct"], line["checks"]


def test_shade_ms_reads_t1_alone():
    """The reader sums the device time of ``shade_segment`` kernels over
    the stretch's frames, and finds nothing where T1 did not run."""
    read = harness.metric_reader("shade_ms.serve")
    kernels = [("shade_segment(Params)", 0, 2_000_000),
               ("shade_segment(Params)", 5, 1_000_000),
               ("sweep_kernel", 9, 7_000_000)]

    def view(k):
        stretch = type("S", (), {"kernels": k, "units": 2})()
        return harness.MetricView(stretch=stretch, render={}, world=1,
                                  scene_sizes={}, spans={})

    assert read(view(kernels)) == pytest.approx(1.5)
    assert read(view(kernels[2:])) is None
