"""The plain reference against the measured program's plain path on the
CPU at 16-32 pixels square, through the cells' own loops and checks: the
bench loss and its grads on both configurations, the accumulated HDR
frame and the post-processed uint8 frame of the serving mix."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import check, harness, program
from perfbench.reference import post as ref_post
from perfbench.reference import transport as reference

from .helpers import run_small


def test_cornell_train_matches_reference():
    line = run_small("cornell-train", size=16)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert line["checks"]["loss_rel"]["value"] <= 1e-6
    assert line["checks"]["grad_rel"]["value"] <= 1e-5


def test_bunny_train_matches_reference():
    line = run_small("bunny-train", size=16)
    assert line["correct"] and line["failed"] == 0
    assert line["checks"]["loss_rel"]["value"] <= 1e-6
    assert line["checks"]["grad_rel"]["value"] <= 1e-5


@pytest.mark.parametrize("cell", ["bunny-serve", "cornell-serve"])
def test_serve_matches_reference(cell):
    line = run_small(cell, size=16, seconds=2.0)
    assert line["correct"] and line["failed"] == 0
    assert line["checks"]["hdr_px_share"]["value"] == 0.0
    assert line["checks"]["u8_px_share"]["value"] == 0.0


def test_post_processing_matches_the_renderer():
    """The reference's bloom, ACES, gamma and uint8 against the program's
    Renderer.output() on one HDR image with values above the bloom
    threshold."""
    from wc_path_tracer_tpu_torch.render.renderer import Renderer

    ctx = harness.make_ctx("bunny-serve", 1, 0, False, torch.device("cpu"),
                           0.0)
    scene, cam = program.build_scene(ctx.raw, "cpu")
    post = ctx.traffic["post"]
    r = Renderer(scene, cam, program.render_config(
        dict(ctx.render, width=37, height=29), **post), device="cpu")
    img = torch.from_numpy(np.random.default_rng(3).gamma(
        0.7, 1.2, (29, 37, 3)).astype(np.float32))
    r.image = img
    ours = ref_post.finalize(img, post["tonemap"], post["gamma"],
                             post["bloom"])
    assert np.array_equal(r.output(), ours.numpy())


def test_the_reference_builds_nothing_of_the_program():
    """The reference's scene is the raw arrays: its triangles are the file's
    triangles in the file's order, none of the program's reordering."""
    ctx = harness.make_ctx("bunny-serve", 1, 0, False, torch.device("cpu"),
                           0.0)
    sc = reference.prepare(ctx.raw, "cpu")
    v, idx = ctx.raw["vertices"], ctx.raw["indices"].reshape(-1, 3)
    assert torch.equal(sc.a, torch.from_numpy(v[idx[:, 0]]))
    ids = torch.cat([g[0] for g in sc.groups]).sort().values
    assert torch.equal(ids, torch.arange(len(idx)))


GLASS = {"mtype": 1, "albedo": [1.0, 1.0, 1.0], "ior": 1.5,
         "absorption": [0.1, 0.02, 0.02], "absorption_strength": 0.02}


def test_every_material_field_reaches_the_program():
    raw = harness.make_ctx("cornell-serve", 1, 0, False, torch.device("cpu"),
                           0.0).raw
    raw = dict(raw, materials=raw["materials"] + [GLASS])
    mats = program.build_scene(raw, "cpu")[0].materials
    i = len(raw["materials"]) - 1
    assert int(mats.count) == i + 1
    for k, v in GLASS.items():
        col = getattr(mats, k)
        assert torch.equal(col[i], torch.tensor(v, dtype=col.dtype)), k


def _leaves(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    else:
        yield prefix, obj


@pytest.mark.parametrize("cell", ["cornell-serve", "bunny-serve"])
def test_todays_scenes_build_as_before(cell):
    """The raw scenes of the benchmark's configurations give the Scene that
    the six fields passed before gave, tensor for tensor: what they leave
    out takes the builder's defaults."""
    from wc_path_tracer_tpu_torch.scene.types import SceneBuilder

    raw = harness.make_ctx(cell, 1, 0, False, torch.device("cpu"), 0.0).raw
    b = SceneBuilder()
    for m in raw["materials"]:
        b.add_material(**{k: m[k] for k in (
            "mtype", "albedo", "emission", "emission_strength", "metallic",
            "roughness") if k in m})
    for sph in raw["spheres"]:
        b.add_sphere(tuple(sph["position"]), sph["radius"], sph["material"])
    b.add_mesh(raw["vertices"], raw["indices"], normals=raw["normals"],
               tri_material=raw["tri_material"])
    before = dict(_leaves(b.build("cpu")))
    after = dict(_leaves(program.build_scene(raw, "cpu")[0]))
    assert before.keys() == after.keys()
    for k, v in before.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == after[k].dtype and torch.equal(v, after[k]), k
        else:
            assert v == after[k], k


def test_check_numbers():
    g = {"a": torch.tensor([3.0, 4.0, 0.0]), "b": torch.zeros(2)}
    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.zeros(2)}
    n = check.train_numbers(2.0, g, 2.0, ref)
    assert n == {"loss_rel": 0.0, "grad_rel": 0.0}
    g["a"][2] = 0.5            # a padded row that the reference holds at 0
    assert check.train_numbers(2.0, g, 2.0, ref)["grad_rel"] == 0.1
    assert check.train_numbers(float("nan"), g, 2.0, ref)["loss_rel"] \
        == float("inf")
    ok, checks = check.verdict([{"x": 0.1}, {"x": 0.3}], {"x": 0.2}, 0)
    assert not ok and checks["x"] == {"value": 0.3, "limit": 0.2}
