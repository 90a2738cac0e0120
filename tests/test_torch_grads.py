"""Port vs JAX package: gradients of the bench loss, and finite gradients.

The bench loss (``bench.py:140-153``) is ``mean((img - target)**2)``
against a zero target, differentiated with respect to ``albedo``,
``emission``, ``emission_strength`` and ``roughness``; the mesh vertices
join them here.  The port's ``scene_loss_grad`` is held against the JAX
package's gradient of the same loss (``jax.vjp`` of its frame, evaluated
op by op, as the port rounds), 16 x 16 pixels, 2 bounces, with NEE off
(the bench's headline) and with NEE+MIS on (the estimator users train
with): the MIS emission weight, its double-where guards and the light
tables' areas and pdfs (vertex grads on the Cornell box, whose light is a
triangle quad) are differentiated on both sides.

Tolerances, as a fraction of each leaf's largest |g|: on the bunny and
the lit bunny (the port's sweep path against the JAX package's
brute-force path, whose hits its sweep equals, tests/test_sweep.py) 1e-4
for the material leaves and 1e-5 for the vertices.  On the Cornell box
(brute force) 1e-3 for the material leaves; its vertex grads carry the
roundoff-decided paths of ROADMAP C1 (a bounce that re-hits its own
surface on the last bit), so only a bounded fraction of them may differ
by more than 1e-3 of the largest.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from wc_path_tracer_tpu.optim import params as jreg
from wc_path_tracer_tpu.render import golden as jgolden
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.parallel import render as prender
from wc_path_tracer_tpu_torch.render import dispatch, golden
from wc_path_tracer_tpu_torch.scene.camera import Camera, camera_matrices
from wc_path_tracer_tpu_torch.scene.types import (
    MATERIAL_DIELECTRIC, MATERIAL_GGX, MATERIAL_LAMBERTIAN, MATERIAL_METAL,
    SceneBuilder)

from tests.test_torch_nee import op_by_op, scene_case
from tests.test_torch_render import _case as forward_case

torch.set_num_threads(2)

FRAME = 3
CFG = dict(width=16, height=16, samples=1, max_bounces=2)
TRAINABLE = prender.BENCH_TRAINABLE + ("vertices",)


def port_grads(scene, mats, cfg, renderer, trainable=TRAINABLE, target=None):
    if target is None:
        target = torch.zeros((cfg.height, cfg.width, 3))
    loss, grads = prender.scene_loss_grad(cfg, trainable, renderer)(
        scene, mats, FRAME, target)
    return float(loss), {k: g.numpy() for k, g in grads.items()}


NEE_MIS = dict(use_nee=True, mis=True)


def grads_case(name, nee):
    """(JAX scene, JAX matrices, port scene, port matrices); the NEE cases
    take tests/test_torch_nee.py's scenes (its lit bunny has a light)."""
    return scene_case(name) if nee else forward_case(name)


@functools.lru_cache(maxsize=None)
def jax_frame_pullback(name, nee=False):
    """The JAX package's frame of the case and its pullback to the
    trainables, both evaluated op by op."""
    jscene, jm = grads_case(name, nee)[:2]
    cfg = JConfig(**CFG, **(NEE_MIS if nee else {}))

    def render(params):
        s, _ = jreg.apply_params(jscene, None, params)
        return jgolden.render_frame(s, jm, cfg, FRAME)

    img, pullback = op_by_op(jax.vjp)(
        render, jreg.get_params(jscene, None, TRAINABLE))
    return np.asarray(img), op_by_op(pullback)


@pytest.mark.parametrize("name,renderer,nee", [
    pytest.param("bunny", "sweep", False, id="bunny-sweep"),
    pytest.param("cornell", "golden", False, id="cornell-golden"),
    pytest.param("lit_bunny", "sweep", True, id="lit_bunny-sweep-nee-mis"),
    pytest.param("cornell", "golden", True, id="cornell-golden-nee-mis")])
def test_bench_loss_grads_match_jax(name, renderer, nee):
    """The bench loss and its grads.  A pixel whose path is decided by
    roundoff (ROADMAP C1: a bounce ray that re-hits its own surface on the
    last bit) differs by far more than 1e-3; such pixels may be at most 1 %
    of the frame, the image tolerance.  With NEE the flipped path's direct
    light outweighs the grad tolerance, so the NEE cases leave those pixels
    out of the loss on both sides (the target there is each side's own
    pixel); without NEE every pixel counts."""
    _, _, tscene, tm = grads_case(name, nee)
    cfg = RenderConfig(**CFG, **(NEE_MIS if nee else {}))
    want_img, pullback = jax_frame_pullback(name, nee)
    with torch.no_grad():
        got_img = golden.render_frame(
            tscene, tm, cfg, FRAME,
            dispatch.get_intersect_fn(renderer, tscene, cfg)).numpy()
    flipped = (np.abs(got_img - want_img).max(axis=-1) > 1e-3)[..., None]
    assert flipped.mean() <= 0.01, flipped.mean()
    flipped &= nee
    want_loss = float(np.mean(np.where(flipped, 0.0, want_img) ** 2))
    (want,) = pullback(np.where(flipped, 0.0, 2.0 * want_img / want_img.size)
                       .astype(np.float32))
    want = {k: np.asarray(g) for k, g in want.items()}
    got_loss, got = port_grads(
        tscene, tm, cfg, renderer,
        target=torch.from_numpy(np.where(flipped, got_img, 0.0)
                                .astype(np.float32)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-3)
    for k in TRAINABLE:
        assert np.all(np.isfinite(got[k])), k
        scale = float(np.abs(want[k]).max())
        if scale == 0.0:   # e.g. roughness of Lambertian-only scenes
            assert not np.any(got[k]), k
            continue
        err = np.abs(got[k] - want[k]) / scale
        if k != "vertices":
            assert err.max() <= (1e-3 if name == "cornell" else 1e-4), (
                k, err.max())
        elif name != "cornell":
            assert err.max() <= 1e-5, err.max()
        else:
            touched = (want[k] != 0) | (got[k] != 0)
            assert (err[touched] > 1e-3).mean() <= 0.05, (
                err[touched] > 1e-3).mean()


def full_scene():
    """tests/test_grad_sanitizer.py::_full_scene with the port's builder:
    every material type, spheres, a mesh floor and an emissive quad."""
    b = SceneBuilder()
    lam = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.6, 0.4, 0.3))
    met = b.add_material(MATERIAL_METAL, albedo=(0.9, 0.8, 0.6),
                         roughness=0.2)
    diel = b.add_material(MATERIAL_DIELECTRIC, albedo=(1.0, 1.0, 1.0),
                          ior=1.5, absorption=(0.2, 0.1, 0.0),
                          absorption_strength=0.5)
    ggx = b.add_material(MATERIAL_GGX, albedo=(0.7, 0.7, 0.9),
                         roughness=0.35, metallic=0.8)
    lm = b.add_material(MATERIAL_LAMBERTIAN, emission=(1.0, 0.9, 0.8),
                        emission_strength=4.0)
    b.add_sphere((-0.8, 0.0, -3.0), 0.5, met)
    b.add_sphere((0.8, 0.0, -3.0), 0.5, diel)
    b.add_sphere((0.0, 0.9, -3.0), 0.4, ggx)
    floor = np.array([[-3, -0.6, -6], [3, -0.6, -6], [3, -0.6, 0],
                      [-3, -0.6, -6], [3, -0.6, 0], [-3, -0.6, 0]],
                     np.float32)
    b.add_mesh(floor, np.arange(6, dtype=np.int32), tri_material=lam)
    lquad = np.array([[-1, 2, -4.5], [1, 2, -4.5], [1, 2, -2.5],
                      [-1, 2, -4.5], [1, 2, -2.5], [-1, 2, -2.5]],
                     np.float32)
    b.add_mesh(lquad, np.arange(6, dtype=np.int32), tri_material=lm)
    return b.build("cpu"), Camera.create(position=(0.0, 0.2, 0.5),
                                         device="cpu")


GRID = [
    ("nee-mis-golden", {"use_nee": True, "mis": True}, "golden"),
    ("nee-mis-rr-golden", {"use_nee": True, "mis": True, "use_rr": True,
                           "rr_start_bounce": 1}, "golden"),
    ("nee-mis-rr-sweep", {"use_nee": True, "mis": True, "use_rr": True,
                          "rr_start_bounce": 1}, "sweep"),
]


@pytest.mark.parametrize("name,kw,renderer", GRID, ids=[g[0] for g in GRID])
def test_all_trainable_grads_finite(name, kw, renderer):
    """The port's half of tests/test_grad_sanitizer.py: one backward pass
    with respect to every registered trainable at once; every leaf must be
    finite (the double-where guards of the MIS weights and the light
    tables keep masked lanes' 0 * inf out of reverse mode)."""
    scene, cam = full_scene()
    cfg = RenderConfig(width=16, height=16, samples=1, max_bounces=3,
                       sky="gradient", **kw)
    loss_grad = prender.scene_loss_grad(cfg, tuple(reg.ALL_PARAMS), renderer)
    with torch.no_grad():
        target = dispatch.get_render_frame(renderer, scene, cfg)(
            scene, camera_matrices(cam, 1.0), cfg, 0) * 0.5
    loss, grads = loss_grad(scene, cam, 0, target)
    assert np.isfinite(float(loss)), name
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    assert not bad, f"non-finite gradients in {name}: {bad}"
    assert sum(float(g.abs().sum()) for g in grads.values()) > 0.0


@pytest.mark.parametrize("mis", [True, False], ids=["mis", "nee"])
def test_nee_grads_agree_across_backends(mis):
    """NEE renders and differentiates on every backend of the lit bunny:
    brute force, the cluster sweep with the MT and the plane-form block
    tests (their shadow rays through occluded_sweep) and the BVH walk
    (shadow rays through the full closest hit).  The searches pick the same
    winners, so the grads agree with brute force's to within roundoff."""
    _, _, ts, tm = scene_case("lit_bunny")
    cfg = RenderConfig(**CFG, use_nee=True, mis=mis)
    runs = {label: port_grads(ts, tm, c, r) for label, c, r in (
        ("golden", cfg, "golden"), ("sweep", cfg, "sweep"),
        ("mxu", cfg.replace(cluster_kernel="mxu"), "sweep"),
        ("pallas", cfg, "pallas"), ("auto", cfg, "auto"))}
    ref_loss, ref = runs.pop("golden")
    assert ref_loss > 0.0
    for label, (loss, grads) in runs.items():
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5, err_msg=label)
        for k in TRAINABLE:
            assert np.all(np.isfinite(grads[k])), (label, k)
            scale = float(np.abs(ref[k]).max())
            if scale == 0.0:
                assert not np.any(grads[k]), (label, k)
                continue
            err = float(np.abs(grads[k] - ref[k]).max()) / scale
            assert err <= 1e-4, (label, k, err)
