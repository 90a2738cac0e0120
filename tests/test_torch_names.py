"""Port vs JAX package: the last public names of the JAX modules.

- ``Materials``/``Spheres``/``MeshBank``/``Scene.empty`` and ``MeshBank``'s
  capacities: every leaf (dtype, shape, value) equal to the JAX one.
- A sky-only ``Scene.empty()`` frame: the gradient sky
  (``tests/test_render_golden.py:30-41``, atol 1e-5) and the JAX frame
  (rtol 1e-6, the float32 sky blend of directions both packages compute
  from the same matrices).
- ``parallel.render.render_image_sharded`` on one gloo rank of the CPU:
  bit for bit ``golden.render_frame``.
- ``wavefront.render_rows_pallas`` and ``sweep.render_rows`` /
  ``sweep.trace_rays`` (rows 8-23 / the primary rays of a 32 x 32 frame of
  ``bunny_like_scene(2)``, 2 bounces): bit for bit ``golden.render_rows`` /
  ``golden.trace_rays`` with the same ``intersect_fn`` (the kernels' plain
  twins on the CPU), and against the JAX wrappers within the sweep and
  walk tests' image tolerance (at most 1 % of pixels off by more than
  1e-3, a mean |diff| <= 1e-4 over the rest).

The rng names (``rand_u32``, ``random_hemisphere_direction``, the tensor
form of ``pixel_seed``) are tests/test_torch_ops.py's.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from wc_path_tracer_tpu.models import builtin as jbuiltin
from wc_path_tracer_tpu.models import procedural as jproc
from wc_path_tracer_tpu.ops import rng as jrng
from wc_path_tracer_tpu.render import golden as jgolden
from wc_path_tracer_tpu.render import sweep as jsweep
from wc_path_tracer_tpu.render import wavefront as jwavefront
from wc_path_tracer_tpu.scene import camera as jcamera
from wc_path_tracer_tpu.scene import types as jtypes
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.models import builtin, procedural
from wc_path_tracer_tpu_torch.ops import rng
from wc_path_tracer_tpu_torch.parallel import render as prender
from wc_path_tracer_tpu_torch.render import golden, sweep, wavefront
from wc_path_tracer_tpu_torch.scene import camera
from wc_path_tracer_tpu_torch.scene import types

from tests.test_torch_nee import assert_images_close

torch.set_num_threads(2)

ROWS = dict(width=32, height=32, samples=1, max_bounces=2)
Y0, NUM_ROWS, FRAME = 8, 16, 1


def assert_same_leaves(got, want):
    """Every dataclass field of ``got`` (a port table) equals ``want``'s
    (the JAX one): tensors in dtype, shape and value, ints in value."""
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if dataclasses.is_dataclass(w):
            assert_same_leaves(g, w)
        elif isinstance(w, int):
            assert g == w, f.name
        else:
            w = np.asarray(w)
            assert g.dtype == torch.from_numpy(w).dtype, f.name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)


EMPTIES = [
    ("materials", lambda m, **k: m.Materials.empty(5, **k)),
    ("spheres", lambda m, **k: m.Spheres.empty(3, **k)),
    ("mesh-default", lambda m, **k: m.MeshBank.empty(**k)),
    ("mesh-sized", lambda m, **k: m.MeshBank.empty(16, 25, 4, 2, **k)),
    ("scene", lambda m, **k: m.Scene.empty(**k)),
    ("scene-sized", lambda m, **k: m.Scene.empty(2, 4, **k)),
]


@pytest.mark.parametrize("make", [e[1] for e in EMPTIES],
                         ids=[e[0] for e in EMPTIES])
def test_empty_leaves_match_jax(make):
    assert_same_leaves(make(types, device="cpu"), make(jtypes))


def test_empty_needs_a_device(monkeypatch):
    """``device=None`` means the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        types.Scene.empty()


def test_mesh_capacities_match_jax():
    names = ("vertex_capacity", "index_capacity", "node_capacity",
             "draw_capacity", "triangle_capacity")
    meshes = [(types.MeshBank.empty(16, 25, 4, 2, device="cpu"),
               jtypes.MeshBank.empty(16, 25, 4, 2)),
              (builtin.cornell_box_scene(device="cpu")[0].mesh,
               jbuiltin.cornell_box_scene()[0].mesh)]
    for got, want in meshes:
        assert {n: getattr(got, n) for n in names} == {
            n: getattr(want, n) for n in names}
    assert meshes[0][0].index_capacity == 27


def _matrices(jcam, aspect):
    jm = jcamera.camera_matrices(jcam, aspect)
    return jm, camera.matrices_from_numpy(
        np.asarray(jm.inverse_projection), np.asarray(jm.inverse_view),
        np.asarray(jm.position), "cpu")


def test_sky_only_scene_matches_gradient_and_jax():
    cfg = dict(width=32, height=24, samples=1, max_bounces=2)
    jm, tm = _matrices(jbuiltin.default_camera(), 32 / 24)
    got = golden.render_frame(types.Scene.empty(device="cpu"), tm,
                              RenderConfig(**cfg), 0).numpy()
    d = camera.primary_ray_directions(tm, 32, 24).numpy()
    a = 0.5 * (d[..., 1:2] + 1.0)
    np.testing.assert_allclose(got, np.array([0.5, 0.7, 1.0]) * (1 - a) + a,
                               atol=1e-5)
    want = np.asarray(jax.jit(jgolden.render_frame, static_argnames="cfg")(
        jtypes.Scene.empty(), jm, JConfig(**cfg), 0))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_render_image_sharded_one_gloo_rank(tmp_path):
    scene, cam = builtin.cornell_box_scene(device="cpu")
    mats = camera.camera_matrices(cam, 1.0)
    cfg = RenderConfig(**ROWS)
    want = golden.render_frame(scene, mats, cfg, FRAME)
    assert torch.equal(prender.render_image_sharded(scene, mats, cfg, FRAME),
                       want)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        got = prender.render_image_sharded(scene, mats, cfg, FRAME,
                                           dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)


@functools.lru_cache(maxsize=None)
def _bunny(max_blas_tris=None):
    """bunny_like_scene(2) in both packages (320 triangles: above the
    brute-force crossover), optionally split into draws."""
    jscene, jcam = jproc.bunny_like_scene(2, max_blas_tris=max_blas_tris)
    tscene, _ = procedural.bunny_like_scene(2, max_blas_tris=max_blas_tris,
                                            device="cpu")
    return (jscene, tscene) + _matrices(jcam, 1.0)


def test_render_rows_pallas_matches_golden_and_jax():
    jscene, tscene, jm, tm = _bunny(128)
    assert int(tscene.mesh.draw_count) >= 3
    cfg = RenderConfig(**ROWS)
    got = wavefront.render_rows_pallas(tscene, tm, cfg, FRAME, Y0, NUM_ROWS)
    assert torch.equal(got, golden.render_rows(
        tscene, tm, cfg, FRAME, Y0, NUM_ROWS,
        intersect_fn=wavefront.make_intersect_fn_pallas(tscene)))
    want = np.asarray(jwavefront.render_rows_pallas(
        jscene, jm, JConfig(**ROWS), FRAME, Y0, NUM_ROWS))
    assert got.shape == (NUM_ROWS, 32, 3) and want.std() > 0.01
    assert_images_close(got.numpy(), want)


def test_sweep_render_rows_matches_golden_and_jax():
    jscene, tscene, jm, tm = _bunny()
    cfg = RenderConfig(**ROWS)
    got = sweep.render_rows(tscene, tm, cfg, FRAME, Y0, NUM_ROWS)
    assert torch.equal(got, golden.render_rows(
        tscene, tm, cfg, FRAME, Y0, NUM_ROWS,
        intersect_fn=sweep.make_intersect_fn(tscene, cfg)))
    want = np.asarray(jax.jit(jsweep.render_rows,
                                  static_argnames=("cfg", "num_rows"))(
        jscene, jm, JConfig(**ROWS), FRAME, Y0, NUM_ROWS))
    assert want.std() > 0.01
    assert_images_close(got.numpy(), want)


def test_sweep_trace_rays_matches_golden_and_jax():
    """The primary rays of the 32 x 32 frame, each with its pixel seed:
    radiance as an image, and the final seeds bit for bit wherever the
    radiance agrees."""
    jscene, tscene, jm, tm = _bunny()
    cfg = RenderConfig(**ROWS)
    d = camera.primary_ray_directions(tm, 32, 32).reshape(-1, 3)
    o = tm.position.expand_as(d)
    seed = rng.pixel_seed(torch.arange(32 * 32), FRAME)
    got, got_seed = sweep.trace_rays(tscene, o, d, seed, cfg)
    ref, ref_seed = golden.trace_rays(tscene, o, d, seed, cfg,
                                      sweep.make_intersect_fn(tscene, cfg))
    assert torch.equal(got, ref) and torch.equal(got_seed, ref_seed)
    want, want_seed = jax.jit(jsweep.trace_rays, static_argnames="cfg")(
        jscene, np.ascontiguousarray(o.numpy()), d.numpy(),
        jrng.pixel_seed(np.arange(32 * 32), FRAME), JConfig(**ROWS))
    want = np.asarray(want)
    assert want.std() > 0.01
    assert_images_close(got.numpy().reshape(32, 32, 3),
                        want.reshape(32, 32, 3))
    same = np.abs(got.numpy() - want).max(-1) <= 1e-3
    np.testing.assert_array_equal(got_seed.numpy()[same],
                                  np.asarray(want_seed).astype(np.int64)[same])
