"""Port vs JAX package: next-event estimation and MIS.

The same scenes (built by both packages' SceneBuilders from the same
numbers), rays, seeds and configs go through the JAX functions and their
ports.  Integer results (light picks, PCG seeds, occlusion flags, triangle
ids) must be equal bit for bit; floats within the stated tolerances.
Frames are 16 x 16 with 2 bounces.  Their JAX references are evaluated op
by op, each product and sum rounded on its own as the port rounds them:
under ``jit`` XLA-CPU contracts multiply-adds into FMAs, which flips
roundoff-decided choices (ROADMAP C1 in the 555-unit boxes, a lane in ~256
elsewhere).  Op by op, every final PCG seed is equal.

``lit_bunny_like`` is ``bunny_like_scene(2)`` plus one emissive sphere of
``default_scene``'s "Left" material at (-2, 3, 1), radius 0.5, clear of
the mesh: the stock bunny is lit by the sky alone, so NEE would sample
nothing there.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wc_path_tracer_tpu.models import builtin as jbuiltin
from wc_path_tracer_tpu.models import procedural as jproc
from wc_path_tracer_tpu.ops import rng as jrng
from wc_path_tracer_tpu.render import golden as jgolden
from wc_path_tracer_tpu.render import sweep as jsweep
from wc_path_tracer_tpu.scene import camera as jcamera
from wc_path_tracer_tpu.scene import types as jtypes
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.models import builtin, procedural
from wc_path_tracer_tpu_torch.ops import rng
from wc_path_tracer_tpu_torch.render import golden, sweep, wavefront
from wc_path_tracer_tpu_torch.scene import camera, types

torch.set_num_threads(2)

FRAME = 3
CFG = dict(width=16, height=16, samples=1, max_bounces=2)
LAMBERTIAN, METAL = types.MATERIAL_LAMBERTIAN, types.MATERIAL_METAL


def build_both(add):
    """(JAX scene, port scene) from one function that fills a SceneBuilder;
    the material type ids of the two packages are the same integers."""
    jb, tb = jtypes.SceneBuilder(), types.SceneBuilder()
    add(jb)
    add(tb)
    return jb.build(), tb.build("cpu")


def add_lit_bunny_like(b):
    body = b.add_material(LAMBERTIAN, albedo=(0.65, 0.6, 0.5))
    ground = b.add_material(METAL, albedo=(0.6, 0.6, 0.6), roughness=0.9)
    v, idx = procedural.bumpy_sphere(2)
    v[:, 1] += 1.0
    b.add_mesh(v, idx, tri_material=body)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    lamp = b.add_material(METAL, emission=(1.6, 1.6, 1.6),
                          emission_strength=1.0)
    b.add_sphere((-2.0, 3.0, 1.0), 0.5, lamp)


def add_many_lights(b):
    """A seeded soup of 96 triangles over three emissive materials and two
    emissive spheres: a light CDF of ~100 non-zero steps."""
    r = np.random.default_rng(5)
    mats = [b.add_material(LAMBERTIAN, albedo=(0.5, 0.5, 0.5),
                           emission=tuple(r.uniform(0.2, 2.0, 3)),
                           emission_strength=float(r.uniform(0.5, 4.0)))
            for _ in range(3)]
    centers = r.normal(size=(96, 1, 3), scale=2.0)
    v = (centers + r.normal(size=(96, 3, 3), scale=0.4)).reshape(-1, 3)
    v[:, 2] -= 4.0
    b.add_mesh(v.astype(np.float32), np.arange(288, dtype=np.int32),
               tri_material=r.integers(0, 3, 96).astype(np.int32))
    b.add_sphere((1.0, 1.0, -3.0), 0.4, mats[0])
    b.add_sphere((-1.0, 0.5, -5.0), 0.7, mats[2])


@functools.lru_cache(maxsize=None)
def scene_case(name):
    """(JAX scene, JAX matrices, port scene, port matrices) of ``name``; the
    port gets the JAX camera matrices."""
    if name == "cornell":
        (js, jcam), (ts, _) = (jbuiltin.cornell_box_scene(),
                               builtin.cornell_box_scene(device="cpu"))
    elif name == "default":
        js, jcam = jbuiltin.default_scene(), jbuiltin.default_camera()
        ts = builtin.default_scene(device="cpu")
    elif name == "full_bsdf":
        (js, jcam), (ts, _) = (jbuiltin.full_bsdf_scene(),
                               builtin.full_bsdf_scene(device="cpu"))
    elif name == "lit_bunny":
        js, ts = build_both(add_lit_bunny_like)
        jcam = jproc.bunny_like_scene(1)[1]
    else:
        js, ts = build_both(add_many_lights)
        jcam = jcamera.Camera.create(position=(0.0, 0.0, 1.0))
    jm = jcamera.camera_matrices(jcam, 1.0)
    tm = camera.matrices_from_numpy(np.asarray(jm.inverse_projection),
                                    np.asarray(jm.inverse_view),
                                    np.asarray(jm.position), "cpu")
    return js, jm, ts, tm


def op_by_op(fn):
    def eager(*args, **kw):
        with jax.disable_jit():
            return fn(*args, **kw)
    return eager


def random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.normal(size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] -= 0.8
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def assert_images_close(got, want):
    """ROADMAP A4's image tolerance: at most 1 % of pixels off by more than
    1e-3, a mean |diff| <= 1e-4 over the rest."""
    diff = np.abs(got - want).max(axis=-1)
    assert np.all(np.isfinite(got))
    flipped = diff > 1e-3
    assert flipped.mean() <= 0.01, flipped.mean()
    assert diff[~flipped].mean() <= 1e-4, diff[~flipped].mean()


@pytest.mark.parametrize("name", ["cornell", "default", "full_bsdf",
                                  "lit_bunny", "many_lights"])
def test_light_tables_match_jax(name):
    js, _, ts, _ = scene_case(name)
    # op by op: under jit XLA-CPU contracts the area's products into FMAs
    want = [np.asarray(x) for x in op_by_op(jgolden._light_tables)(js)]
    got = [x.numpy() for x in golden._light_tables(ts)]
    labels = ("weights", "s_lum", "t_lum", "tri", "a", "b", "c")
    for label, g, w in zip(labels, got, want):
        if label == "tri":
            g = g.astype(w.dtype)
        if label == "weights" and name == "many_lights":
            # torch's vectorised CPU sqrt is not correctly rounded (1 ulp
            # on one of these 96 areas); the other scenes' areas are exact
            np.testing.assert_allclose(g, w, rtol=2.5e-7, atol=0,
                                       err_msg=label)
        else:
            np.testing.assert_array_equal(g, w, err_msg=label)
    assert np.count_nonzero(want[0]) > 0


@pytest.mark.parametrize("name", ["cornell", "many_lights"])
def test_occluded_brute_matches_jax(name):
    js, _, ts, _ = scene_case(name)
    scale = 300.0 if name != "many_lights" else 1.0
    o, d = random_rays(512, 7)
    o = o * scale + (np.array([278.0, 273.0, -278.0], np.float32)
                     if scale > 1 else 0.0)
    maxd = np.random.default_rng(8).uniform(-1.0, 6.0, 512).astype(
        np.float32) * scale
    cfg = RenderConfig(**CFG)
    want = np.asarray(jgolden.occluded_brute(js, o, d, maxd, JConfig(**CFG)))
    got = golden.occluded_brute(ts, *(torch.from_numpy(x)
                                      for x in (o, d, maxd)), cfg).numpy()
    np.testing.assert_array_equal(got, want)
    # the any-hit equals the closest hit bounded at max_dist
    rec = golden.intersect_scene_brute(ts, torch.from_numpy(o),
                                       torch.from_numpy(d), cfg)
    closest = (rec.hit & (rec.t < torch.from_numpy(maxd))).numpy()
    np.testing.assert_array_equal(got, closest)
    assert 0 < got.sum() < got.size


def test_occluded_sweep_matches_brute_and_jax():
    """tests/test_sweep.py::test_sweep_occlusion_matches_brute on the port:
    the sweep's any-hit through the plain twin, with -inf (disabled) lanes
    and finite bounds mixed, equals the brute any-hit and the JAX
    package's sweep (its kernel in interpret mode)."""
    js, _, ts, _ = scene_case("many_lights")
    o, d = random_rays(1024, 6)
    maxd = np.full(1024, 3.0, np.float32)
    maxd[::5] = -np.inf
    maxd[1::7] = 0.5
    targs = [torch.from_numpy(x) for x in (o, d, maxd)]
    for kw in ({}, dict(ray_sort="static"), dict(ray_sort="off"),
               dict(cluster_kernel="mxu")):
        cfg = RenderConfig(**CFG, **kw)
        got = sweep.occluded_sweep(ts, *targs, cfg).numpy()
        brute = golden.occluded_brute(ts, *targs, cfg).numpy()
        np.testing.assert_array_equal(got, brute, err_msg=str(kw))
        fn = sweep.make_intersect_fn(ts, cfg)
        np.testing.assert_array_equal(
            fn.occlusion_fn(ts, *targs, cfg).numpy(), brute, err_msg=str(kw))
    want = np.asarray(jsweep.occluded_sweep(js, o, d, maxd, JConfig(**CFG)))
    np.testing.assert_array_equal(got, want)
    assert not got[::5].any() and 0 < got.sum() < got.size


@pytest.mark.parametrize("name", ["cornell", "many_lights"])
def test_sample_direct_light_matches_jax(name):
    """Seeds and light picks bit for bit; contribution, wi and pdf within
    rtol 1e-5.  The hit records are the JAX brute closest hits of camera
    rays, handed to both packages."""
    js, jm, ts, _ = scene_case(name)
    jcfg, cfg = JConfig(**CFG), RenderConfig(**CFG)
    dirs = np.array(jcamera.primary_ray_directions(jm, 16, 16)).reshape(-1, 3)
    origin = np.broadcast_to(np.asarray(jm.position), dirs.shape).copy()
    rec = jax.jit(jgolden.intersect_scene_brute, static_argnames="cfg")(
        js, origin, dirs, jcfg)
    r = np.random.default_rng(3)
    seed = r.integers(0, 2**32, dirs.shape[0], dtype=np.uint64).astype(
        np.uint32)
    mask = np.asarray(rec.hit) & (r.random(dirs.shape[0]) < 0.8)

    run = jax.jit(functools.partial(jgolden.sample_direct_light,
                                    intersect_fn=jgolden.intersect_scene_brute,
                                    cfg=jcfg))
    want = [np.asarray(x) for x in run(js, rec, seed, mask)]
    trec = golden.HitRecord(**{
        f: torch.from_numpy(np.array(getattr(rec, f)))
        for f in ("t", "p", "normal", "hit", "front", "material")})
    tseed = torch.from_numpy(seed.astype(np.int64))
    tmask = torch.from_numpy(mask)
    got = golden.sample_direct_light(ts, trec, tseed, tmask,
                                     golden.intersect_scene_brute, cfg)
    contrib, wi, pdf, out_seed = (x.numpy() for x in got)
    np.testing.assert_array_equal(out_seed, want[3].astype(np.int64))
    np.testing.assert_allclose(contrib, want[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(wi, want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pdf, want[2], rtol=1e-5)
    assert np.count_nonzero(contrib.max(-1)) > 0

    # the pick: both packages' CDF over the same weights, the same draw
    u_j, _ = jrng.rand_masked(seed, mask)
    w_j = jgolden._light_tables(js)[0]
    cum_j = jnp.cumsum(w_j)
    pick_j = np.asarray(jnp.searchsorted(cum_j, u_j * cum_j[-1], side="right"))
    u_t, _ = rng.rand_masked(tseed, tmask)
    cum_t = torch.cumsum(golden._light_tables(ts)[0], 0)
    pick_t = torch.searchsorted(cum_t, u_t * cum_t[-1], right=True).numpy()
    np.testing.assert_allclose(cum_t.numpy(), np.asarray(cum_j), rtol=1e-6)
    np.testing.assert_array_equal(pick_t, pick_j)


def _jax_trace(name, mis):
    js, jm, _, _ = scene_case(name)
    dirs = np.array(jcamera.primary_ray_directions(jm, 16, 16)).reshape(-1, 3)
    origin = np.broadcast_to(np.asarray(jm.position), dirs.shape).copy()
    seed = np.asarray(jrng.pixel_seed(np.arange(256, dtype=np.uint32),
                                      np.uint32(FRAME)))
    cfg = JConfig(**CFG, use_nee=True, mis=mis)
    run = op_by_op(functools.partial(jgolden.trace_rays, cfg=cfg))
    light, out = run(js, origin, dirs, seed)
    return origin, dirs, seed, np.asarray(light), np.asarray(out)


jax_trace = functools.lru_cache(maxsize=None)(_jax_trace)


@pytest.mark.parametrize("mis", [True, False], ids=["mis", "nee"])
@pytest.mark.parametrize("name,backend", [
    ("cornell", "golden"), ("default", "golden"), ("full_bsdf", "golden"),
    ("lit_bunny", "sweep"), ("lit_bunny", "pallas")])
def test_nee_frames_match_jax(name, backend, mis):
    """NEE and NEE+MIS radiance and final seeds of 16 x 16 camera rays,
    each backend held to the JAX package's brute-force transport (its
    sweep gives the brute path's hits, tests/test_sweep.py); the sweep
    through its plain twin, "pallas" through the CPU walk."""
    origin, dirs, seed, light_j, seed_j = jax_trace(name, mis)
    _, _, ts, _ = scene_case(name)
    cfg = RenderConfig(**CFG, use_nee=True, mis=mis)
    fn = {"golden": golden.intersect_scene_brute,
          "sweep": sweep.make_intersect_fn(ts, cfg),
          "pallas": wavefront.intersect_scene_pallas}[backend]
    light, out = golden.trace_rays(
        ts, torch.from_numpy(origin), torch.from_numpy(dirs),
        torch.from_numpy(seed.astype(np.int64)), cfg, fn)
    assert_images_close(light.numpy().reshape(16, 16, 3),
                        light_j.reshape(16, 16, 3))
    np.testing.assert_array_equal(out.numpy(), seed_j.astype(np.int64))
    assert light.numpy().max() > 0.0


def test_pallas_shadow_walk_alive_mask_keeps_the_image():
    """Under NEE the "pallas" backend takes its shadow rays through the full
    closest hit; it gets the lanes that sample a light as its alive mask,
    and the frame must equal the frame walking every lane."""
    _, _, ts, tm = scene_case("lit_bunny")

    def every_lane(scene, origin, direction, cfg):
        return wavefront.intersect_scene_pallas(scene, origin, direction, cfg)

    for mis in (True, False):
        cfg = RenderConfig(**CFG, use_nee=True, mis=mis)
        a = golden.render_frame(ts, tm, cfg, FRAME,
                                wavefront.intersect_scene_pallas)
        b = golden.render_frame(ts, tm, cfg, FRAME, every_lane)
        assert torch.equal(a, b)
