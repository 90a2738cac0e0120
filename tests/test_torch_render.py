"""Port vs JAX package: the forward render slice end to end.

32 x 32 pixels, 2 bounces, gradient sky.  ``bunny_like_scene(2)`` has 342
triangle slots, so dispatch "auto" takes the cluster-sweep path in both
packages (the JAX kernel in interpret mode, the port's plain twin);
``cornell_box_scene()`` takes the brute-force path.  The port gets the JAX
camera matrices and the same frame number.

Tolerances (ROADMAP A4): the two packages round some products differently
(XLA-CPU may contract FMAs; log/cos/exp differ in the last place), and a
rare discrete choice (a Fresnel draw, an edge-grazing hit) can flip on such
roundoff and send one path elsewhere, changing its pixel by O(1).  So at
most 1% of pixels may be off by more than 1e-3, the others must agree to a
mean |diff| <= 1e-4, and the final PCG seeds (which diverge only after such
a flip) must be equal on >= 99% of pixels.

The Cornell reference is evaluated op by op (``jax.disable_jit``), each
multiply and add rounded on its own as the port does.  Under ``jit``,
XLA-CPU contracts multiply-adds into FMAs, and in this 555-unit box the
bounce offset (1e-5) is below the float32 spacing of the hit points, so
whether a bounce ray re-hits its own surface turns on the last bit: the
jitted reference then disagrees with its own op-by-op evaluation on ~12% of
the final seeds (ROADMAP C1), which ``test_cornell_jit_vs_op_by_op``
records.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from wc_path_tracer_tpu.models import builtin as jbuiltin
from wc_path_tracer_tpu.models import procedural as jproc
from wc_path_tracer_tpu.ops import rng as jrng
from wc_path_tracer_tpu.render import dispatch as jdispatch
from wc_path_tracer_tpu.render import golden as jgolden
from wc_path_tracer_tpu.render import sweep as jsweep
from wc_path_tracer_tpu.scene import camera as jcamera
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.models import builtin, procedural
from wc_path_tracer_tpu_torch.render import dispatch, golden, sweep
from wc_path_tracer_tpu_torch.scene import camera

torch.set_num_threads(2)

FRAME = 3
CFG = dict(width=32, height=32, samples=1, max_bounces=2)


@functools.lru_cache(maxsize=None)
def _case(name):
    if name == "bunny":
        jscene, jcam = jproc.bunny_like_scene(2)
        tscene, _ = procedural.bunny_like_scene(2, device="cpu")
    else:
        jscene, jcam = jbuiltin.cornell_box_scene()
        tscene, _ = builtin.cornell_box_scene(device="cpu")
    jm = jcamera.camera_matrices(jcam, 1.0)
    tm = camera.matrices_from_numpy(np.asarray(jm.inverse_projection),
                                    np.asarray(jm.inverse_view),
                                    np.asarray(jm.position), "cpu")
    return jscene, jm, tscene, tm


def _reference(name, fn):
    """The JAX reference of one case: jitted for the bunny, op by op for the
    Cornell box (see the module docstring)."""
    if name == "bunny":
        return jax.jit(fn, static_argnames="cfg")

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


def _assert_images_close(got, want):
    diff = np.abs(got - want).max(axis=-1)
    assert np.all(np.isfinite(got))
    flipped = diff > 1e-3
    assert flipped.mean() <= 0.01, flipped.mean()
    assert diff[~flipped].mean() <= 1e-4, diff[~flipped].mean()


@pytest.mark.parametrize("name,backend", [("bunny", "sweep"),
                                          ("cornell", "golden")])
def test_frame_matches_jax(name, backend):
    jscene, jm, tscene, tm = _case(name)
    jfn = jdispatch.get_render_frame("auto", jscene, None)
    tfn = dispatch.get_render_frame("auto", tscene, None)
    assert tfn.backend == backend and jfn.__module__.endswith(backend)
    want = np.asarray(_reference(name, jfn)(jscene, jm, JConfig(**CFG), FRAME))
    got = tfn(tscene, tm, RenderConfig(**CFG), FRAME).numpy()
    assert got.shape == (32, 32, 3)
    _assert_images_close(got, want)


@functools.lru_cache(maxsize=None)
def _traced(name, mode):
    """(radiance (1024, 3), final seeds (1024,) int64) of trace_rays on the
    32 x 32 primary rays of frame FRAME: mode "jit" / "op_by_op" for the JAX
    package, "port" for the port."""
    jscene, jm, tscene, _ = _case(name)
    dirs = np.array(jcamera.primary_ray_directions(jm, 32, 32)).reshape(-1, 3)
    origin = np.broadcast_to(np.asarray(jm.position), dirs.shape).copy()
    seed = np.asarray(jrng.pixel_seed(np.arange(32 * 32, dtype=np.uint32),
                                      np.uint32(FRAME)))
    if mode == "port":
        cfg = RenderConfig(**CFG)
        fn = (sweep.make_intersect_fn(tscene, cfg) if name == "bunny"
              else golden.intersect_scene_brute)
        light, out = golden.trace_rays(
            tscene, torch.from_numpy(origin), torch.from_numpy(dirs),
            torch.from_numpy(seed.astype(np.int64)), cfg, fn)
        return light.numpy(), out.numpy()
    jtrace = functools.partial(
        jsweep.trace_rays if name == "bunny" else jgolden.trace_rays,
        cfg=JConfig(**CFG))
    run = (jax.jit(jtrace) if mode == "jit"
           else _reference("cornell", jtrace))
    light, out = run(jscene, origin, dirs, seed)
    return np.asarray(light), np.asarray(out).astype(np.int64)


@pytest.mark.parametrize("name", ["bunny", "cornell"])
def test_final_seeds_match_jax(name):
    light_j, seed_j = _traced(name, "jit" if name == "bunny" else "op_by_op")
    light_t, seed_t = _traced(name, "port")
    assert (seed_t == seed_j).mean() >= 0.99
    _assert_images_close(light_t.reshape(32, 32, 3), light_j.reshape(32, 32, 3))


def test_cornell_jit_vs_op_by_op():
    """Records ROADMAP C1: the jitted reference's Cornell paths diverge from
    the same code evaluated op by op on many pixels (about 12 % of final
    seeds when this was written); the port matches the op-by-op evaluation
    on every seed."""
    _, seed_jit = _traced("cornell", "jit")
    _, seed_ref = _traced("cornell", "op_by_op")
    _, seed_port = _traced("cornell", "port")
    assert (seed_jit != seed_ref).mean() > 0.05
    assert np.array_equal(seed_port, seed_ref)


def test_config_fields_match_jax():
    import dataclasses
    want = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    assert [(f.name, f.default)
            for f in dataclasses.fields(RenderConfig)] == want
    with pytest.raises(ValueError):
        RenderConfig(ray_block=12)


def test_ray_sort_modes_identical():
    _, _, tscene, tm = _case("bunny")
    imgs = [sweep.render_frame(tscene, tm,
                               RenderConfig(**CFG, ray_sort=mode), FRAME)
            for mode in ("dynamic", "static", "off")]
    for img in imgs[1:]:
        assert torch.equal(img, imgs[0])


def test_render_step_accumulates_running_mean():
    _, _, tscene, tm = _case("cornell")
    cfg = RenderConfig(**CFG)
    f0 = golden.render_frame(tscene, tm, cfg, 0)
    f1 = golden.render_frame(tscene, tm, cfg, 1)
    img = golden.render_step(tscene, tm, cfg, 0, None)
    assert torch.equal(img, f0)
    img = golden.render_step(tscene, tm, cfg, 1, img)
    torch.testing.assert_close(img, 0.5 * f0 + 0.5 * f1)


@pytest.mark.parametrize("option", ["compact", "edge_grads"])
def test_unported_options_raise(option):
    """The two options the port once refused (raising NotImplementedError)
    now render through the sweep path: compaction gives the plain frame bit
    for bit; the silhouette estimator a finite frame of the same mean
    brightness (within 5 %; it blends a background path in at silhouettes
    and at the bumpy mesh's horizon-grazing facet edges)."""
    _, _, tscene, tm = _case("bunny")
    cfg = RenderConfig(**CFG)
    with torch.no_grad():
        plain = sweep.render_frame(tscene, tm, cfg, FRAME)
        got = sweep.render_frame(tscene, tm, cfg.replace(**{option: True}),
                                 FRAME)
    assert got.shape == plain.shape and bool(torch.isfinite(got).all())
    if option == "compact":
        assert torch.equal(got, plain)
    else:
        assert not torch.equal(got, plain)
        assert abs(float(got.mean()) / float(plain.mean()) - 1.0) < 0.05
