"""Port vs JAX package: the progressive ``Renderer`` and its checkpoints.

32 x 32 pixels, 2 bounces, ``default_scene``.  Three progressive steps
agree with the JAX ``Renderer``'s to atol 1e-5 on at least 99 % of pixels
(the JAX steps are jitted, and XLA-CPU's FMA contraction can flip a
roundoff-decided path, ROADMAP C1).  Every edit leaves the scene tensors
bit for bit equal to the JAX renderer's after the same edit, and resets the
frame counter; ``output()`` (bloom, tonemap, gamma, uint8) is within 1 LSB
of the JAX package's on the same HDR image; dispatch "auto" is resolved
from the current scene on every step; a renderer checkpoint round-trips,
and one the JAX package wrote resumes in the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wc_path_tracer_tpu.models import builtin as jbuiltin
from wc_path_tracer_tpu.models import procedural as jproc
from wc_path_tracer_tpu.render.renderer import Renderer as JRenderer
from wc_path_tracer_tpu.utils import checkpoint as jcheckpoint
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.models.procedural import bunny_like_scene
from wc_path_tracer_tpu_torch.render import dispatch, golden
from wc_path_tracer_tpu_torch.render.renderer import Renderer
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices
from wc_path_tracer_tpu_torch.utils.checkpoint import (load_renderer,
                                                       save_renderer)

torch.set_num_threads(2)

CFG = dict(width=32, height=32, samples=1, max_bounces=2, sky="gradient")


def _agree(a, b):
    """Share of pixels whose channels agree to 1e-5."""
    return float(np.mean(np.all(np.abs(np.asarray(a) - np.asarray(b))
                                <= 1e-5, axis=-1)))


def _same_scene(r, jr):
    for part in ("materials", "spheres", "mesh"):
        ours, theirs = getattr(r.scene, part), getattr(jr.scene, part)
        for f in dataclasses.fields(ours):
            v = getattr(ours, f.name)
            if isinstance(v, torch.Tensor):
                w = np.asarray(getattr(theirs, f.name))
                assert v.numpy().dtype == w.dtype, (part, f.name)
                np.testing.assert_array_equal(v.numpy(), w,
                                              err_msg=f"{part}.{f.name}")
    for f in ("position", "yaw", "pitch", "fov"):
        np.testing.assert_array_equal(getattr(r.camera, f).numpy(),
                                      np.asarray(getattr(jr.camera, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def stepped():
    """(port Renderer, JAX Renderer), 3 progressive steps each."""
    jr = JRenderer(jbuiltin.default_scene(), jbuiltin.default_camera(),
                   JConfig(**CFG))
    jr.step(3)
    r = Renderer(builtin.default_scene(device="cpu"),
                 builtin.default_camera(device="cpu"), RenderConfig(**CFG),
                 device="cpu")
    r.step(3)
    return r, jr


def test_steps_match_jax(stepped):
    r, jr = stepped
    assert r.frame_count == jr.frame_count == 3
    agree = _agree(r.image, jr.image)
    assert agree >= 0.99, agree


def test_step_equals_render_step_chain():
    scene, cam = builtin.default_scene(device="cpu"), \
        builtin.default_camera(device="cpu")
    cfg = RenderConfig(**CFG)
    r = Renderer(scene, cam, cfg, device="cpu")
    r.step(2)
    mats = camera_matrices(cam, 1.0)
    want = golden.render_step(scene, mats, cfg, 1, golden.render_step(
        scene, mats, cfg, 0, None))
    assert torch.equal(r.image, want)


def test_edits_match_jax_and_reset():
    r = Renderer(builtin.default_scene(device="cpu"),
                 builtin.default_camera(device="cpu"), RenderConfig(**CFG),
                 device="cpu")
    jr = JRenderer(jbuiltin.default_scene(), jbuiltin.default_camera(),
                   JConfig(**CFG))
    n0, cap = int(jr.scene.spheres.count), jr.scene.spheres.capacity
    edits = [
        ("set_camera", (), dict(position=(0.1, 0.2, 0.3), yaw=-80.0)),
        ("update_material", (1,), dict(albedo=(1.0, 0.0, 0.0),
                                       roughness=0.3, mtype=2)),
        ("update_sphere", (0,), dict(position=(0.0, 0.1, -1.2), radius=0.4)),
        *[("add_sphere", ((0.2 * i, 1.0, -1.0), 0.25, 1), {})
          for i in range(cap - n0 + 1)],          # through the doubling
        ("remove_sphere", (2,), {}),
        ("set_samples", (2,), {}),
        ("set_max_bounces", (1,), {}),
    ]
    for name, args, kw in edits:
        r.frame_count = jr.frame_count = 5
        assert getattr(r, name)(*args, **kw) == getattr(jr, name)(*args, **kw)
        assert r.frame_count == jr.frame_count == 0, name
        assert r.cfg == RenderConfig(**dataclasses.asdict(jr.cfg))
        _same_scene(r, jr)
    assert r.scene.spheres.capacity == 2 * cap
    with pytest.raises(IndexError):
        r.remove_sphere(int(r.scene.spheres.count))
    r.resize(24, 16)
    assert r.image.shape == (16, 24, 3) and r.frame_count == 0

    # remove_mesh: bunny_like_scene(2) split into draws of <= 64 triangles
    # (8 draws)
    r = Renderer(*bunny_like_scene(2, max_blas_tris=64, device="cpu"),
                 RenderConfig(**CFG), device="cpu")
    jr = JRenderer(*jproc.bunny_like_scene(2, max_blas_tris=64),
                   JConfig(**CFG))
    for index in (3, 0, 5):
        r.frame_count = 4
        r.remove_mesh(index)
        jr.remove_mesh(index)
        assert r.frame_count == 0
        _same_scene(r, jr)
    with pytest.raises(IndexError):
        r.remove_mesh(int(r.scene.mesh.draw_count))
    r.step()       # the shifted draw tables still render
    assert torch.isfinite(r.image).all()


def test_output_within_one_lsb_of_jax(stepped):
    r, jr = stepped
    post = dict(bloom=True, bloom_threshold=0.8, bloom_strength=0.7,
                tonemap="aces", gamma=2.2)
    img = torch.from_numpy(np.asarray(jr.image).copy())
    ours = Renderer(r.scene, r.camera, r.cfg.replace(**post), device="cpu")
    ours.image = img
    theirs = JRenderer(jr.scene, jr.camera, jr.cfg.replace(**post))
    theirs.image = jr.image
    for kw in ({}, dict(tonemap="pbr_neutral", gamma=1.0)):
        a, b = ours.output(**kw), np.asarray(theirs.output(**kw))
        assert a.dtype == np.uint8 and a.shape == (32, 32, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, kw
    with pytest.raises(ValueError, match="unknown tonemap"):
        ours.output(tonemap="nope")


@pytest.mark.parametrize("scene_fn, backend", [
    (lambda: bunny_like_scene(2, device="cpu"), "sweep"),
    (lambda: builtin.cornell_box_scene(device="cpu"), "golden")],
    ids=["bunny_like-sweep", "cornell-golden"])
def test_auto_dispatch_per_step(scene_fn, backend, monkeypatch):
    """No render_fn: every step resolves "auto" from the current scene
    (above 256 triangle slots the cluster sweep, else brute force), and the
    image is the brute-force frame's to 1e-5."""
    calls = []
    for name in ("golden", "sweep"):
        real = dispatch._BACKENDS[name]
        monkeypatch.setitem(
            dispatch._BACKENDS, name,
            lambda s, c, real=real, name=name: calls.append(name) or
            real(s, c))
    scene, cam = scene_fn()
    cfg = RenderConfig(width=24, height=24, samples=1, max_bounces=2,
                       sky="gradient")
    r = Renderer(scene, cam, cfg, device="cpu")
    img = r.step(2)
    assert calls == [backend, backend]
    mats = camera_matrices(cam, 1.0)
    want = golden.accumulate(golden.render_frame(scene, mats, cfg, 0),
                             golden.render_frame(scene, mats, cfg, 1), 1)
    assert _agree(img, want) == 1.0


def test_checkpoint_round_trip(tmp_path):
    cfg = RenderConfig(**CFG)
    r = Renderer(builtin.default_scene(device="cpu"),
                 builtin.default_camera(device="cpu"), cfg, device="cpu")
    r.step(2)
    r.add_sphere((0.0, 1.0, -1.0), 0.3, 2)
    r.step(1)
    save_renderer(str(tmp_path / "ck"), r)
    r2 = Renderer(builtin.default_scene(device="cpu"),
                  builtin.default_camera(device="cpu"), RenderConfig(),
                  device="cpu")
    load_renderer(str(tmp_path / "ck"), r2)
    assert r2.frame_count == 1 and r2.cfg == cfg
    assert torch.equal(r2.image, r.image)
    assert r2.scene.mesh.max_leaf_tris == r.scene.mesh.max_leaf_tris
    assert torch.equal(r2.scene.spheres.position, r.scene.spheres.position)
    assert torch.equal(r2.step(1), r.step(1))


def test_jax_renderer_checkpoint_resumes(stepped, tmp_path):
    _, jr = stepped
    jcheckpoint.save_renderer(str(tmp_path / "jck"), jr)
    r = Renderer(builtin.default_scene(device="cpu"),
                 builtin.default_camera(device="cpu"), RenderConfig(),
                 device="cpu")
    load_renderer(str(tmp_path / "jck"), r)
    assert r.frame_count == 3
    assert r.cfg == RenderConfig(**dataclasses.asdict(jr.cfg))
    np.testing.assert_array_equal(r.image.numpy(), np.asarray(jr.image))
    _same_scene(r, jr)
    agree = _agree(r.step(1), jr.step(1))
    assert r.frame_count == jr.frame_count == 4 and agree >= 0.99, agree


def test_profiling_stages_and_timer(tmp_path):
    """``Renderer.step`` and ``output`` run inside named stages that a
    ``profile_trace`` Chrome trace records."""
    from wc_path_tracer_tpu_torch.utils import profiling
    r = Renderer(builtin.default_scene(device="cpu"),
                 builtin.default_camera(device="cpu"),
                 RenderConfig(width=8, height=8, max_bounces=1),
                 device="cpu")
    path = str(tmp_path / "trace.json")
    with profiling.profile_trace(path, r.device):
        for _ in range(3):
            r.step(1)
        r.output()
    trace = open(path).read()
    assert '"render_step"' in trace and '"post"' in trace
