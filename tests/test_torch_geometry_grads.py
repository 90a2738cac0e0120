"""Geometry and camera gradients of the port's hard-visibility estimator
(the JAX package's oracles of ``tests/test_geometry_grads.py`` and
``tests/test_sweep.py``, run on the port).

- Interior finite differences: for each of the six geometry and camera
  trainables, autodiff projected on a seeded random direction against
  image-level central differences contracted with the exact dL/dimg,
  leaving out pixels whose hit state flips under the perturbation (the
  silhouette term this estimator does not model), to the JAX package's
  tolerances (rtol 0.12-0.15).
- The cluster sweep's vertex grads against central differences of the loss
  on a silhouette-free view (rtol 0.05), and ray-origin grads flowing
  through its re-shade.
- Sphere position and radius grads against ``jax.value_and_grad`` of the
  same loss, to 1e-4 of each leaf's largest |g| (pixels a roundoff-decided
  path places more than 1e-3 apart, at most 1 %, left out on both sides).
"""

import numpy as np
import pytest
import torch

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.render import golden, sweep
from wc_path_tracer_tpu_torch.scene.camera import Camera, camera_matrices
from wc_path_tracer_tpu_torch.scene.types import (MATERIAL_LAMBERTIAN,
                                                  SceneBuilder)

from wc_path_tracer_tpu.scene import camera as jcamera

from tests.test_torch_edge import both_cases, case
from tests.test_torch_edge_grads import grads_vs_jax
from tests.test_torch_nee import build_both

torch.set_num_threads(2)


def add_simple(b):
    """One Lambertian sphere head-on and one emissive quad overhead
    (test_geometry_grads.py::_simple_scene)."""
    m = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.6, 0.4, 0.3))
    lm = b.add_material(MATERIAL_LAMBERTIAN, emission=(1.0, 1.0, 1.0),
                        emission_strength=3.0)
    b.add_sphere((0.0, 0.0, -3.0), 1.0, m)
    quad = np.array([[-2, 3, -5], [2, 3, -5], [2, 3, -1],
                     [-2, 3, -5], [2, 3, -1], [-2, 3, -1]], np.float32)
    b.add_mesh(quad, np.arange(6, dtype=np.int32), tri_material=lm)


# NEE on: without it a Lambertian scene depends on geometry only through
# detached hit/miss events; NEE's geometric term is the interior path
CFG = RenderConfig(width=24, height=24, samples=1, max_bounces=2,
                   sky="black", use_nee=True)


def render(scene, cam, cfg, renderer=golden.render_frame):
    return renderer(scene, camera_matrices(cam, 1.0), cfg, 0)


@pytest.mark.parametrize("trainable,eps,rtol", [
    (("sphere_position",), 3e-3, 0.12),
    (("sphere_radius",), 3e-3, 0.12),
    (("vertices",), 1e-3, 0.15),
    (("camera_position",), 3e-3, 0.12),
    (("camera_yaw",), 1e-2, 0.15),
    (("camera_fov",), 1e-2, 0.15),
])
def test_geometry_grads_match_finite_differences(trainable, eps, rtol):
    """Autodiff vs image-level central differences on a random direction,
    interior pixels only (|dimg| * 2 eps < 0.05)."""
    b = SceneBuilder()
    add_simple(b)
    scene = b.build("cpu")
    cam = Camera.create(position=(0.0, 0.0, 1.0), device="cpu")
    with torch.no_grad():
        target = render(scene, cam, CFG) * 0.5
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in reg.get_params(scene, cam, trainable).items()}
    s, c = reg.apply_params(scene, cam, params)
    img0 = render(s, c, CFG)
    loss = torch.mean((img0 - target) ** 2)
    g = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    rng = np.random.default_rng(0)
    direction = {k: torch.from_numpy(rng.normal(size=tuple(v.shape))
                                     .astype(np.float32))
                 for k, v in params.items()}
    ad = sum(float(torch.sum(g[k] * direction[k])) for k in params)

    def shifted(sign):
        s, c = reg.apply_params(scene, cam, {
            k: v.detach() + sign * eps * direction[k]
            for k, v in params.items()})
        with torch.no_grad():
            return render(s, c, CFG)

    img0 = img0.detach()
    dldi = 2.0 * (img0 - target) / img0.numel()
    dimg = (shifted(+1) - shifted(-1)) / (2 * eps)
    interior = torch.abs(dimg) * (2 * eps) < 0.05
    fd = float(torch.sum(torch.where(interior, dldi * dimg, 0.0)))
    assert np.isfinite(ad) and np.isfinite(fd)
    assert abs(ad - fd) <= rtol * max(abs(fd), 1e-7), (ad, fd)


def plane_scene(n=8, z=-2.0, half=4.0):
    """An (n x n)-subdivided Lambertian plane filling a 60-degree view,
    with a camera off the grid's axes (test_sweep.py::_plane_scene): no
    silhouette, so interior autodiff is the whole derivative."""
    b = SceneBuilder()
    mat = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.6, 0.5, 0.4))
    xs = np.linspace(-half, half, n + 1, dtype=np.float32)
    v = np.array([[x, y, z] for y in xs for x in xs], np.float32)
    idx = []
    for r in range(n):
        for c in range(n):
            v00 = r * (n + 1) + c
            idx += [v00, v00 + 1, v00 + n + 1,
                    v00 + 1, v00 + n + 2, v00 + n + 1]
    b.add_mesh(v, np.array(idx, np.int32), tri_material=mat)
    cam = Camera.create(position=(0.0137, -0.0071, 0.5), yaw=-89.3,
                        pitch=0.6, fov=60.0, device="cpu")
    return b.build("cpu"), cam


def test_sweep_vertex_grads_match_fd_interior():
    """Vertex grads through the cluster sweep's attached re-shade (the
    plain twin on the CPU) against the loss's central difference on a
    random direction, rtol 0.05 (test_sweep.py:275)."""
    scene, cam = plane_scene(8)
    cfg = RenderConfig(width=24, height=24, samples=1, max_bounces=2,
                       sky="gradient")
    with torch.no_grad():
        target = render(scene, cam, cfg) * 0.5

    def loss(v):
        s, _ = reg.apply_params(scene, cam, {"vertices": v})
        return torch.mean((render(s, cam, cfg, sweep.render_frame)
                           - target) ** 2)

    v0 = scene.mesh.vertices.detach().clone().requires_grad_(True)
    g, = torch.autograd.grad(loss(v0), v0)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0
    dv = torch.from_numpy(np.random.default_rng(0).normal(
        size=tuple(v0.shape)).astype(np.float32))
    eps = 1e-3
    ad = float(torch.sum(g * dv))
    with torch.no_grad():
        fd = float((loss(v0 + eps * dv) - loss(v0 - eps * dv)) / (2 * eps))
    assert abs(ad - fd) <= 0.05 * max(abs(fd), 1e-6), (ad, fd)


def test_sweep_camera_grads_flow():
    """Ray-origin grads flow through the sweep's re-shade
    (test_sweep.py:121): finite and not all zero."""
    _, _, ts, _, _, _ = case("bunny")
    r = np.random.default_rng(11)
    o = r.normal(size=(64, 3)).astype(np.float32)
    d = r.normal(size=(64, 3)).astype(np.float32)
    d[:, 2] -= 0.8
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.from_numpy(o).requires_grad_(True)
    rec = sweep.intersect_scene_sweep(ts, o, torch.from_numpy(d),
                                      RenderConfig(width=8, height=8))
    g, = torch.autograd.grad(torch.sum(torch.where(rec.hit, rec.t, 0.0)), o)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0


def test_sphere_grads_match_jax():
    """Sphere position and radius grads of the hard-visibility estimator
    on the sphere lit from above (NEE on, 24 x 24, 2 bounces) against
    ``jax.value_and_grad``: they flow through the sphere re-shade into the
    NEE geometric term."""
    trainable = ("sphere_position", "sphere_radius")
    scenes = both_cases(*build_both(add_simple), jcam=jcamera.Camera.create(
        position=(0.0, 0.0, 1.0)))
    got, want = grads_vs_jax(scenes, "golden", trainable, dict(
        width=24, height=24, samples=1, max_bounces=2, sky="black",
        use_nee=True))
    for k in trainable:
        scale = float(np.abs(want[k]).max())
        assert scale > 0.0 and np.all(np.isfinite(got[k])), k
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= 1e-4, (k, err)
