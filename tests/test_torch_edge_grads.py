"""Port vs JAX package and finite differences: the gradients of the
silhouette estimator (``RenderConfig.edge_grads``).

Grads of mean((img - target)^2) with respect to sphere positions and radii,
the camera position and mesh vertices are held against
``jax.value_and_grad`` of the same loss (32 x 32, 1 bounce; pixels that a
roundoff-decided path places more than 1e-3 apart, at most 1 %, are left out
on both sides, ROADMAP C1) to 1e-4 of each leaf's largest |g|.  The JAX
package's own oracles run on the port as they run there
(``tests/test_geometry_grads.py``): with ``edge_grads`` the primal is
continuous in geometry and camera, so loss-level central differences must
match autodiff for a sphere's and a quad's silhouette and for a sphere that
reaches the image only through its NEE shadow; and the bounce-0 shadow
query must go to the backend's any-hit, not to the precomputed primary
record (which darkened NEE frames about 4x).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wc_path_tracer_tpu.optim import params as jreg
from wc_path_tracer_tpu.render import golden as jgolden
from wc_path_tracer_tpu.scene import camera as jcamera
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.parallel import render as prender
from wc_path_tracer_tpu_torch.render import dispatch, golden
from wc_path_tracer_tpu_torch.scene.camera import Camera, camera_matrices
from wc_path_tracer_tpu_torch.scene.types import (MATERIAL_LAMBERTIAN,
                                                  SceneBuilder)

from tests.test_torch_edge import case

torch.set_num_threads(2)

GEOMETRY = ("sphere_position", "sphere_radius", "camera_position", "vertices")


def grads_vs_jax(scenes, renderer, trainable, kw):
    """(port grads, JAX grads) of mean((img - target)^2) for ``scenes``
    (``tests.test_torch_edge.both_cases``), target half the
    JAX image.  Pixels the two packages place more than 1e-3 apart (at most
    1 %) get their own image as target on each side, so they leave the
    loss.  The JAX image is the primal of the very program that takes the
    grads (its ``aux``; the target is an argument, so both calls run one
    compiled program): XLA fuses a jitted loss differently from a jitted
    frame, and flips other roundoff-decided pixels."""
    js, jcam, ts, tcam, jm, tm = scenes
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)

    def loss(params, target):
        s, c = jreg.apply_params(js, jcam, params)
        m = jm if c is None else jcamera.camera_matrices(c, 1.0)
        img = jgolden.render_frame(s, m, jcfg, 0)
        return jnp.mean((img - target) ** 2), img

    run = jax.jit(jax.value_and_grad(loss, has_aux=True))
    params = jreg.get_params(js, jcam, trainable)
    jimg = np.asarray(run(params, np.zeros((kw["height"], kw["width"], 3),
                                           np.float32))[0][1])
    with torch.no_grad():
        timg = golden.render_frame(ts, tm, cfg, 0, dispatch.get_intersect_fn(
            renderer, ts, cfg)).numpy()
    flipped = np.abs(timg - jimg).max(axis=-1, keepdims=True) > 1e-3
    assert flipped.mean() <= 0.01, flipped.mean()
    jt = np.where(flipped, jimg, 0.5 * jimg).astype(np.float32)
    tt = np.where(flipped, timg, 0.5 * jimg).astype(np.float32)
    (jl, _), jg = run(params, jt)
    tl, tg = prender.scene_loss_grad(cfg, trainable, renderer)(
        ts, tcam if tcam is not None else tm, 0, torch.from_numpy(tt))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    return {k: g.numpy() for k, g in tg.items()}, \
        {k: np.asarray(g) for k, g in jg.items()}


GRADS = [("silhouettes", "golden", GEOMETRY, {}),
         ("silhouettes", "sweep", GEOMETRY, dict(use_nee=True)),
         ("bunny", "sweep", ("vertices", "sphere_radius"), {})]


@pytest.mark.parametrize("name,renderer,trainable,kw", GRADS,
                         ids=["-".join([n, r] + sorted(k)) for n, r, _, k in
                              GRADS])
def test_edge_grads_match_jax(name, renderer, trainable, kw):
    """Geometry and camera grads under ``edge_grads`` against
    ``jax.value_and_grad`` of the same loss, 32 x 32, 1 bounce (the
    silhouettes are primary visibility), to 1e-4 of each leaf's largest
    |g|; the bunny-like mesh through the sweep under its gradient sky."""
    kw = dict(dict(width=32, height=32, samples=1, max_bounces=1,
                   sky="gradient" if name == "bunny" else "black",
                   edge_grads=True), **kw)
    got, want = grads_vs_jax(case(name), renderer, trainable, kw)
    for k in trainable:
        scale = float(np.abs(want[k]).max())
        assert scale > 0.0 and np.all(np.isfinite(got[k])), k
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= 1e-4, (k, err)


def quad(x0, x1, y0, y1, z):
    return np.array([[x0, y0, z], [x1, y0, z], [x1, y1, z],
                     [x0, y0, z], [x1, y1, z], [x0, y1, z]], np.float32)


def fd_matches_autodiff(scene, cam, cfg, trainable, eps, rtol, seed, min_fd):
    """tests/test_geometry_grads.py's boundary-term check on the port:
    autodiff of mean((img - img0 / 2)^2) projected on a seeded random
    direction against the loss's central difference, with no interior
    masking (the boundary term is the signal)."""
    mats = camera_matrices(cam, 1.0)
    with torch.no_grad():
        target = golden.render_frame(scene, mats, cfg, 0) * 0.5
    _, g = prender.scene_loss_grad(cfg, trainable)(scene, cam, 0, target)
    params = reg.get_params(scene, cam, trainable)
    rng = np.random.default_rng(seed)
    direction = {k: torch.from_numpy(rng.normal(size=tuple(v.shape))
                                     .astype(np.float32))
                 for k, v in params.items()}
    ad = sum(float(torch.sum(g[k] * direction[k])) for k in params)

    def loss(sign):
        s, c = reg.apply_params(scene, cam, {
            k: v + sign * eps * direction[k] for k, v in params.items()})
        with torch.no_grad():
            img = golden.render_frame(s, camera_matrices(c, 1.0), cfg, 0)
        return float(torch.mean((img - target) ** 2))

    fd = (loss(+1) - loss(-1)) / (2 * eps)
    assert np.isfinite(ad) and np.isfinite(fd)
    assert abs(fd) > min_fd          # the boundary term dominates by design
    assert abs(ad - fd) <= rtol * abs(fd), (ad, fd)


SILHOUETTE = dict(width=32, height=32, samples=1, max_bounces=1, sky="black",
                  edge_grads=True)


@pytest.mark.parametrize("trainable,eps,rtol", [
    (("sphere_position",), 1e-3, 0.10),
    (("sphere_radius",), 1e-3, 0.05),
    (("camera_position",), 1e-3, 0.10),
])
def test_silhouette_boundary_term_matches_fd(trainable, eps, rtol):
    """A dark sphere silhouetted against an emissive quad behind it
    (test_geometry_grads.py:143-191): the loss depends on the geometry
    almost only through the silhouette."""
    b = SceneBuilder()
    m = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.2, 0.2, 0.2))
    lm = b.add_material(MATERIAL_LAMBERTIAN, emission=(1.0, 1.0, 1.0),
                        emission_strength=5.0)
    b.add_sphere((0.0, 0.0, -3.0), 1.0, m)
    b.add_mesh(quad(-4, 4, -4, 4, -8), np.arange(6, dtype=np.int32),
               tri_material=lm)
    cam = Camera.create(position=(0.0, 0.0, 1.0), device="cpu")
    fd_matches_autodiff(b.build("cpu"), cam, RenderConfig(**SILHOUETTE),
                        trainable, eps, rtol, 0, 1e-5)


def test_mesh_silhouette_boundary_term_matches_fd():
    """A dark quad occluding an emissive quad behind it
    (test_geometry_grads.py:253-298): the triangle coverage makes the
    primal continuous in the vertex positions."""
    b = SceneBuilder()
    m = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.2, 0.2, 0.2))
    lm = b.add_material(MATERIAL_LAMBERTIAN, emission=(1.0, 1.0, 1.0),
                        emission_strength=5.0)
    b.add_mesh(quad(-1, 1, -1, 1, -3), np.arange(6, dtype=np.int32),
               tri_material=m)
    b.add_mesh(quad(-4, 4, -4, 4, -8), np.arange(6, dtype=np.int32),
               tri_material=lm)
    cam = Camera.create(position=(0.0, 0.0, 1.0), device="cpu")
    fd_matches_autodiff(b.build("cpu"), cam, RenderConfig(**SILHOUETTE),
                        ("vertices",), 1e-3, 0.10, 0, 1e-5)


def lit_floor(b, occluder_y, occluder_r, occ_albedo):
    """A floor quad at y = 0 under an emissive quad at y = 4, with a sphere
    between them (test_geometry_grads.py:384-475)."""
    floor = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.7, 0.7, 0.7))
    lm = b.add_material(MATERIAL_LAMBERTIAN, emission=(1.0, 1.0, 1.0),
                        emission_strength=8.0)
    occ = b.add_material(MATERIAL_LAMBERTIAN, albedo=occ_albedo)
    fl = np.array([[-3, 0, -7], [3, 0, -7], [3, 0, -1],
                   [-3, 0, -7], [3, 0, -1], [-3, 0, -1]], np.float32)
    b.add_mesh(fl, np.arange(6, dtype=np.int32), tri_material=floor)
    lq = np.array([[-1, 4, -5], [1, 4, -5], [1, 4, -3],
                   [-1, 4, -5], [1, 4, -3], [-1, 4, -3]], np.float32)
    b.add_mesh(lq, np.arange(6, dtype=np.int32), tri_material=lm)
    b.add_sphere((0.0, occluder_y, -4.0), occluder_r, occ)


def test_shadow_silhouette_grads_match_fd():
    """An occluder out of view reaches the image only through its NEE
    shadow; one segment (max_bounces 0) keeps the light transport the NEE
    term alone, so its position gradient is the soft shadow's."""
    b = SceneBuilder()
    lit_floor(b, 2.0, 0.6, (0.1, 0.1, 0.1))
    cam = Camera.create(position=(0.0, 1.5, 0.5), pitch=-35.0, device="cpu")
    cfg = RenderConfig(width=32, height=32, samples=1, max_bounces=0,
                       sky="black", use_nee=True, edge_grads=True)
    fd_matches_autodiff(b.build("cpu"), cam, cfg, ("sphere_position",),
                        2e-3, 0.15, 1, 1e-6)


@pytest.mark.parametrize("renderer", ["golden", "sweep", "pallas"])
def test_edge_grads_nee_primal_consistent(renderer):
    """The bounce-0 shadow regression: under ``edge_grads`` the NEE frame
    must keep the hard estimator's brightness (6 frames averaged, within
    12 %); a bounce-0 shadow query answered by the primary record itself
    shadows every surface nearer than its light sample, about 4x darker.
    On every backend: brute force, the sweep (its occlusion_fn) and the
    BVH walk (no occlusion_fn: occluded_brute)."""
    b = SceneBuilder()
    lit_floor(b, 1.2, 0.5, (0.2, 0.2, 0.6))
    scene = b.build("cpu")
    mats = camera_matrices(Camera.create(position=(0.0, 2.0, 0.0),
                                         pitch=-30.0, device="cpu"), 1.0)
    cfg = RenderConfig(width=48, height=48, samples=1, max_bounces=1,
                       sky="black", use_nee=True)

    def avg(c):
        fn = dispatch.get_intersect_fn(renderer, scene, c)
        with torch.no_grad():
            return float(sum(golden.render_frame(scene, mats, c, f, fn)
                             for f in range(6)).mean() / 6)

    hard = avg(cfg)
    soft = avg(cfg.replace(edge_grads=True))
    assert hard > 0.02
    assert abs(soft - hard) < 0.12 * hard, (hard, soft)
