"""Port vs JAX package: the silhouette estimator (``RenderConfig.edge_grads``).

The same scenes (built by both packages' SceneBuilders from the same
numbers), rays, seeds and configs go through the JAX functions and their
ports: the miter expansion to an ulp and the neighbor slabs bit for bit,
the widened brute-force query's winners bit for bit and its ``t`` and
coverage to rtol 1e-5 / 1e-4 + 1e-5; the port's cluster-sweep silhouette query (through the
plain twin) against the port's brute query, as
``tests/test_geometry_grads.py::test_tri_edge_sweep_matches_brute`` holds
the JAX package's.  Frames and grads, 24-32 pixels square and at most 2
bounces, are held against the jitted JAX package: under ``jit`` XLA-CPU
contracts multiply-adds into FMAs, which flips a roundoff-decided NEE
shadow or bounce on a few pixels (ROADMAP C1; the port equals the op-by-op
evaluation there).  So at most 1 % of pixels may differ by more than 1e-3,
the rest by a mean of at most 1e-4.  The grads are held in
tests/test_torch_edge_grads.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wc_path_tracer_tpu.kernels import cluster as jcluster
from wc_path_tracer_tpu.ops import rng as jrng
from wc_path_tracer_tpu.render import golden as jgolden
from wc_path_tracer_tpu.scene import camera as jcamera
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.kernels import cluster
from wc_path_tracer_tpu_torch.models import procedural
from wc_path_tracer_tpu_torch.ops import rng
from wc_path_tracer_tpu_torch.render import dispatch, golden, sweep
from wc_path_tracer_tpu_torch.scene import camera
from wc_path_tracer_tpu_torch.scene.types import MATERIAL_LAMBERTIAN

from tests.test_torch_nee import assert_images_close, build_both, scene_case
from tests.test_torch_render import _case as forward_case

torch.set_num_threads(2)

FRAME = 3


def add_silhouettes(b):
    """A dark sphere and a dark quad, overlapping on screen, in front of an
    emissive quad: the image depends on geometry and camera mostly through
    the two classes' silhouettes, and each class is the other's background
    somewhere."""
    dark = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.2, 0.2, 0.2))
    lamp = b.add_material(MATERIAL_LAMBERTIAN, emission=(1.0, 1.0, 1.0),
                          emission_strength=5.0)
    b.add_sphere((0.0, 0.0, -3.0), 1.0, dark)
    occ = np.array([[-1.5, -1, -4], [0.5, -1, -4], [0.5, 1, -4],
                    [-1.5, -1, -4], [0.5, 1, -4], [-1.5, 1, -4]], np.float32)
    b.add_mesh(occ, np.arange(6, dtype=np.int32), tri_material=dark)
    quad = np.array([[-4, -4, -8], [4, -4, -8], [4, 4, -8],
                     [-4, -4, -8], [4, 4, -8], [-4, 4, -8]], np.float32)
    b.add_mesh(quad, np.arange(6, dtype=np.int32), tri_material=lamp)


def both_cases(js, ts, jcam=None, jm=None):
    """(JAX scene, JAX camera, port scene, port camera, JAX matrices, port
    matrices): the port gets the JAX matrices, and a Camera of the same
    position where the JAX side has a Camera (camera grads)."""
    if jcam is not None:
        jm = jcamera.camera_matrices(jcam, 1.0)
    tm = camera.matrices_from_numpy(np.asarray(jm.inverse_projection),
                                    np.asarray(jm.inverse_view),
                                    np.asarray(jm.position), "cpu")
    tcam = None if jcam is None else camera.Camera.create(
        position=tuple(float(x) for x in np.asarray(jcam.position)),
        device="cpu")
    return js, jcam, ts, tcam, jm, tm


@functools.lru_cache(maxsize=None)
def case(name):
    if name == "silhouettes":
        return both_cases(*build_both(add_silhouettes),
                          jcam=jcamera.Camera.create(position=(0.0, 0.0, 1.0)))
    js, jm, ts, _ = (forward_case if name == "bunny" else scene_case)(name)
    return both_cases(js, ts, jm=jm)


def primary(jm, W, H):
    dirs = np.array(jcamera.primary_ray_directions(jm, W, H)).reshape(-1, 3)
    origin = np.broadcast_to(np.asarray(jm.position), dirs.shape).copy()
    pix_ang = np.float32(2.0) * np.asarray(jm.inverse_projection)[1, 1] \
        / np.float32(H)
    return origin, dirs, np.float32(pix_ang)


def test_expand_triangles_and_neighbor_slabs_match_jax():
    """The miter expansion of the bunny-like mesh's padded slots (margins
    as the sweep gives them, dead slots at 0) against the JAX package's, op
    by op (jitted, XLA-CPU contracts the dot products into FMAs), to rtol
    1e-6 plus 1e-7: torch's vectorised CPU sqrt is not correctly rounded
    (1 ulp on ~0.7 % of inputs), which moves an outward normal by an ulp.
    The neighbor slabs (products and sums only) bit for bit."""
    js, _, ts, _, jm, _ = case("bunny")
    a, b, c, _, lv, C = jcluster._padded_tri_coords(js.mesh)
    margin = np.random.default_rng(4).uniform(0.0, 0.05, lv.shape[0]) \
        .astype(np.float32) * np.asarray(lv)
    with jax.disable_jit():
        want = [np.asarray(x) for x in jgolden._expand_triangles(
            a, b, c, jnp.asarray(margin))]
    ta, tb, tc, _, tlv, tC = cluster._padded_tri_coords(ts.mesh)
    assert tC == C and np.array_equal(tlv.numpy(), np.asarray(lv))
    got = golden._expand_triangles(ta, tb, tc, torch.from_numpy(margin))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    assert np.abs(want[0] - np.asarray(a)).max() > 0.0

    with jax.disable_jit():
        jn, jo = (np.asarray(x) for x in jcluster.neighbor_slabs(js.mesh))
    tn, to = cluster.neighbor_slabs(ts.mesh)
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(to.numpy(), jo)
    assert 0.0 < jo.mean() < 1.0


@pytest.mark.parametrize("name", ["bunny", "silhouettes"])
def test_tri_edge_candidate_brute_matches_jax(name):
    """The widened triangle query of 32 x 32 camera rays: winners (found,
    material) bit for bit, plane-park t to rtol 1e-5 and coverage to 1e-4
    relative plus 1e-5 absolute (the JAX package's own tolerance between
    its two backends: alpha divides a signed distance by a pixel footprint,
    so roundoff in the distance is amplified), where both found one."""
    js, _, ts, _, jm, _ = case(name)
    W = H = 32
    origin, dirs, pix_ang = primary(jm, W, H)
    jc = jax.jit(jgolden.tri_edge_candidate_brute, static_argnames="cfg")(
        js, origin, dirs, JConfig(width=W, height=H, edge_grads=True),
        pix_ang)
    tc = golden.tri_edge_candidate_brute(
        ts, torch.from_numpy(origin), torch.from_numpy(dirs),
        RenderConfig(width=W, height=H, edge_grads=True),
        torch.tensor(pix_ang))
    found = np.asarray(jc["found"])
    np.testing.assert_array_equal(tc["found"].numpy(), found)
    np.testing.assert_array_equal(tc["material"].numpy()[found],
                                  np.asarray(jc["material"])[found])
    np.testing.assert_allclose(tc["t_w"].detach().numpy()[found],
                               np.asarray(jc["t_w"])[found], rtol=1e-5)
    np.testing.assert_allclose(tc["alpha"].detach().numpy()[found],
                               np.asarray(jc["alpha"])[found], rtol=1e-4,
                               atol=1e-5)
    partial = (np.asarray(jc["alpha"]) < 1.0) & found
    assert found.mean() > 0.1 and partial.sum() > 0


@pytest.mark.parametrize("subdiv,kw", [
    (2, {}), (2, dict(ray_sort="static")), (2, dict(ray_sort="off")),
    (2, dict(cluster_kernel="mxu")), (3, {})],
    ids=["dynamic", "static", "off", "mxu", "dead-cluster"])
def test_tri_edge_sweep_matches_brute(subdiv, kw):
    """The cluster-sweep silhouette query (plain twin on the CPU) agrees
    with the brute query on the bunny-like mesh: same winners, t to rtol
    1e-5, coverage to 1e-4 relative plus 1e-5 absolute, same materials, as
    the JAX package holds its own.  ``bunny_like_scene(3)`` has a cluster
    of dead slots only, which the expansion keeps at zero margin and the
    cull drops.  Under ``cluster_kernel="mxu"`` the query still sweeps
    Möller-Trumbore tables through B1's twin, and a block sweep given as
    B2's twin maps to B1's."""
    ts, cam = procedural.bunny_like_scene(subdiv, device="cpu")
    mats = camera.camera_matrices(cam, 1.0)
    W = H = 24
    dirs = camera.primary_ray_directions(mats, W, H).reshape(-1, 3)
    args = (ts, mats.position.expand_as(dirs), dirs,
            RenderConfig(width=W, height=H, edge_grads=True, **kw),
            2.0 * mats.inverse_projection[1, 1] / H)
    cb = golden.tri_edge_candidate_brute(*args)
    seen = []

    def twin(*a):
        seen.append(len(a))
        return cluster.cluster_sweep_plain(*a)

    cs = sweep.tri_edge_candidate_sweep(*args, block_fn=twin)
    f = cb["found"].numpy()
    np.testing.assert_array_equal(cs["found"].numpy(), f)
    np.testing.assert_allclose(cs["t_w"].detach().numpy()[f],
                               cb["t_w"].detach().numpy()[f], rtol=1e-5)
    np.testing.assert_allclose(cs["alpha"].detach().numpy()[f],
                               cb["alpha"].detach().numpy()[f], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(cs["material"].numpy()[f],
                                  cb["material"].numpy()[f])
    assert seen == [6] and f.mean() > 0.1
    if kw.get("cluster_kernel") == "mxu":
        fn = sweep.make_intersect_fn(ts, args[3],
                                     block_fn=cluster.cluster_sweep_mxu_plain)
        ce = fn.edge_tri_fn(*args)
        np.testing.assert_array_equal(ce["t_w"].detach().numpy(),
                                      cs["t_w"].detach().numpy())


def test_background_seed_wraps_like_uint32():
    """The background path's seed is pixel_seed(pixel, frame + 747796405)
    with the JAX package's uint32 wrap, also where the sum passes 2^32."""
    idx = np.arange(1024, dtype=np.uint32)
    for frame in (3, 4_000_000_000):
        bg_frame = np.uint32((frame + 747796405) % 2**32)
        want = np.asarray(jrng.pixel_seed(idx, bg_frame))
        got = rng.pixel_seed(torch.from_numpy(idx.astype(np.int64)),
                             frame + 747796405)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


FRAMES = [("silhouettes", "golden", {}), ("silhouettes", "golden",
                                         dict(use_nee=True)),
          ("bunny", "sweep", {}), ("bunny", "pallas", {}),
          ("lit_bunny", "sweep", dict(use_nee=True)),
          ("default", "golden", dict(use_nee=True, samples=2))]


@pytest.mark.parametrize("name,renderer,kw", FRAMES,
                         ids=["-".join([n, r] + sorted(k)) for n, r, k in
                              FRAMES])
def test_edge_frames_match_jax(name, renderer, kw):
    """One 24 x 24 ``edge_grads`` frame, 2 bounces, of each case against
    the JAX package's brute-force frame (its sweep gives the brute hits),
    through the port's brute force, the cluster sweep (twin) and the BVH
    walk, with NEE where named (its sphere shadows soft)."""
    js, _, ts, _, jm, tm = case(name)
    kw = dict(dict(width=24, height=24, samples=1, max_bounces=2,
                   edge_grads=True), **kw)
    want = np.asarray(jax.jit(jgolden.render_frame, static_argnames="cfg")(
        js, jm, JConfig(**kw), FRAME))
    cfg = RenderConfig(**kw)
    with torch.no_grad():
        got = golden.render_frame(ts, tm, cfg, FRAME,
                                  dispatch.get_intersect_fn(renderer, ts,
                                                            cfg)).numpy()
    assert_images_close(got, want)
    assert got.max() > 0.0
