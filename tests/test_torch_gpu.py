"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``; each test skips (from inside the test) when no CUDA card is
present.  This file imports no JAX, so on a machine without JAX it runs
without the repository's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_gpu.py
"""

import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.kernels import (brute, cluster, launches,
                                              post, shade, traversal)
from wc_path_tracer_tpu_torch.models import builtin
from wc_path_tracer_tpu_torch.models.procedural import (bumpy_sphere,
                                                         bunny_gltf_scene,
                                                         bunny_like_scene,
                                                         signed_zero_query,
                                                         tie_heavy_query)
from wc_path_tracer_tpu_torch.parallel import render as prender
from wc_path_tracer_tpu_torch.render import golden, sweep, wavefront
from wc_path_tracer_tpu_torch.scene.camera import (camera_matrices,
                                                   primary_ray_directions)
from wc_path_tracer_tpu_torch.ops import rng
from wc_path_tracer_tpu_torch.render.renderer import Renderer
from wc_path_tracer_tpu_torch.scene.types import (MATERIAL_DIELECTRIC,
                                                  MATERIAL_GGX,
                                                  MATERIAL_LAMBERTIAN,
                                                  MATERIAL_METAL,
                                                  SceneBuilder)
from wc_path_tracer_tpu_torch.utils import profiling
from test_torch_brute import CASES as BRUTE_CASES
from test_torch_brute import _case as brute_case
from cull_cases import CULL_CASES, cull_case


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rays(n, seed, device):
    r = np.random.default_rng(seed)
    dirn = r.normal(size=(n, 3))
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    o = np.array([0.0, 1.0, 0.0]) + 3.0 * dirn
    d = np.array([0.0, 1.0, 0.0]) + 0.6 * r.normal(size=(n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.full(n, cluster.KINF)
    some = r.random(n) < 0.25
    t0[some] = r.uniform(1.5, 3.5, some.sum())
    return (torch.tensor(x, dtype=torch.float32, device=device)
            for x in (o, d, t0))


def _sweep_both(o, d, t0, tables, ray_block):
    """One cluster_sweep whose block sweep runs the kernel and its twin on
    the same inputs -> (kernel, twin, kernel visits, twin visits).  Tables
    of 4 (``build_cluster_tables_mxu``) select the plane-form kernel."""
    mxu = len(tables) == 4
    kernel, plain = ((cluster.cluster_sweep_mxu_kernel,
                      cluster.cluster_sweep_mxu_plain) if mxu else
                     (cluster.cluster_sweep_kernel, cluster.cluster_sweep_plain))
    seen = {}

    def both(*args):
        vk = torch.zeros_like(args[0])
        vp = torch.zeros_like(args[0])
        seen.update(k=kernel(*args, vk), p=plain(*args, vp), vk=vk, vp=vp)
        return seen["k"]

    tag = "B2" if mxu else "B1"
    before = launches.read_counts()[tag]
    kw = dict(variant="mxu", mat_tbl=tables[3]) if mxu else {}
    cluster.cluster_sweep(o, d, t0, *tables[:3], ray_block=ray_block,
                          block_fn=both, **kw)
    torch.cuda.synchronize()
    assert launches.read_counts()[tag] == before + 1
    return seen["k"], seen["p"], seen["vk"], seen["vp"]


@pytest.mark.gpu
@pytest.mark.parametrize("ray_block", [8, 64, 512, 2048])
def test_kernel_matches_plain_twin(ray_block):
    _need_card()
    scene, _ = bunny_like_scene(3, device="cuda")
    tables = cluster.build_cluster_tables(scene.mesh)
    o, d, t0 = _rays(3000, 1, "cuda")
    k, p, vk, vp = _sweep_both(o, d, t0, tables, ray_block)
    # built with -fmad=false, the kernel rounds like the op-by-op twin
    assert torch.equal(k, p)
    assert torch.equal(vk, vp)
    assert int((k[..., 11] >= 0).sum()) > 500


@pytest.mark.gpu
@pytest.mark.parametrize("ctas, groups", [(1, 1), (2, 2), (4, 2), (8, 4),
                                          (8, 8)])
def test_kernel_layouts_match_plain_twin(ctas, groups, monkeypatch):
    """Every layout the kernel takes -- CTAs per ray block (a thread block
    cluster) and threads per ray -- gives the twin's payload and visits."""
    _need_card()
    monkeypatch.setattr(cluster, "SWEEP_CTAS", ctas)
    monkeypatch.setattr(cluster, "SWEEP_GROUPS", groups)
    assert cluster.sweep_layout(1024) == (ctas, groups, 1)
    scene, _ = bunny_like_scene(3, device="cuda")
    tables = cluster.build_cluster_tables(scene.mesh)
    o, d, t0 = _rays(8192, 4, "cuda")
    k, p, vk, vp = _sweep_both(o, d, t0, tables, 1024)
    assert torch.equal(k, p) and torch.equal(vk, vp)


@pytest.mark.gpu
@pytest.mark.parametrize("ray_block", [64, 512, 2048])
def test_kernel_matches_plain_twin_tie_heavy(ray_block):
    """Exact t-ties within and across clusters, and blocks that stop
    early: the kernel gives each tie to the twin's copy."""
    _need_card()
    o, d, t0, *tables = tie_heavy_query(4096, 12, seed=3, device="cuda")
    k, p, vk, vp = _sweep_both(o, d, t0, tables, ray_block)
    assert torch.equal(k, p) and torch.equal(vk, vp)


@pytest.mark.gpu
def test_kernel_wrapper_rejects_bad_inputs():
    _need_card()
    scene, _ = bunny_like_scene(2, device="cuda")
    tris, cmin, cmax = cluster.build_cluster_tables(scene.mesh)
    C = cmin.shape[0]
    nact = torch.zeros(2, dtype=torch.int32, device="cuda")
    clist = torch.zeros((2, C), dtype=torch.int32, device="cuda")
    bt0 = torch.zeros((2, C), device="cuda")
    rays = torch.zeros((2, 64, 16), device="cuda")
    with pytest.raises(ValueError, match="clist"):
        cluster.cluster_sweep_kernel(nact, clist.long(), bt0, rays, rays,
                                     tris)
    with pytest.raises(ValueError, match="rays"):
        cluster.cluster_sweep_kernel(nact, clist, bt0, rays[:, :, :8], rays,
                                     tris)


@pytest.mark.gpu
def test_sweep_frame_kernel_equals_plain_twin():
    _need_card()
    scene, cam = bunny_like_scene(3, device="cuda")
    mats = camera_matrices(cam, 1.0)
    cfg = RenderConfig(width=64, height=64, max_bounces=3)
    imgs = [golden.render_frame(
        scene, mats, cfg, 2,
        intersect_fn=sweep.make_intersect_fn(scene, cfg, block_fn=fn))
        for fn in (None, cluster.cluster_sweep_plain)]
    assert torch.isfinite(imgs[0]).all()
    assert torch.equal(imgs[0], imgs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("ray_block", [512, 64, 2048])
def test_mxu_kernel_matches_plain_twin(ray_block):
    _need_card()
    scene, _ = bunny_like_scene(3, device="cuda")
    tw, cmin, cmax, mat = cluster.build_cluster_tables_mxu(scene.mesh)
    o, d, t0 = _rays(3000, 1, "cuda")
    seen = {}

    def both(nact, clist, bt0, rays, prev, trisW, mat_tbl):
        vk = torch.zeros_like(nact)
        vp = torch.zeros_like(nact)
        args = (nact, clist, bt0, rays, prev, trisW, mat_tbl)
        k = cluster.cluster_sweep_mxu_kernel(*args, vk)
        p = cluster.cluster_sweep_mxu_plain(*args, vp)
        seen.update(k=k, p=p, vk=vk, vp=vp)
        return k

    before = launches.read_counts()["B2"]
    cluster.cluster_sweep(o, d, t0, tw, cmin, cmax, ray_block=ray_block,
                          block_fn=both, variant="mxu", mat_tbl=mat)
    torch.cuda.synchronize()
    assert launches.read_counts()["B2"] == before + 1
    assert torch.equal(seen["k"], seen["p"])
    assert torch.equal(seen["vk"], seen["vp"])
    assert int((seen["k"][..., 11] >= 0).sum()) > 500


@pytest.mark.gpu
@pytest.mark.parametrize("ctas, groups", [(1, 1), (2, 2), (2, 4), (4, 2),
                                          (4, 4), (8, 4)])
@pytest.mark.parametrize("query", ["tie-heavy", "signed-zero"])
def test_mxu_kernel_layouts_match_plain_twin(query, ctas, groups,
                                             monkeypatch):
    """The plane-form kernel under every layout it is timed in, on exact
    t-ties and on tests that pass through exact zeros (Q, P, Bu, Bv):
    payload and visits equal the twin's."""
    _need_card()
    monkeypatch.setattr(cluster, "sweep_layout",
                        lambda B: (ctas, groups, 1))
    make = tie_heavy_query if query == "tie-heavy" else signed_zero_query
    o, d, t0, *tables = make(8192, 12, seed=3, device="cuda", variant="mxu")
    k, p, vk, vp = _sweep_both(o, d, t0, tables, 512)
    assert torch.equal(k, p) and torch.equal(vk, vp)
    assert int((k[..., 11] >= 0).sum()) > 1000


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["mt", "mxu"])
@pytest.mark.parametrize("ray_block", [8192, 16384, 65536])
def test_kernels_take_large_ray_blocks(variant, ray_block):
    """Ray blocks past one ray per thread of a full thread block cluster
    (several passes per visit above 8,192 rays): both kernels equal their
    twins."""
    _need_card()
    scene, _ = bunny_like_scene(3, device="cuda")
    tables = (cluster.build_cluster_tables_mxu(scene.mesh) if variant == "mxu"
              else cluster.build_cluster_tables(scene.mesh))
    o, d, t0 = _rays(70000, 5, "cuda")
    k, p, vk, vp = _sweep_both(o, d, t0, tables, ray_block)
    assert torch.equal(k, p) and torch.equal(vk, vp)
    assert int((k[..., 11] >= 0).sum()) > 10000


@pytest.mark.gpu
def test_mxu_vote_counts():
    """The counting build gives the same payload, and its counts nest:
    slot steps tested >= passed the t vote >= passed the u vote > 0."""
    _need_card()
    o, d, t0, *tables = signed_zero_query(8192, 12, seed=4, device="cuda",
                                          variant="mxu")
    seen = {}

    def counted(*args):
        counts = torch.zeros(3, dtype=torch.int64, device="cuda")
        seen.update(plain=cluster.cluster_sweep_mxu_kernel(*args),
                    counted=cluster.cluster_sweep_mxu_kernel(*args, None,
                                                             counts),
                    counts=counts)
        return seen["plain"]

    cluster.cluster_sweep(o, d, t0, *tables[:3], block_fn=counted,
                          variant="mxu", mat_tbl=tables[3])
    torch.cuda.synchronize()
    assert torch.equal(seen["plain"], seen["counted"])
    tested, vote1, vote2 = seen["counts"].tolist()
    assert tested >= vote1 >= vote2 > 0


@pytest.mark.gpu
def test_mxu_wrapper_rejects_tables_not_of_the_plane_form():
    _need_card()
    scene, _ = bunny_like_scene(2, device="cuda")
    tw, cmin, cmax, mat = cluster.build_cluster_tables_mxu(scene.mesh)
    tw = tw.clone()
    tw.view(-1, cluster.MXU_ROWS, cluster.MXU_FIELDS,
            cluster.CLUSTER_TRIS)[0, 7, 1, 3] = 1.0
    o, d, t0 = _rays(64, 3, "cuda")
    with pytest.raises(ValueError, match="plane form"):
        cluster.cluster_sweep(o, d, t0, tw, cmin, cmax, variant="mxu",
                              mat_tbl=mat)


@pytest.mark.gpu
def test_mxu_frame_kernel_equals_plain_twin():
    _need_card()
    scene, cam = bunny_like_scene(3, device="cuda")
    mats = camera_matrices(cam, 1.0)
    cfg = RenderConfig(width=64, height=64, max_bounces=3,
                       cluster_kernel="mxu")
    imgs = [golden.render_frame(
        scene, mats, cfg, 2,
        intersect_fn=sweep.make_intersect_fn(scene, cfg, block_fn=fn))
        for fn in (None, cluster.cluster_sweep_mxu_plain)]
    assert torch.isfinite(imgs[0]).all()
    assert torch.equal(imgs[0], imgs[1])


@pytest.mark.gpu
def test_bvh_walk_kernel_matches_plain_walk():
    _need_card()
    scene, _ = bunny_like_scene(3, max_blas_tris=256, device="cuda")
    assert int(scene.mesh.draw_count) >= 5
    o, d, t0 = _rays(3000, 2, "cuda")
    ck = torch.zeros((3000, traversal.COUNT_COLS), dtype=torch.int32,
                     device="cuda")
    cp = torch.zeros_like(ck)
    before = launches.read_counts()["B3"]
    tk, ok = traversal.bvh_walk_kernel(o, d, t0, scene.mesh, ck)
    tp, op = traversal.bvh_walk_plain(o, d, t0, scene.mesh, cp)
    torch.cuda.synchronize()
    assert launches.read_counts()["B3"] == before + 1
    assert torch.equal(ok, op) and torch.equal(tk, tp)
    assert torch.equal(ck, cp)
    assert int((ok >= 0).sum()) > 500


@pytest.mark.gpu
def test_bvh_walk_wrapper_rejects_bad_inputs():
    _need_card()
    scene, _ = bunny_like_scene(2, device="cuda")
    o, d, t0 = _rays(64, 3, "cuda")
    with pytest.raises(ValueError, match="origin"):
        traversal.bvh_walk_kernel(o.double(), d, t0, scene.mesh)
    with pytest.raises(ValueError, match="t_init"):
        traversal.bvh_walk_kernel(o, d, t0[:10], scene.mesh)
    cyclic = dataclasses.replace(
        scene.mesh, bvh_left=torch.zeros_like(scene.mesh.bvh_left),
        bvh_count=torch.zeros_like(scene.mesh.bvh_count))
    with pytest.raises(ValueError, match="more than 64 levels"):
        traversal.bvh_walk_kernel(o, d, t0, cyclic)


@functools.lru_cache(maxsize=None)
def _walk_case(case):
    """(mesh, [(origin, direction, t_init, alive)], [twin (t, off, counts)
    of each query over every lane]).  The bunnies' queries are a 64 x 64
    'pallas' frame's three, captured with the transport's alive masks;
    the tie-heavy and signed-zero banks get a seeded mask."""
    if case.endswith("bunny"):
        scene, cam = bunny_gltf_scene(
            max_blas_tris=8192 if case == "split bunny" else None,
            device="cuda")
        mesh, queries = scene.mesh, []

        def capture(o, d, t0, mesh, alive=None):
            queries.append((o.clone(), d.clone(), t0.clone(), alive.clone()))
            return traversal.bvh_walk_plain(o, d, t0, mesh, alive=alive)

        golden.render_frame(
            scene, camera_matrices(cam, 1.0),
            RenderConfig(width=64, height=64, max_bounces=2), 0,
            intersect_fn=wavefront.make_intersect_fn_pallas(scene, capture))
    else:
        make = tie_heavy_query if case == "tie-heavy" else signed_zero_query
        o, d, t0, mesh = make(8192, 8, seed=5, device="cuda", variant="bank")
        alive = torch.from_numpy(np.random.default_rng(6).random(8192) < 0.7)
        queries = [(o, d, t0, alive.cuda())]
    twins = []
    for o, d, t0, _ in queries:
        counts = torch.zeros((o.shape[0], traversal.COUNT_COLS),
                             dtype=torch.int32, device="cuda")
        twins.append(traversal.bvh_walk_plain(o, d, t0, mesh, counts)
                     + (counts,))
    return mesh, queries, twins


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["split bunny", "unsplit bunny",
                                  "tie-heavy", "signed-zero"])
def test_bvh_walk_layouts_match_plain_walk(case):
    """The kernel's one layout, on every lane and on the live lanes only:
    (t, off) and the counters equal the twin's bit for bit; a dead lane
    gives (t_init, -1) and zero counters."""
    _need_card()
    mesh, queries, twins = _walk_case(case)
    hits = 0
    for (o, d, t0, alive), (tp, op, cp) in zip(queries, twins):
        for mask in (None, alive):
            ck = torch.full_like(cp, 7)
            before = launches.read_counts()["B3"]
            tk, ok = traversal.bvh_walk_kernel(o, d, t0, mesh, ck, alive=mask)
            torch.cuda.synchronize()
            assert launches.read_counts()["B3"] == before + 1
            live = torch.ones_like(alive) if mask is None else mask
            assert torch.equal(tk, torch.where(live, tp, t0))
            assert torch.equal(ok, torch.where(live, op, -1))
            assert torch.equal(ck, torch.where(live[:, None], cp, 0))
        hits += int((op >= 0).sum())
    assert hits > 1000


@pytest.mark.gpu
def test_walk_tables_on_the_card_equal_the_cpu_tables():
    """The packing on the card gives the CPU's records bit for bit."""
    _need_card()
    scene, _ = bunny_like_scene(3, max_blas_tris=256, device="cuda")
    got = traversal.walk_tables(scene.mesh)
    want = traversal.walk_tables(scene.mesh.to("cpu"))
    for name in ("nodes", "tris", "draws"):
        assert torch.equal(getattr(got, name).cpu().view(torch.int32),
                           getattr(want, name).view(torch.int32)), name


@pytest.mark.gpu
def test_pallas_frame_kernel_equals_plain_walk():
    _need_card()
    scene, cam = bunny_like_scene(3, max_blas_tris=256, device="cuda")
    mats = camera_matrices(cam, 1.0)
    cfg = RenderConfig(width=64, height=64, max_bounces=3)
    img_k = wavefront.render_frame_pallas(scene, mats, cfg, 2)
    img_p = golden.render_frame(
        scene, mats, cfg, 2, intersect_fn=wavefront.make_intersect_fn_pallas(
            scene, walk_fn=traversal.bvh_walk_plain))
    img_w = wavefront.render_frame(scene, mats, cfg.replace(traversal="stack"),
                                   2)
    assert torch.isfinite(img_k).all()
    assert torch.equal(img_k, img_p) and torch.equal(img_k, img_w)


@pytest.mark.gpu
def test_pallas_frame_alive_mask_keeps_the_image():
    """Walking only live lanes leaves the frame bit for bit unchanged."""
    _need_card()
    scene, cam = bunny_like_scene(3, max_blas_tris=256, device="cuda")
    mats = camera_matrices(cam, 1.0)
    cfg = RenderConfig(width=64, height=64, max_bounces=3)

    def every_lane(scene, origin, direction, cfg):
        return wavefront.intersect_scene_pallas(scene, origin, direction, cfg)

    before = launches.read_counts()["B3"]
    img_m = wavefront.render_frame_pallas(scene, mats, cfg, 2)
    img_a = golden.render_frame(scene, mats, cfg, 2, intersect_fn=every_lane)
    assert launches.read_counts()["B3"] == before + 8
    assert torch.isfinite(img_m).all()
    assert torch.equal(img_m, img_a)


def lit_bunny_like(subdivisions, max_blas_tris=None):
    """bunny_like_scene(subdivisions) plus one emissive sphere (default
    scene's "Left" material) at (-2, 3, 1), radius 0.5, so NEE has a light;
    a test fixture, as in tests/test_torch_nee.py."""
    b = SceneBuilder()
    body = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.65, 0.6, 0.5))
    ground = b.add_material(MATERIAL_METAL, albedo=(0.6, 0.6, 0.6),
                            roughness=0.9)
    v, idx = bumpy_sphere(subdivisions)
    v[:, 1] += 1.0
    b.add_mesh(v, idx, tri_material=body, max_blas_tris=max_blas_tris)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    lamp = b.add_material(MATERIAL_METAL, emission=(1.6, 1.6, 1.6),
                          emission_strength=1.0)
    b.add_sphere((-2.0, 3.0, 1.0), 0.5, lamp)
    return b.build("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["mt", "mxu"])
def test_shadow_query_kernel_matches_plain_twin(variant):
    """NEE's shadow query: the sweep bounded at a finite max_dist on most
    lanes, -inf (disabled) and 0 on others; kernel and twin bit for bit,
    and the any-hit flags equal the brute any-hit's."""
    _need_card()
    scene, _ = bunny_like_scene(3, device="cuda")
    cfg = RenderConfig(cluster_kernel=variant)
    tables = sweep.build_tables(scene.mesh, cfg)
    o, d, _ = _rays(3000, 4, "cuda")
    maxd = torch.full((3000,), 2.5, device="cuda")
    maxd[::5] = -cluster.KINF
    maxd[1::7] = 0.0
    k, p, vk, vp = _sweep_both(o, d, maxd, tables, 512)
    assert torch.equal(k, p) and torch.equal(vk, vp)
    occ = sweep.occluded_sweep(scene, o, d, maxd, cfg)
    assert torch.equal(occ, golden.occluded_brute(scene, o, d, maxd, cfg))
    assert 0 < int(occ.sum()) < 3000 and not bool(occ[::5].any())


def _nee_grads(scene, mats, cfg, make):
    """Bench loss + vertex grads of one NEE frame through ``make`` (scene,
    cfg) -> intersect_fn, under deterministic algorithms -> (image, loss,
    grads, ops without a deterministic form)."""
    trainable = prender.BENCH_TRAINABLE + ("vertices",)
    target = torch.zeros((cfg.height, cfg.width, 3), device="cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss, grads = prender.scene_loss_grad(cfg, trainable, make)(
                scene, mats, 2, target)
        finally:
            torch.use_deterministic_algorithms(False)
    with torch.no_grad():
        img = golden.render_frame(scene, mats, cfg, 2,
                                  intersect_fn=make(scene, cfg))
    return img, loss, grads, [str(w.message) for w in caught
                              if "deterministic" in str(w.message)]


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["B1", "B2", "B3"])
def test_nee_grads_kernel_equal_plain_twin(path, monkeypatch):
    """A 32 x 32 NEE+MIS frame of the lit bunny through each kernel and
    through its twin: the image and loss bitwise, the grads bitwise under
    deterministic algorithms (within 1e-6 of each leaf's largest |g| where
    PyTorch names an op without a deterministic form)."""
    _need_card()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    scene = lit_bunny_like(3, max_blas_tris=256 if path == "B3" else None)
    mats = camera_matrices(bunny_like_scene(1, device="cuda")[1], 1.0)
    cfg = RenderConfig(width=32, height=32, max_bounces=2, use_nee=True,
                       mis=True, cluster_kernel="mxu" if path == "B2"
                       else "mt")

    def make(plain):
        if path == "B3":
            walk = traversal.bvh_walk_plain if plain else None
            return lambda s, c: wavefront.make_intersect_fn_pallas(s, walk)
        twin = (cluster.cluster_sweep_mxu_plain if path == "B2"
                else cluster.cluster_sweep_plain)
        return lambda s, c: sweep.make_intersect_fn(
            s, c, block_fn=twin if plain else None)

    ik, lk, gk, nk = _nee_grads(scene, mats, cfg, make(False))
    ip, lp, gp, np_ = _nee_grads(scene, mats, cfg, make(True))
    assert torch.isfinite(ik).all() and float(lk) > 0.0
    assert torch.equal(ik, ip) and torch.equal(lk, lp)
    for key in gk:
        assert torch.isfinite(gk[key]).all(), key
        if nk or np_:
            scale = float(gp[key].abs().max())
            assert float((gk[key] - gp[key]).abs().max()) <= 1e-6 * scale, \
                (key, nk + np_)
        else:
            assert torch.equal(gk[key], gp[key]), key



@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["mt", "mxu"])
def test_edge_query_kernel_matches_plain_twin(variant):
    """The silhouette estimator's widened query (miter-expanded tables,
    t_init = KINF) through B1 and through its twin: payload and visits bit
    for bit, and the same record as the brute-force widened query where
    both find a triangle.  Under cluster_kernel="mxu" the query still
    launches B1, not B2."""
    _need_card()
    scene, cam = bunny_like_scene(3, device="cuda")
    mats = camera_matrices(cam, 1.0)
    cfg = RenderConfig(width=64, height=64, edge_grads=True,
                       cluster_kernel=variant)
    dirs = primary_ray_directions(mats, 64, 64).reshape(-1, 3)
    origin = mats.position.expand_as(dirs).contiguous()
    pix_ang = 2.0 * mats.inverse_projection[1, 1] / 64.0
    seen = {}

    def both(*args):
        vk = torch.zeros_like(args[0])
        vp = torch.zeros_like(args[0])
        seen.update(k=cluster.cluster_sweep_kernel(*args, vk),
                    p=cluster.cluster_sweep_plain(*args, vp), vk=vk, vp=vp)
        return seen["k"]

    sweep.tri_edge_candidate_sweep(scene, origin, dirs, cfg, pix_ang,
                                   block_fn=both)
    torch.cuda.synchronize()
    assert torch.equal(seen["k"], seen["p"])
    assert torch.equal(seen["vk"], seen["vp"])
    before = (launches.read_counts()["B1"],
              launches.read_counts()["B2"])
    fn = sweep.make_intersect_fn(scene, cfg)
    got = fn.edge_tri_fn(scene, origin, dirs, cfg, pix_ang)
    assert (launches.read_counts()["B1"],
            launches.read_counts()["B2"]) == (before[0] + 1,
                                                           before[1])
    want = golden.tri_edge_candidate_brute(scene, origin, dirs, cfg, pix_ang)
    f = want["found"]
    assert torch.equal(got["found"], f) and float(f.float().mean()) > 0.1
    assert torch.allclose(got["t_w"][f], want["t_w"][f], rtol=1e-5)
    assert torch.equal(got["material"][f], want["material"][f])


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["B1", "B2", "B3"])
def test_edge_grads_kernel_equal_plain_twin(path, monkeypatch):
    """A 32 x 32 ``edge_grads`` NEE+MIS frame of the lit bunny through each
    kernel path and its twin: image and loss bitwise, grads (bench leaves
    and vertices) bitwise under deterministic algorithms.  On B1 and B2 the
    widened query goes through B1 or its twin; on B3 it is brute force."""
    _need_card()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    scene = lit_bunny_like(3, max_blas_tris=256 if path == "B3" else None)
    mats = camera_matrices(bunny_like_scene(1, device="cuda")[1], 1.0)
    cfg = RenderConfig(width=32, height=32, max_bounces=2, use_nee=True,
                       mis=True, edge_grads=True,
                       cluster_kernel="mxu" if path == "B2" else "mt")

    def make(plain):
        if path == "B3":
            walk = traversal.bvh_walk_plain if plain else None
            return lambda s, c: wavefront.make_intersect_fn_pallas(s, walk)
        twin = (cluster.cluster_sweep_mxu_plain if path == "B2"
                else cluster.cluster_sweep_plain)
        return lambda s, c: sweep.make_intersect_fn(
            s, c, block_fn=twin if plain else None)

    ik, lk, gk, nk = _nee_grads(scene, mats, cfg, make(False))
    ip, lp, gp, np_ = _nee_grads(scene, mats, cfg, make(True))
    assert torch.isfinite(ik).all() and float(lk) > 0.0
    assert torch.equal(ik, ip) and torch.equal(lk, lp)
    for key in gk:
        assert torch.isfinite(gk[key]).all(), key
        if nk or np_:
            scale = float(gp[key].abs().max())
            assert float((gk[key] - gp[key]).abs().max()) <= 1e-6 * scale, \
                (key, nk + np_)
        else:
            assert torch.equal(gk[key], gp[key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("renderer", ["golden", "sweep", "pallas"])
def test_compact_frame_on_card_equals_plain(renderer):
    """Compaction on the card, 64 x 64, 6 bounces, RR from bounce 1: the
    compacted frame equals the plain frame bit for bit through brute force
    and the BVH walk; through the sweep a block holds other lanes when
    compacted, so an exact cross-cluster t-tie may go the other way, and at
    most 1 % of pixels may differ."""
    _need_card()
    scene, cam = bunny_like_scene(3 if renderer != "golden" else 1,
                                  device="cuda")
    mats = camera_matrices(cam, 1.0)
    cfg = RenderConfig(width=64, height=64, max_bounces=6, use_rr=True,
                       rr_start_bounce=1)
    fn = {"golden": golden.intersect_scene_brute,
          "sweep": sweep.make_intersect_fn(scene, cfg),
          "pallas": wavefront.intersect_scene_pallas}[renderer]
    with torch.no_grad():
        a = golden.render_frame(scene, mats, cfg, 1, fn)
        b = golden.render_frame(scene, mats, cfg.replace(compact=True), 1, fn)
    assert torch.isfinite(a).all() and float(a.mean()) > 0.0
    if renderer == "sweep":
        differ = (a - b).abs().amax(dim=-1) > 0.0
        assert float(differ.float().mean()) <= 0.01
    else:
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_renderer_step_on_card_equals_render_step():
    """``Renderer.step`` on the card (dispatch "auto" -> the sweep, B1) is
    the chain of ``golden.render_step`` calls, bit for bit, and an edit
    resets it to a fresh frame 0."""
    _need_card()
    from wc_path_tracer_tpu_torch.render.renderer import Renderer
    scene, cam = bunny_like_scene(2, device="cuda")
    cfg = RenderConfig(width=64, height=64, max_bounces=2)
    r = Renderer(scene, cam, cfg)
    assert r.device.type == "cuda" and r.image.is_cuda
    before = launches.read_counts()["B1"]
    r.step(2)
    assert launches.read_counts()["B1"] - before == 2 * 3
    mats = camera_matrices(cam, 1.0)
    with torch.no_grad():
        want = golden.render_step(scene, mats, cfg, 1, golden.render_step(
            scene, mats, cfg, 0, None))
    assert torch.equal(r.image, want)
    r.update_material(0, albedo=(0.9, 0.1, 0.1))
    assert r.frame_count == 0
    with torch.no_grad():
        want = golden.render_step(r.scene, mats, cfg, 0, None)
    assert torch.equal(r.step(1), want)


@pytest.mark.gpu
def test_post_on_card_matches_cpu():
    """Every tonemap, bloom and the composite on the card against the same
    functions on the CPU (rtol 1e-5)."""
    _need_card()
    from wc_path_tracer_tpu_torch.ops import bloom
    from wc_path_tracer_tpu_torch.ops import tonemap as tm
    r = np.random.default_rng(0)
    img = torch.tensor(r.uniform(0.0, 6.0, (37, 53, 3)), dtype=torch.float32)
    for name in tm.TONEMAPS:
        torch.testing.assert_close(tm.apply(img.cuda(), name).cpu(),
                                   tm.apply(img, name), rtol=1e-5, atol=1e-6,
                                   msg=name)
    for fn in (bloom.bloom, bloom.bloom_pyramid, bloom.composite):
        torch.testing.assert_close(fn(img.cuda()).cpu(), fn(img), rtol=1e-5,
                                   atol=1e-6)


# P1's sizes: the serving cells' 1024^2 and 512^2, an odd size and one
# whose pyramid is a single level (a side <= 4)
POST_SIZES = {"1024": (1024, 1024), "512": (512, 512), "37x53": (37, 53),
              "3x5": (3, 5)}
# launches of one post_frame_kernel call with bloom: the levels down and up
# and the composite
POST_LAUNCHES = {"1024": 16, "512": 14, "37x53": 8, "3x5": 2}


def _post_hdr(h, w, seed):
    """An (h, w, 3) HDR image seeded from numpy whose values span zero
    (negatives and exact zeros), the bloom knee (0.9-1.1) and the
    prefilter's clamp (above 20)."""
    r = np.random.default_rng(seed)
    anchor = r.choice([-0.3, 0.0, 0.02, 0.3, 0.9, 0.95, 1.0, 1.05, 1.1, 3.0,
                       19.0, 25.0, 80.0], size=(h, w, 3))
    x = anchor * r.uniform(0.97, 1.03, (h, w, 3))
    x[r.random((h, w, 3)) < 0.03] = 0.0
    return torch.tensor(x, dtype=torch.float32, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bloom", [True, False], ids=["bloom", "no-bloom"])
@pytest.mark.parametrize("size", list(POST_SIZES))
def test_post_kernel_equals_finalize(size, bloom):
    """P1 against ``_finalize`` on the card, bit for bit in the uint8
    image, for every tonemap at gamma 1.0 and 2.2 (and ACES with other
    bloom settings); each call launches the pyramid's levels down and up
    and the composite (the composite alone without bloom) and counts its
    pixels under ``post.pixels``."""
    _need_card()
    from wc_path_tracer_tpu_torch.ops import tonemap as tm
    from wc_path_tracer_tpu_torch.render.renderer import _finalize
    h, w = POST_SIZES[size]
    img = _post_hdr(h, w, seed=h * 7 + w)
    cases = [(name, gamma, 1.0, 0.1, 1.0) for name in tm.TONEMAPS
             for gamma in (1.0, 2.2)]
    cases.append(("aces", 2.2, 0.8, 0.25, 0.6))
    per_call = POST_LAUNCHES[size] if bloom else 1
    assert per_call == (2 * len(post.pyramid(h, w)) if bloom else 1)
    for name, gamma, threshold, knee, strength in cases:
        want = _finalize(img, name, gamma, bloom, threshold, knee, strength)
        before = launches.read_counts()
        with profiling.counting() as counts:
            got = post.post_frame_kernel(img, name, gamma, bloom, threshold,
                                         knee, strength)
        torch.cuda.synchronize()
        assert launches.read_counts() == dict(
            before, P1=before["P1"] + per_call)
        assert counts == {"post.pixels": h * w}
        assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
        assert _bits_differ(got, want) is None, (name, gamma, threshold,
                                                 _bits_differ(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("size", list(POST_SIZES))
def test_post_kernel_pyramid_equals_bloom_pyramid(size):
    """P1's bloom levels, down and up (``post._pyramid``, the launches
    before the composite), against ``ops/bloom.py::bloom_pyramid`` on the
    card, bit for bit in float32."""
    _need_card()
    import ctypes
    from wc_path_tracer_tpu_torch.ops import bloom as bl
    h, w = POST_SIZES[size]
    img = _post_hdr(h, w, seed=h + w)
    for threshold, knee in ((1.0, 0.1), (0.8, 0.25)):
        consts = post.constants("none", 1.0, threshold, knee, 1.0)[0]
        got = post._pyramid(img, ctypes.addressof(consts), ())
        want = bl.bloom_pyramid(img, threshold, knee)
        torch.cuda.synchronize()
        assert _bits_differ(got, want) is None, (threshold, knee)


@pytest.mark.gpu
def test_renderer_output_on_card_takes_post_kernel(tmp_path):
    """``Renderer.output`` on the card launches P1 (bloom: the levels and
    the composite), counts ``post.pixels`` and gives ``_finalize``'s
    image, bit for bit; ``save_png`` writes the same pixels."""
    _need_card()
    from wc_path_tracer_tpu_torch.io.image import read_png
    from wc_path_tracer_tpu_torch.render.renderer import _finalize
    scene, cam = bunny_like_scene(2, device="cuda")
    cfg = RenderConfig(width=96, height=64, max_bounces=2, bloom=True,
                       tonemap="aces", gamma=2.2)
    r = Renderer(scene, cam, cfg)
    r.step(2)
    before = launches.read_counts()
    with profiling.counting() as counts:
        out = r.output()
    assert launches.read_counts() == dict(
        before, P1=before["P1"] + 2 * len(post.pyramid(64, 96)))
    assert counts == {"post.pixels": 64 * 96}
    want = _finalize(r.image, "aces", 2.2, True, cfg.bloom_threshold,
                     cfg.bloom_knee, cfg.bloom_strength).cpu().numpy()
    assert np.array_equal(out, want)
    for kw in (dict(tonemap="pbr_neutral"), dict(gamma=1.0)):
        want = _finalize(r.image, kw.get("tonemap", "aces"),
                         kw.get("gamma", 2.2), True, cfg.bloom_threshold,
                         cfg.bloom_knee, cfg.bloom_strength).cpu().numpy()
        assert np.array_equal(r.output(**kw), want), kw
    r.save_png(str(tmp_path / "a.png"))
    assert np.array_equal(read_png(str(tmp_path / "a.png")), out)


@pytest.mark.gpu
def test_post_kernel_wrapper_rejects_bad_inputs():
    """P1 refuses an image of another dtype, shape or layout, naming the
    wrapper and the input, and an unknown tonemap as ``tonemap.apply``
    does; nothing is launched."""
    _need_card()
    img = _post_hdr(8, 8, seed=1)
    before = launches.read_counts()
    for bad in (img.double(), img[..., :2], img.transpose(0, 1)):
        with pytest.raises(ValueError, match="post_frame_kernel: img must"):
            post.post_frame_kernel(bad, "aces", 2.2, True, 1.0, 0.1, 1.0)
    with pytest.raises(ValueError, match="unknown tonemap 'nope'"):
        post.post_frame_kernel(img, "nope", 2.2, True, 1.0, 0.1, 1.0)
    assert launches.read_counts() == before


@pytest.mark.gpu
def test_cli_render_on_card(tmp_path):
    """``python -m wc_path_tracer_tpu_torch render`` runs on the card by
    default and exits 0."""
    _need_card()
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "a.png")
    proc = subprocess.run(
        [sys.executable, "-m", "wc_path_tracer_tpu_torch", "render",
         "--scene", "bunny", "--width", "64", "--height", "64", "--frames",
         "2", "--bloom", "--out", out], cwd=root, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "on cuda" in proc.stderr and os.path.exists(out)


@pytest.mark.gpu
def test_bench_on_card():
    """``python -m wc_path_tracer_tpu_torch.bench`` on the card by default:
    the bunny at 64^2 through "auto" exits 0 and prints bench.py's JSON
    line, with the cluster sweep and its cull launched 5 times per
    step."""
    _need_card()
    import json
    import math
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "wc_path_tracer_tpu_torch.bench", "--scene",
         "bunny", "--size", "64", "--iters", "2"], cwd=root,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "Mrays/s/chip fwd+bwd (64^2 bunny, 4 bounces)"
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    lines = [json.loads(line[len("bench: launches "):])
             for line in proc.stderr.splitlines()
             if line.startswith("bench: launches ")]
    assert lines[0]["per_step"] == launches.named(launches.zeros(B1=5,
                                                                 C1=5))


def _bits_differ(got, want):
    """None where ``got`` equals ``want`` bit for bit (floats compared by
    their bits), else how many elements differ and the first of them."""
    if got.dtype == torch.float32:
        g, w = got.view(torch.int32), want.view(torch.int32)
    else:
        g, w = got, want
    if g.shape == w.shape and torch.equal(g, w):
        return None
    bad = (g != w).reshape(g.shape[0], -1).any(dim=1).nonzero()[:4, 0]
    return (f"{int((g != w).sum())} differ; lanes {bad.tolist()}: "
            f"{got[bad].tolist()} against {want[bad].tolist()}")


@pytest.mark.gpu
@pytest.mark.parametrize("sky", ["gradient", "black"])
@pytest.mark.parametrize("use_rr", [False, True], ids=["rr-off", "rr-on"])
def test_shade_kernel_matches_bounce(use_rr, sky):
    """T1 against ``golden._bounce`` on the same lanes and hit records:
    every field of the next PathState bit for bit, in each of the 6
    segments of a 128^2 ``full_bsdf_scene`` frame (all four material
    types), an eighth of the lanes dead from the start."""
    _need_card()
    scene, cam = builtin.full_bsdf_scene(device="cuda")
    mats = camera_matrices(cam, 1.0)
    n = 128
    cfg = RenderConfig(width=n, height=n, max_bounces=5, use_rr=use_rr,
                       rr_start_bounce=1, sky=sky)
    dirs = primary_ray_directions(mats, n, n).reshape(-1, 3)
    lane = torch.arange(n * n, device="cuda")
    s = golden._initial_state(mats.position.expand(n * n, 3), dirs,
                              rng.pixel_seed(lane, 7))
    s.alive = lane % 8 != 5
    materials = shade.pack_materials(scene.materials)
    types = set()
    with torch.no_grad():
        for b in range(cfg.max_bounces + 1):
            rec = golden.intersect_scene_brute(scene, s.o, s.d, cfg)
            live = s.alive & rec.hit
            types |= set(scene.materials.mtype[rec.material[live].long()]
                         .tolist())
            want = golden._bounce(scene, cfg, lambda *a, **k: rec, s)
            before = launches.read_counts()["T1"]
            got = shade.shade_segment_kernel(
                s.o, s.d, s.total, s.trans, s.seed, s.alive, rec, materials,
                sky_gradient=sky != "black",
                rr=use_rr and b >= cfg.rr_start_bounce)
            torch.cuda.synchronize()
            assert launches.read_counts()["T1"] == before + 1
            for name, g in zip(("o", "d", "total", "trans", "seed", "alive"),
                               got):
                assert _bits_differ(g, getattr(want, name)) is None, \
                    (b, name, _bits_differ(g, getattr(want, name)))
            s = want
    assert types == {MATERIAL_METAL, MATERIAL_DIELECTRIC,
                     MATERIAL_LAMBERTIAN, MATERIAL_GGX}
    assert 0 < int(s.alive.sum()) < n * n


@pytest.mark.gpu
def test_shade_kernel_wrapper_rejects_bad_inputs():
    """T1's wrapper raises on a wrong dtype, shape or device, and reads an
    expanded origin in place and any other layout as a copy."""
    _need_card()
    scene, _ = builtin.cornell_box_scene(device="cuda")
    n = 64
    f3 = torch.rand(n, 3, device="cuda")
    rec = golden.HitRecord(
        t=torch.rand(n, device="cuda"), p=f3.clone(), normal=f3.clone(),
        hit=torch.ones(n, dtype=torch.bool, device="cuda"),
        front=torch.ones(n, dtype=torch.bool, device="cuda"),
        material=torch.zeros(n, dtype=torch.int32, device="cuda"))
    seed = torch.arange(n, device="cuda")
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    materials = shade.pack_materials(scene.materials)

    def call(o=f3, d=f3, seed=seed, rec=rec):
        return shade.shade_segment_kernel(o, d, f3, f3, seed, alive, rec,
                                          materials, True, False)

    long_material = dataclasses.replace(rec, material=rec.material.long())
    for bad in (dict(seed=seed.int()), dict(d=f3[:, :2].contiguous()),
                dict(o=f3.cpu()), dict(rec=long_material)):
        with pytest.raises(ValueError):
            call(**bad)
    origin = torch.rand(3, device="cuda")
    a = call(o=origin.expand(n, 3))
    b = call(o=origin.expand(n, 3).contiguous())
    c = call(o=torch.cat([origin.expand(n, 3)] * 2, 1)[:, 3:])
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, c):
        assert _bits_differ(y, x) is None and _bits_differ(z, x) is None


def _serving_scene(name):
    """(scene, camera, sky) of the serving cells' scenes, on the card."""
    if name == "cornell":
        return builtin.cornell_box_scene(device="cuda") + ("black",)
    return bunny_gltf_scene(device="cuda") + ("gradient",)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "bunny"])
def test_renderer_frames_with_shade_kernel_equal_plain(name, monkeypatch):
    """16 accumulated 64^2 ``Renderer`` frames (4 bounces, 1 spp) with T1
    equal those of the plain segment (``shade.on_card`` patched to say
    no) bit for bit: the Cornell box through brute force, the bunny
    through the sweep and B1."""
    _need_card()
    scene, cam, sky = _serving_scene(name)
    cfg = RenderConfig(width=64, height=64, max_bounces=4, sky=sky)

    def frames():
        r = Renderer(scene, cam, cfg)
        r.step(16)
        torch.cuda.synchronize()
        return r.image

    before = launches.read_counts()["T1"]
    fused = frames()
    assert launches.read_counts()["T1"] - before == 16 * 5
    monkeypatch.setattr(shade, "on_card", lambda t: False)
    plain = frames()
    assert launches.read_counts()["T1"] - before == 16 * 5
    assert float(plain.mean()) > 0.0
    assert _bits_differ(fused, plain) is None, _bits_differ(fused, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("samples, bounces", [(1, 4), (2, 2)])
def test_shade_kernel_launches_per_frame(samples, bounces):
    """T1 launches ``max_bounces + 1`` times per sample per frame, one
    launch per closest-hit query over the lanes handed to it."""
    _need_card()
    scene, cam, sky = _serving_scene("cornell")
    cfg = RenderConfig(width=32, height=32, samples=samples,
                       max_bounces=bounces, sky=sky)
    r = Renderer(scene, cam, cfg)
    before = launches.read_counts()["T1"]
    r.step(3)
    assert launches.read_counts()["T1"] - before \
        == 3 * samples * (bounces + 1)
    with profiling.counting() as counts:
        r.step(1)
    assert launches.read_counts()["T1"] - before \
        == 4 * samples * (bounces + 1)
    assert counts["intersect.lanes"] \
        == 32 * 32 * samples * (bounces + 1)


def _brute_both(scene, o, d, cfg):
    """H1 and its plain twin on the same lanes -> the fields that differ
    bit for bit ({} where none does)."""
    abc = golden.triangle_vertices(scene.mesh)
    sph, mesh = scene.spheres, scene.mesh
    before = launches.read_counts()["H1"]
    got = brute.brute_hit_kernel(o, d, sph.position, sph.radius, sph.count,
                                 *abc, mesh.tri_draw, mesh.draw_count,
                                 cfg.sphere_near_root_only)
    want = golden._brute_search(scene, o, d, cfg, *abc)
    torch.cuda.synchronize()
    assert launches.read_counts()["H1"] == before + 1
    differ = {name: _bits_differ(g, w) for name, g, w in
              zip(("t_s", "s_idx", "t_tri", "t_idx"), got, want)}
    return {k: v for k, v in differ.items() if v}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BRUTE_CASES))
def test_brute_kernel_matches_plain_twin(case):
    """H1 against ``golden._brute_search`` bit for bit on the CPU file's
    cases (near roots on and off, index ties, all miss, dead slots), then
    on 2^20 + 5 lanes of the same rays (a partial last block)."""
    _need_card()
    scene, o, d, cfg = brute_case(case)
    scene, o, d = scene.to("cuda"), o.cuda(), d.cuda()
    assert _brute_both(scene, o, d, cfg) == {}
    n = 2 ** 20 + 5
    reps = -(-n // o.shape[0])
    assert _brute_both(scene, o.repeat(reps, 1)[:n], d.repeat(reps, 1)[:n],
                       cfg) == {}


@pytest.mark.gpu
def test_brute_kernel_takes_many_slots():
    """Dispatch "golden" forced onto a mesh of 1,280 triangles and 300
    sphere slots (290 live): H1 stages them tile by tile (256 slots a
    tile), bit for bit with its twin."""
    _need_card()
    scene, cam = bunny_like_scene(3, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    sph = scene.spheres
    spheres = dataclasses.replace(
        sph, position=torch.rand(300, 3, generator=g, device="cuda") * 4 - 2,
        radius=torch.rand(300, generator=g, device="cuda") * 0.2,
        material=torch.zeros(300, dtype=torch.int32, device="cuda"),
        count=torch.tensor(290, dtype=torch.int32, device="cuda"))
    scene = dataclasses.replace(scene, spheres=spheres)
    assert scene.mesh.triangle_capacity > 4 * 256
    mats = camera_matrices(cam, 1.0)
    d = primary_ray_directions(mats, 128, 128).reshape(-1, 3)
    o = mats.position.expand(d.shape[0], 3)
    cfg = RenderConfig(width=128, height=128)
    assert _brute_both(scene, o, d, cfg) == {}
    assert _brute_both(scene, o, d, cfg.replace(
        sphere_near_root_only=False)) == {}


def _serving_query(name):
    """(scene, origin, direction, cfg) of one closest-hit query of a
    serving cell's box: the 1024^2 Cornell primary query, or the full-BSDF
    box's fourth segment at 512^2, its dead lanes (Russian roulette from
    bounce 1) keeping their last rays."""
    if name == "cornell":
        scene, cam = builtin.cornell_box_scene(device="cuda")
        n, bounces = 1024, 0
    else:
        scene, cam = builtin.full_bsdf_scene(device="cuda")
        n, bounces = 512, 3
    cfg = RenderConfig(width=n, height=n, max_bounces=8, use_rr=True,
                       rr_start_bounce=1, sky="black")
    mats = camera_matrices(cam, 1.0)
    dirs = primary_ray_directions(mats, n, n).reshape(-1, 3)
    lane = torch.arange(n * n, device="cuda")
    s = golden._initial_state(mats.position.expand(n * n, 3), dirs,
                              rng.pixel_seed(lane, 5))
    with torch.no_grad():
        for _ in range(bounces):
            s = golden._bounce(scene, cfg, golden.intersect_scene_brute, s)
    if bounces:
        assert 0 < int(s.alive.sum()) < n * n
    return scene, s.o, s.d, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "full-bsdf"])
def test_brute_kernel_on_serving_queries(name, monkeypatch):
    """H1 bit for bit with its twin on every lane of a serving query, and
    the query's HitRecord through H1 equal to the plain path's
    (``brute.on_card`` patched to say no), with grad mode on and the
    vertices and camera origin requiring grad."""
    _need_card()
    scene, o, d, cfg = _serving_query(name)
    assert _brute_both(scene, o, d, cfg) == {}
    mesh = dataclasses.replace(
        scene.mesh, vertices=scene.mesh.vertices.clone().requires_grad_())
    scene = dataclasses.replace(scene, mesh=mesh)
    o = o.clone().requires_grad_()

    def record():
        before = launches.read_counts()["H1"]
        rec = golden.intersect_scene_brute(scene, o, d, cfg)
        torch.cuda.synchronize()
        return rec, launches.read_counts()["H1"] - before

    fused, launched = record()
    assert launched == 1 and fused.p.requires_grad
    monkeypatch.setattr(brute, "on_card", lambda t: False)
    plain, launched = record()
    assert launched == 0
    for field in ("t", "p", "normal", "hit", "front", "material"):
        g, w = getattr(fused, field).detach(), getattr(plain, field).detach()
        assert _bits_differ(g, w) is None, (field, _bits_differ(g, w))


@pytest.mark.gpu
@pytest.mark.parametrize("use_nee", [False, True], ids=["nee-off", "nee-on"])
def test_brute_kernel_grads_equal_plain(use_nee, monkeypatch):
    """A 32 x 32 Cornell box's bench loss and grads (vertices included)
    through H1 equal the plain path's: the image and loss bitwise, the
    grads bitwise under deterministic algorithms (within 1e-6 of each
    leaf's largest |g| where PyTorch names an op without a deterministic
    form)."""
    _need_card()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    scene, cam = builtin.cornell_box_scene(device="cuda")
    mats = camera_matrices(cam, 1.0)
    cfg = RenderConfig(width=32, height=32, max_bounces=2, use_nee=use_nee)

    def make(s, c):
        return golden.intersect_scene_brute

    before = launches.read_counts()["H1"]
    ik, lk, gk, nk = _nee_grads(scene, mats, cfg, make)
    assert launches.read_counts()["H1"] - before == 2 * 3
    monkeypatch.setattr(brute, "on_card", lambda t: False)
    ip, lp, gp, np_ = _nee_grads(scene, mats, cfg, make)
    assert launches.read_counts()["H1"] - before == 2 * 3
    assert torch.isfinite(ik).all() and float(lk) > 0.0
    assert torch.equal(ik, ip) and torch.equal(lk, lp)
    for key in gk:
        if nk or np_:
            scale = float(gp[key].abs().max())
            assert float((gk[key] - gp[key]).abs().max()) <= 1e-6 * scale, \
                (key, nk + np_)
        else:
            assert torch.equal(gk[key], gp[key]), key


@pytest.mark.gpu
def test_brute_kernel_wrapper_rejects_bad_inputs():
    """H1's wrapper raises on a wrong dtype, shape or device, and reads an
    expanded origin in place and any other layout as a copy."""
    _need_card()
    scene, cam = builtin.full_bsdf_scene(device="cuda")
    sph, mesh = scene.spheres, scene.mesh
    abc = golden.triangle_vertices(mesh)
    n = 1000
    d = torch.nn.functional.normalize(torch.randn(n, 3, device="cuda"), dim=1)
    origin = torch.tensor([278.0, 273.0, 300.0], device="cuda")

    def call(o=origin.expand(n, 3), d=d, count=sph.count,
             tri_draw=mesh.tri_draw):
        return brute.brute_hit_kernel(o, d, sph.position, sph.radius, count,
                                      *abc, tri_draw, mesh.draw_count, True)

    for bad in (dict(d=d[:, :2].contiguous()), dict(d=d.double()),
                dict(o=origin.expand(n, 3).cpu()),
                dict(count=sph.count.long()),
                dict(tri_draw=mesh.tri_draw[:-1])):
        with pytest.raises(ValueError):
            call(**bad)
    a = call()
    b = call(o=origin.expand(n, 3).contiguous())
    c = call(o=torch.cat([origin.expand(n, 3)] * 2, 1)[:, 3:])
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, c):
        assert _bits_differ(y, x) is None and _bits_differ(z, x) is None


@functools.lru_cache(maxsize=None)
def _cull_queries(case):
    """[(origin, direction, t_init, cmin, cmax, ray_block, tris)] of each
    cull case: every query of one 512^2 bunny frame, the same less its last
    ray (a ragged last block at every ray block), the 5 shadow queries of
    one lit 512^2 bunny NEE+MIS frame (``chip_smoke.py``'s scenes and
    capture), the seeded tie-heavy and signed-zero queries, and the CPU
    tests' CULL_CASES on the card."""
    import chip_smoke
    if case in CULL_CASES:
        return [cull_case(case, "cuda")]
    if case == "bunny-ragged":
        return [(o[:-1], d[:-1], t0[:-1], cmin, cmax, rb, tris)
                for o, d, t0, cmin, cmax, rb, tris in _cull_queries("bunny")]
    if case in ("bunny", "lit-bunny-shadow"):
        scene, cam = bunny_gltf_scene(device="cuda")
        mats = camera_matrices(cam, 1.0)
        cfg = RenderConfig(**chip_smoke.BUNNY)
        if case == "bunny":
            return chip_smoke.sweep_inputs(scene, mats, cfg)
        return chip_smoke.sweep_inputs(chip_smoke.lit_bunny_scene(), mats,
                                       cfg.replace(**chip_smoke.NEE))[1::2]
    if case == "tie-heavy":
        o, d, t0, tris, cmin, cmax = tie_heavy_query(65536, 32, seed=7,
                                                     device="cuda")
    else:
        o, d, t0, tris, cmin, cmax = signed_zero_query(
            65536, 32, seed=11, device="cuda", variant="mt")
    return [(o, d, t0, cmin, cmax, cluster.RAY_BLOCK, tris)]


def _float_bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.gpu
@pytest.mark.parametrize("ray_block", [None, 2048, 65536],
                         ids=["query", "rb2048", "rb65536"])
@pytest.mark.parametrize("case", ["bunny", "bunny-ragged", "lit-bunny-shadow",
                                  "tie-heavy", "signed-zero"]
                         + [f"cpu-{k}" for k in CULL_CASES])
def test_cull_kernel_equals_plain_cull(case, ray_block):
    """C1 against ``cull_order_plain`` on every query of the case, at the
    query's ray block and re-culled at 2048 and 65,536: nact, clist
    and prev bit for bit, the sorted entries and rays as floats (C1 gives
    +0.0 for -0.0); B1 on both sets of inputs bit for bit in payload and
    visits; ``cluster_sweep`` launches C1 once and counts the query's
    lanes as ``cull.lanes``."""
    _need_card()
    for o, d, t0, cmin, cmax, rb, tris in _cull_queries(
            case.removeprefix("cpu-")):
        rb = ray_block or rb
        got = cluster.cluster_cull_kernel(o, d, t0, cmin, cmax, rb)
        want = cluster.cull_order_plain(o, d, t0, cmin, cmax, rb)
        for name, g, w in zip(("nact", "clist", "bt0", "rays", "prev"), got,
                              want):
            same = (torch.equal(g, w) if name in ("bt0", "rays")
                    else torch.equal(_float_bits(g), _float_bits(w)))
            assert g.shape == w.shape and same, name
        vk = torch.zeros_like(got[0])
        vp = torch.zeros_like(vk)
        pk = cluster.cluster_sweep_kernel(*got, tris, vk)
        pp = cluster.cluster_sweep_kernel(*want, tris, vp)
        assert torch.equal(_float_bits(pk), _float_bits(pp))
        assert torch.equal(vk, vp)
        before = launches.read_counts()["C1"]
        with profiling.counting() as counts:
            pay = cluster.cluster_sweep(o, d, t0, tris, cmin, cmax,
                                        ray_block=rb)
        assert launches.read_counts()["C1"] == before + 1
        assert counts["cull.lanes"] == d.shape[0]
        assert torch.equal(_float_bits(pay),
                           _float_bits(pp.view(-1, 16)[:d.shape[0]]))


@pytest.mark.gpu
def test_cull_kernel_takes_tables_past_shared_memory():
    """At CULL_SHARED_CLUSTERS clusters (its sort keys in 64 KB of shared
    memory) and past it (its keys in a scratch of blocks x clusters in
    device memory), ``cluster_sweep`` culls in one launch of C1, counts
    the query's lanes as ``cull.lanes`` and gives the plain path's payload;
    C1's five outputs equal the twin's."""
    _need_card()
    for C in (cluster.CULL_SHARED_CLUSTERS, cluster.CULL_SHARED_CLUSTERS + 1,
              10000):
        o, d, t0, tris, cmin, cmax = tie_heavy_query(4095, C, seed=13,
                                                     device="cuda")
        before = launches.read_counts()["C1"]
        with profiling.counting() as counts:
            got = cluster.cluster_sweep(o, d, t0, tris, cmin, cmax)
        assert launches.read_counts()["C1"] == before + 1
        assert counts["cull.lanes"] == 4095
        plain = cluster.cull_order_plain(o, d, t0, cmin, cmax)
        kern = cluster.cluster_cull_kernel(o, d, t0, cmin, cmax)
        for name, g, w in zip(("nact", "clist", "bt0", "rays", "prev"), kern,
                              plain):
            same = (torch.equal(g, w) if name in ("bt0", "rays")
                    else torch.equal(_float_bits(g), _float_bits(w)))
            assert g.shape == w.shape and same, (C, name)
        want = cluster.cluster_sweep_kernel(*plain, tris)
        assert torch.equal(_float_bits(got),
                           _float_bits(want.view(-1, 16)[:4095]))


@pytest.mark.gpu
def test_cull_kernel_wrapper_rejects_bad_inputs():
    """C1's wrapper refuses CPU tensors and inputs off its table, naming
    the input."""
    _need_card()
    o, d, t0, _, cmin, cmax = tie_heavy_query(1024, 4, seed=1, device="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cluster.cluster_cull_kernel(o.cpu(), d.cpu(), t0.cpu(), cmin.cpu(),
                                    cmax.cpu())
    with pytest.raises(ValueError, match="t_init"):
        cluster.cluster_cull_kernel(o, d, t0.double(), cmin, cmax)
    with pytest.raises(ValueError, match="cmax"):
        cluster.cluster_cull_kernel(o, d, t0, cmin, cmax[:, :2])
