"""Port vs JAX package: the cluster-sweep module (kernels/cluster.py).

The JAX sweep runs its Pallas kernel in interpret mode, as the JAX package's
own tests do; the port runs the kernel's plain twin (CPU tensors).  Scene:
``bunny_like_scene(3)`` (1,280 triangles, 11 clusters), 4,096 random rays
aimed at the mesh, a quarter of them with a finite search bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wc_path_tracer_tpu.kernels import cluster as jcluster
from wc_path_tracer_tpu.models.procedural import bunny_like_scene as j_bunny

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.kernels import cluster, launches
from wc_path_tracer_tpu_torch.models.procedural import (bunny_like_scene,
                                                         signed_zero_query,
                                                         tie_heavy_query)
from wc_path_tracer_tpu_torch.ops import intersect as ix
from wc_path_tracer_tpu_torch.render.renderer import Renderer
from wc_path_tracer_tpu_torch.utils import profiling
from cull_cases import CULL_CASES, cull_case

torch.set_num_threads(2)

R = 4096
KINF = cluster.KINF


@pytest.fixture(scope="module")
def case():
    jscene, _ = j_bunny(3)
    tscene, _ = bunny_like_scene(3, device="cpu")
    r = np.random.default_rng(0)
    dirn = r.normal(size=(R, 3))
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    o = (np.array([0.0, 1.0, 0.0]) + 3.0 * dirn).astype(np.float32)
    d = (np.array([0.0, 1.0, 0.0]) + 0.6 * r.normal(size=(R, 3)) - o)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_init = np.full(R, KINF, np.float32)
    some = r.random(R) < 0.25
    t_init[some] = r.uniform(1.5, 3.5, some.sum()).astype(np.float32)
    jt = jcluster.build_cluster_tables(jscene.mesh)
    tt = cluster.build_cluster_tables(tscene.mesh)
    return dict(jscene=jscene, tscene=tscene, o=o, d=d, t_init=t_init,
                jt=jt, tt=tt)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_cluster_tables_and_vertex_slabs_bit_exact(case):
    assert case["tt"][0].shape == (11 * 16, 128)
    for got, want in zip(case["tt"], case["jt"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        cluster.vertex_slabs(case["tscene"].mesh).numpy(),
        np.asarray(jcluster.vertex_slabs(case["jscene"].mesh)))


@pytest.mark.parametrize("ray_block", [512, 128])
def test_cull_matches(case, ray_block):
    """The port's cull is the JAX package's over the live clusters; an
    all-dead cluster's inverted box, which the JAX package's slab test
    lets every ray enter at t0 = -inf, is entered by no ray."""
    o, d, t0 = case["o"], case["d"], case["t_init"]
    RB = R // ray_block
    jcmin, jcmax = (np.asarray(x) for x in case["jt"][1:])
    live = np.all(jcmin <= jcmax, axis=1)
    assert 0 < live.sum() < live.size
    jb, jl = jcluster._cull(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0),
                            jnp.asarray(jcmin[live]), jnp.asarray(jcmax[live]),
                            RB, ray_block)
    want_b = np.full((RB, live.size), KINF, np.float32)
    want_b[:, live] = np.asarray(jb)
    tb, tl = cluster._cull(_t(o), _t(d), _t(t0), *case["tt"][1:], RB,
                           ray_block)
    np.testing.assert_array_equal((tb < KINF).sum(1).numpy(),
                                  (want_b < KINF).sum(1))
    np.testing.assert_allclose(tb.numpy(), want_b, rtol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    assert np.all(np.isfinite(tl.numpy()))


def test_grouped_cull_matches_direct(case, monkeypatch):
    o, d, t0 = (_t(case[k]) for k in ("o", "d", "t_init"))
    direct = cluster._cull(o, d, t0, *case["tt"][1:], R // 512, 512)
    monkeypatch.setattr(cluster, "CULL_MATERIALIZE_ELEMS", 3 * 512 * 11)
    grouped = cluster._cull(o, d, t0, *case["tt"][1:], R // 512, 512)
    for g, w in zip(grouped, direct):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("RB, C, want", [
    (512, 171, 512),     # the 512^2 bunny: 44.8 M elements, one piece
    (512, 2731, 32),     # 327,680 triangles: 16 chunks of 16,384 rays
    (3, 50000, 1),       # two ray blocks are above the limit
])
def test_cull_chunk_blocks(RB, C, want):
    G = cluster.cull_chunk_blocks(RB, C, 512)
    assert G == want and RB % G == 0


def _assert_payload_matches(got, want):
    """Slot ids exact; t and the copied coordinates within rtol 1e-6."""
    np.testing.assert_array_equal(got[:, 11], want[:, 11])
    assert (got[:, 11] >= 0).sum() > len(got) // 4
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6)
    np.testing.assert_array_equal(got[:, 1:11], want[:, 1:11])
    np.testing.assert_array_equal(got[:, 12:], want[:, 12:])


@pytest.mark.parametrize("n_rays", [R, 1000])
def test_plain_twin_matches_jax_kernel(case, n_rays):
    o, d, t0 = (case[k][:n_rays] for k in ("o", "d", "t_init"))
    want = np.asarray(jcluster.cluster_sweep(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0), *case["jt"],
        interpret=True))
    got = cluster.cluster_sweep(_t(o), _t(d), _t(t0), *case["tt"],
                                block_fn=cluster.cluster_sweep_plain).numpy()
    _assert_payload_matches(got, want)


def test_sweep_reference_agrees_with_both(case):
    o, d, t0 = (case[k] for k in ("o", "d", "t_init"))
    ref = cluster.sweep_reference(_t(o), _t(d), _t(t0), *case["tt"]).numpy()
    jref = np.asarray(jcluster.sweep_reference(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0), *case["jt"]))
    twin = cluster.cluster_sweep(_t(o), _t(d), _t(t0), *case["tt"]).numpy()
    _assert_payload_matches(ref, jref)
    _assert_payload_matches(twin, ref)


def test_plain_twin_visits_and_early_exit(case):
    """The twin reports the clusters each block visited, and stopping early
    changes no winner against the full sweep of every active cluster.
    Coherent camera-like rays that all hit the mesh (row-major 64 x 64
    grid), so blocks can stop before their last cluster."""
    u, v = np.meshgrid(np.linspace(-0.2, 0.2, 64), np.linspace(-0.2, 0.2, 64))
    d = np.stack([u, v, -np.ones_like(u)], -1).reshape(-1, 3)
    d = _t((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    o = torch.tensor([[0.0, 1.0, 3.0]]).expand(R, 3).contiguous()
    t0 = torch.full((R,), KINF)
    seen = {}

    def block_fn(nact, clist, bt0, rays, prev, tris):
        visits = torch.zeros(nact.shape, dtype=torch.int32)
        out = cluster.cluster_sweep_plain(nact, clist, bt0, rays, prev, tris,
                                          visits)
        full = cluster.cluster_sweep_plain(
            nact, clist, torch.full_like(bt0, -KINF), rays, prev, tris)
        seen.update(nact=nact, visits=visits, out=out, full=full)
        return out

    cluster.cluster_sweep(o, d, t0, *case["tt"], block_fn=block_fn)
    assert torch.all(seen["visits"] <= seen["nact"])
    assert torch.all(seen["visits"] >= (seen["nact"] > 0).int())
    assert int(seen["visits"].sum()) < int(seen["nact"].sum())
    torch.testing.assert_close(seen["out"], seen["full"], rtol=0, atol=0)


@pytest.mark.parametrize("ray_block", [512, 2048, 8192])
def test_tie_heavy_twin_equals_jax_kernel(ray_block):
    """Exact t-ties within and across clusters (``tie_heavy_query``): the
    twin's payload equals the JAX kernel's bit for bit, slot ids included,
    so both give a tie to the lowest lane of the first-visited cluster."""
    q = tie_heavy_query(4096, 12, seed=3, device="cpu")
    got = cluster.cluster_sweep(*q, ray_block=ray_block)
    want = np.asarray(jcluster.cluster_sweep(
        *(jnp.asarray(x.numpy()) for x in q), interpret=True,
        ray_block=ray_block))
    np.testing.assert_array_equal(got.numpy(), want)
    # the ties are real: the global first minimum picks another copy on
    # many rays, always at the same t
    ref = cluster.sweep_reference(*q)
    differ = got[:, 11] != ref[:, 11]
    assert int(differ.sum()) > 200
    assert torch.equal(got[differ, 0], ref[differ, 0])


def test_kernel_wrappers_take_ray_blocks_up_to_4096(case):
    """Both sweep wrappers take every ray block the config accepts: at
    2048, 4096 and 8192 the same closest t and hits as at 512 (a
    cross-cluster t-tie may go to another copy under another block
    composition)."""
    o, d, t0 = (_t(case[k][:600]) for k in ("o", "d", "t_init"))
    tw, cmin, cmax, mat = cluster.build_cluster_tables_mxu(case["tscene"].mesh)
    for variant, tables, kw in (("mt", case["tt"], {}),
                                ("mxu", (tw, cmin, cmax), dict(mat_tbl=mat))):
        want = cluster.cluster_sweep(o, d, t0, *tables, variant=variant, **kw)
        for rb in (2048, 4096, 8192):
            got = cluster.cluster_sweep(o, d, t0, *tables, ray_block=rb,
                                        variant=variant, **kw)
            assert torch.equal(got[:, 0], want[:, 0])
            assert torch.equal(got[:, 11] >= 0, want[:, 11] >= 0)


@pytest.mark.parametrize("ray_block", [8, 512, 1000, 2048, 4096, 8192, 16384,
                                       65536, 100000])
def test_sweep_layout_holds_every_ray_block(ray_block):
    """(CTAs, threads per ray, passes) fit a thread block cluster (at most 8
    CTAs of 1,024 threads) and cover every ray of the block; one pass up to
    8,192 rays, and the 512-ray main path keeps 4 CTAs x 4 threads."""
    ctas, groups, passes = cluster.sweep_layout(ray_block)
    per_cta = -(-ray_block // (ctas * passes))
    assert 1 <= ctas <= 8 and groups in (1, 2, 4, 8)
    assert per_cta * groups <= 1024
    assert ctas * passes * per_cta >= ray_block
    assert (passes == 1) == (ray_block <= 8192)
    assert cluster.sweep_layout(512) == (4, 4, 1)


def test_signed_zero_twin_equals_jax_kernel():
    """Rays parallel to axis-aligned triangles, origins in their planes and
    hits on their edges (``signed_zero_query``): the twin's payload equals
    the JAX kernel's bit for bit."""
    q = signed_zero_query(2048, 6, seed=5, device="cpu", variant="mt")
    got = cluster.cluster_sweep(*q, ray_block=256)
    want = np.asarray(jcluster.cluster_sweep(
        *(jnp.asarray(x.numpy()) for x in q), interpret=True, ray_block=256))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got[:, 11] >= 0).sum()) > 500


def test_kernel_wrapper_runs_the_twin_on_cpu(case):
    before = launches.read_counts()["B1"]
    o, d, t0 = (_t(case[k][:600]) for k in ("o", "d", "t_init"))
    got = cluster.cluster_sweep(o, d, t0, *case["tt"])
    want = cluster.cluster_sweep(o, d, t0, *case["tt"],
                                 block_fn=cluster.cluster_sweep_plain)
    assert torch.equal(got, want)
    assert launches.read_counts()["B1"] == before


@pytest.mark.parametrize("name", list(CULL_CASES))
def test_cull_order_plain_orders_each_block(name):
    """``cull_order_plain``, the twin C1 must equal, on axis-aligned rays
    with signed zeros, origins on box faces, all-dead clusters, disabled
    lanes, a ragged last block, 1 and 161 clusters, and exact entry ties:
    nact counts each block's entered clusters, each block's list is a
    permutation of the clusters in C1's order (by entry, -0.0 equal to
    +0.0, then by cluster id: the stable argsort), and ``rays`` and
    ``prev`` pack the rays padded with ray 0."""
    q = cull_case(name)
    nact, clist, bt0, rays, prev = cluster.cull_order_plain(*q[:6])
    o, d, t0, cmin, cmax, rb, _ = q
    RB, C = bt0.shape
    R = o.shape[0]
    assert RB == -(-R // rb) and rays.shape == prev.shape == (RB, rb, 16)
    assert nact.dtype == clist.dtype == torch.int32
    assert torch.equal(nact, (bt0 < KINF).sum(1, dtype=torch.int32))
    pad = torch.cat([torch.arange(R), torch.zeros(RB * rb - R,
                                                  dtype=torch.long)])
    rows = rays.view(-1, 16)
    assert torch.equal(rows[:, 0:3], o[pad]) and torch.equal(rows[:, 3:6],
                                                              d[pad])
    assert torch.equal(rows[:, 6], t0[pad])
    assert not bool(rows[:, 8:].any())
    want_prev = torch.zeros_like(rows)
    want_prev[:, 0], want_prev[:, 11] = t0[pad], -1.0
    assert torch.equal(prev.view(-1, 16), want_prev)
    # a ray enters a live box it meets ahead of it and before its bound;
    # the block's entry is its rays' least, t_lim a ray's farthest exit
    t0s, t1s = ix.ray_box_sweep(o[pad], 1.0 / d[pad], cmin, cmax)
    live = torch.all(cmin <= cmax, dim=1)
    enter = (t0s <= t1s) & (t1s >= 0) & (t0s < t0[pad][:, None]) & live
    block_t0 = torch.where(enter, t0s, KINF).view(RB, rb, C).amin(1)
    assert torch.equal(torch.gather(block_t0, 1, clist.long()), bt0)
    assert torch.equal(rows[:, 7], torch.where(enter, t1s, -KINF).amax(1))
    key = bt0 + 0.0                      # -0.0 + 0.0 is +0.0
    ids = clist.long()
    assert torch.equal(ids.sort(dim=1).values,
                       torch.arange(C).expand(RB, C))
    assert bool(torch.all((key[:, :-1] < key[:, 1:])
                          | ((key[:, :-1] == key[:, 1:])
                             & (ids[:, :-1] < ids[:, 1:]))))
    # each case holds what it is named for
    if name == "grid":
        assert bool(torch.isnan(t0s).any()) and bool((d == 0).any())
        assert bool(torch.signbit(d[d == 0]).any())
        assert int((key[:, 1:] == key[:, :-1]).sum()) > 0
    if name == "dead-clusters":
        active = torch.arange(C) < nact[:, None]
        dead = torch.isin(clist, torch.tensor([0, 5, 6, 23],
                                              dtype=torch.int32))
        assert not bool((active & dead).any()) and int(nact.max()) > 0
    if name == "disabled-lanes":
        assert bool((t0 == -KINF).any())
    if name == "signed-zero-entries":
        zero = bt0 == 0.0
        assert bool((zero & torch.signbit(bt0)).any(1).all())
        assert bool((zero & ~torch.signbit(bt0)).any(1).all())
        assert torch.equal(clist[:, :C], torch.arange(
            C, dtype=torch.int32).expand(RB, C))


def test_sweep_culls_through_the_kernel_where_it_runs(monkeypatch):
    """Where the rays lie on the card, each sweep query of a ``Renderer``
    frame culls in one call of C1's entry, over the lanes the query is
    handed (``cull.lanes`` equals ``intersect.lanes``); the image is the
    plain path's, bit for bit.  On the CPU ``cull.lanes`` stays 0."""
    scene, cam = bunny_like_scene(2, device="cpu")
    cfg = RenderConfig(width=16, height=16, max_bounces=2)
    plain = Renderer(scene, cam, cfg, device="cpu")
    plain.step(1)
    with profiling.counting() as plain_counts:
        plain.step(1)
    assert "cull.lanes" in profiling.COUNTERS
    assert plain_counts.get("cull.lanes", 0) == 0
    calls = []

    def stub(origin, direction, t_init, cmin, cmax, ray_block):
        calls.append(direction.shape[0])
        return cluster.cull_order_plain(origin, direction, t_init, cmin,
                                        cmax, ray_block)

    monkeypatch.setattr(cluster, "cluster_cull_kernel", stub)
    monkeypatch.setattr(cluster, "on_card", lambda t: True)
    r = Renderer(scene, cam, cfg, device="cpu")
    r.step(1)
    assert len(calls) == cfg.max_bounces + 1
    with profiling.counting() as counts:
        r.step(1)
    assert torch.equal(r.image, plain.image)
    assert len(calls) == 2 * (cfg.max_bounces + 1)
    assert counts.pop("cull.lanes") == counts["intersect.lanes"] \
        == sum(calls[cfg.max_bounces + 1:])
    assert counts == plain_counts
