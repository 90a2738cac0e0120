"""Port vs JAX package: the BVH walks (kernels/traversal.py) and the
"pallas" / "wavefront" renderers (render/wavefront.py).

The JAX packet kernel runs in Pallas interpret mode and its XLA walks as
they are, as the JAX package's own tests run them; the port runs its plain
walks (CPU tensors).  Soups come from ``tests/test_render_bvh.py``'s
builders and reach the port through ``scene_from_numpy``.

Tolerances: winner offsets are bit-exact (the walks visit the same
triangles and keep the same strict-``<`` winner); ``t`` within rtol 1e-6
(XLA-CPU contracts multiply-adds into FMAs, the port rounds every
product); hit records within rtol 1e-5 / atol 1e-6; frames with
test_torch_render.py's outlier criterion.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wc_path_tracer_tpu.kernels.traversal import packet_bvh_intersect
from wc_path_tracer_tpu.models import procedural as jproc
from wc_path_tracer_tpu.render import wavefront as jwavefront
from wc_path_tracer_tpu.scene import camera as jcamera
from wc_path_tracer_tpu.scene.types import (MATERIAL_LAMBERTIAN,
                                            SceneBuilder as JSceneBuilder)
from wc_path_tracer_tpu.utils.config import RenderConfig as JConfig

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.kernels import launches, traversal
from wc_path_tracer_tpu_torch.models import procedural
from wc_path_tracer_tpu_torch.render import dispatch, golden, wavefront
from wc_path_tracer_tpu_torch.scene import camera, types

from test_render_bvh import random_rays, random_soup_scene
from test_torch_render import _assert_images_close
from test_torch_scene import jax_leaves

torch.set_num_threads(2)

KINF = np.float32(3.402823466e38)


def _port(jscene):
    return types.scene_from_numpy(jax_leaves(jscene),
                                  jscene.mesh.max_leaf_tris, "cpu")


def _mesh_dict(mesh):
    return {k: getattr(mesh, k) for k in (
        "vertices", "bvh_min", "bvh_max", "bvh_left", "bvh_count", "indices",
        "draw_node_offset", "draw_index_offset", "draw_vertex_offset",
        "draw_count")}


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _soup(n_tris, seed, n_spheres=0):
    jscene = random_soup_scene(n_tris=n_tris, n_spheres=n_spheres, seed=seed)
    return jscene, _port(jscene)


@functools.lru_cache(maxsize=None)
def _jax_packet(n_tris, seed):
    """The JAX packet kernel (interpret mode) on a soup's 1024 seeded rays
    -> (o, d, t_init, t, off) as numpy."""
    jscene, _ = _soup(n_tris, seed)
    o, d = random_rays(1024, seed + 7)
    t_init = jnp.full((1024,), KINF)
    t_p, off_p = packet_bvh_intersect(o, d, t_init, _mesh_dict(jscene.mesh),
                                      max_leaf_tris=jscene.mesh.max_leaf_tris,
                                      interpret=True)
    return tuple(np.asarray(x) for x in (o, d, t_init, t_p, off_p))


@pytest.mark.parametrize("n_tris,seed", [(16, 0), (200, 2)])
def test_stack_walk_matches_jax(n_tris, seed):
    jscene, tscene = _soup(n_tris, seed)
    o, d, t_init, t_p, off_p = _jax_packet(n_tris, seed)
    t_x, off_x = jwavefront._bvh_closest_tri(jscene, jnp.asarray(o),
                                             jnp.asarray(d),
                                             jnp.asarray(t_init))
    counts = torch.zeros((1024, traversal.COUNT_COLS), dtype=torch.int32)
    t, off = traversal.bvh_walk_plain(_t(o), _t(d), _t(t_init), tscene.mesh,
                                      counts)
    off = off.numpy()
    np.testing.assert_array_equal(off, np.asarray(off_x))
    np.testing.assert_array_equal(off, np.asarray(off_p))
    hit = off >= 0
    assert hit.sum() > 10
    for want in (t_x, t_p):
        np.testing.assert_allclose(t.numpy()[hit], np.asarray(want)[hit],
                                   rtol=1e-6)
    np.testing.assert_array_equal(t.numpy()[~hit], KINF)
    # every ray pops each draw's root; inner nodes entered <= popped
    popped, entered, tested = counts.numpy().T
    assert (popped >= 1).all() and (entered <= popped).all()
    assert tested.sum() >= hit.sum()


def test_stackless_walk_matches_jax():
    jscene, tscene = _soup(200, 2)
    o, d = random_rays(1024, 9)
    t_init = jnp.full((1024,), KINF)
    t_j, off_j = jwavefront._bvh_closest_tri_stackless(jscene, o, d, t_init)
    t, off = traversal.bvh_walk_stackless_plain(_t(o), _t(d), _t(t_init),
                                                tscene.mesh)
    np.testing.assert_array_equal(off.numpy(), np.asarray(off_j))
    hit = off.numpy() >= 0
    assert hit.sum() > 100
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(t_j)[hit],
                               rtol=1e-6)


def test_t_init_zero_gives_no_hits():
    _, tscene = _soup(200, 2)
    o, d = random_rays(1024, 3)
    t, off = traversal.bvh_walk_plain(_t(o), _t(d), torch.zeros(1024),
                                      tscene.mesh)
    assert (off == -1).all() and (t == 0).all()


def test_multi_draw_bank():
    b = JSceneBuilder()
    m = b.add_material(MATERIAL_LAMBERTIAN, albedo=(0.5, 0.5, 0.5))
    for z in (-2.0, -4.0):
        b.add_mesh(np.array([[-1, -1, z], [1, -1, z], [0, 1, z]], np.float32),
                   np.array([0, 1, 2], np.int32), tri_material=m)
    jscene = b.build()
    tscene = _port(jscene)
    o = np.zeros((1024, 3), np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (1024, 1))
    o[512:, 2] = -3.0                    # behind the first draw's triangle
    t_j, off_j = packet_bvh_intersect(
        jnp.asarray(o), jnp.asarray(d), jnp.full((1024,), KINF),
        _mesh_dict(jscene.mesh), max_leaf_tris=jscene.mesh.max_leaf_tris,
        interpret=True)
    t, off = traversal.bvh_walk_kernel(_t(o), _t(d), torch.full((1024,), KINF),
                                       tscene.mesh)
    np.testing.assert_array_equal(off.numpy(), np.asarray(off_j))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), rtol=1e-6)
    np.testing.assert_allclose(t.numpy()[:512], 2.0, atol=1e-6)
    np.testing.assert_allclose(t.numpy()[512:], 1.0, atol=1e-6)
    assert (off.numpy()[:512] == 0).all() and (off.numpy()[512:] == 3).all()


def test_kernel_wrapper_runs_the_plain_walk_on_cpu():
    _, tscene = _soup(200, 2)
    o, d = (_t(x) for x in random_rays(777, 5))
    before = launches.read_counts()["B3"]
    got = traversal.bvh_walk_kernel(o, d, torch.full((777,), KINF),
                                    tscene.mesh)
    want = traversal.bvh_walk_plain(o, d, torch.full((777,), KINF),
                                    tscene.mesh)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launches.read_counts()["B3"] == before


def test_intersect_scene_pallas_full_hitrecord():
    """A ray count that is no multiple of the JAX packet (1024): the whole
    HitRecord against the JAX package's."""
    jscene, tscene = _soup(100, 4, n_spheres=3)
    o, d = random_rays(1000, 9)
    cfg = dict(width=8, height=8)
    want = jwavefront.intersect_scene_pallas(jscene, o, d, JConfig(**cfg),
                                             interpret=True)
    got = wavefront.intersect_scene_pallas(tscene, _t(o), _t(d),
                                           RenderConfig(**cfg))
    hit = np.asarray(want.hit)
    assert 100 < hit.sum() < 1000
    for f in ("hit", "front", "material"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("t", "p", "normal"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit],
                                   rtol=1e-5, atol=1e-6, err_msg=f)


FRAME_CFG = dict(width=32, height=32, samples=1, max_bounces=2)


@functools.lru_cache(maxsize=None)
def _bunny_split():
    """bunny_like_scene(2) split into draws of at most 128 triangles (3+
    draws, the multi-draw layout the "pallas" path walks)."""
    jscene, jcam = jproc.bunny_like_scene(2, max_blas_tris=128)
    tscene, _ = procedural.bunny_like_scene(2, max_blas_tris=128,
                                            device="cpu")
    jm = jcamera.camera_matrices(jcam, 1.0)
    tm = camera.matrices_from_numpy(np.asarray(jm.inverse_projection),
                                    np.asarray(jm.inverse_view),
                                    np.asarray(jm.position), "cpu")
    return jscene, jm, tscene, tm


def test_pallas_frame_matches_jax():
    jscene, jm, tscene, tm = _bunny_split()
    assert int(tscene.mesh.draw_count) >= 3
    want = np.asarray(jwavefront.render_frame_pallas(
        jscene, jm, JConfig(**FRAME_CFG), 1))
    fn = dispatch.get_render_frame("pallas", tscene, RenderConfig(**FRAME_CFG))
    got = fn(tscene, tm, RenderConfig(**FRAME_CFG), 1).numpy()
    assert want.std() > 0.01
    _assert_images_close(got, want)


@pytest.mark.parametrize("walk", ["stack", "stackless"])
def test_wavefront_frame_matches_jax(walk):
    jscene, jm, tscene, tm = _bunny_split()
    cfg = dict(FRAME_CFG, traversal=walk)
    want = np.asarray(jax.jit(jwavefront.render_frame, static_argnames="cfg")(
        jscene, jm, JConfig(**cfg), 1))
    fn = dispatch.get_render_frame("wavefront", tscene, RenderConfig(**cfg))
    got = fn(tscene, tm, RenderConfig(**cfg), 1).numpy()
    _assert_images_close(got, want)


def test_dispatch_names():
    _, _, tscene, _ = _bunny_split()
    cfg = RenderConfig(**FRAME_CFG)
    assert dispatch.get_render_frame("pallas", tscene, cfg).backend \
        == "pallas"
    assert dispatch.get_intersect_fn("pallas", tscene, cfg) \
        is wavefront.intersect_scene_pallas
    assert dispatch.get_render_frame("wavefront", tscene, cfg).backend \
        == "wavefront"
    assert dispatch.get_intersect_fn("wavefront", tscene, cfg) \
        is wavefront.intersect_scene_bvh
    with pytest.raises(ValueError, match="unknown renderer"):
        dispatch.get_render_frame("bvh", tscene, cfg)


def test_stack_depth_check():
    """The builder's trees fit the 64-slot stack; a 70-level chain, or a
    cyclic table, is refused before any walk starts."""
    _, tscene = _soup(200, 2)
    assert 2 <= traversal.tree_depth(tscene.mesh) <= 33
    traversal.check_stack_depth(tscene.mesh)
    N = tscene.mesh.bvh_left.shape[0]
    chain_left = torch.zeros(N, dtype=torch.int32)
    chain_count = torch.full((N,), 3, dtype=torch.int32)
    chain_left[0:140:2] = torch.arange(1, 141, 2, dtype=torch.int32)
    chain_count[0:140:2] = 0        # node 2k inner, children 2k+1 (leaf), 2k+2
    assert N > 142
    chain = dataclasses.replace(tscene.mesh, bvh_left=chain_left,
                                bvh_count=chain_count)
    assert traversal.tree_depth(chain) == traversal.STACK_DEPTH + 1
    with pytest.raises(ValueError, match="more than 64 levels"):
        traversal.check_stack_depth(chain)
    cyclic = dataclasses.replace(tscene.mesh, bvh_count=torch.zeros_like(
        chain_count), bvh_left=torch.zeros_like(chain_left))
    with pytest.raises(ValueError, match="more than 64 levels"):
        traversal.check_stack_depth(cyclic)
    scene = types.Scene(tscene.materials, tscene.spheres, chain)
    with pytest.raises(ValueError, match="more than 64 levels"):
        wavefront.make_intersect_fn_pallas(scene)
    o, d = (_t(x) for x in random_rays(8, 1))
    t0 = torch.full((8,), float(KINF))
    for walk in (traversal.bvh_walk_plain, traversal.bvh_walk_kernel):
        with pytest.raises(ValueError, match="more than 64 levels"):
            walk(o, d, t0, chain)


def test_stack_depth_check_runs_once_per_bank(monkeypatch):
    """A bank that passed is not walked on the host again; replacing one of
    its tables makes the next walk check again."""
    _, tscene = _soup(16, 0)
    mesh = dataclasses.replace(tscene.mesh)
    calls = []
    depth = traversal.tree_depth
    monkeypatch.setattr(traversal, "tree_depth",
                        lambda m: calls.append(1) or depth(m))
    o, d = (_t(x) for x in random_rays(8, 1))
    t0 = torch.full((8,), float(KINF))
    for _ in range(3):
        traversal.bvh_walk_kernel(o, d, t0, mesh)
    assert len(calls) == 1
    mesh.bvh_count = mesh.bvh_count.clone()
    traversal.check_stack_depth(mesh)
    assert len(calls) == 2


# -- the kernel's tables and data path (walk_tables, bvh_walk_records_plain)

def _bank(name):
    """A mesh bank (CPU) by name: seeded soups, the split bunny-like scene
    (3+ draws), two one-triangle draws, the seeded tie-heavy and
    signed-zero banks -> (mesh, origin, direction, t_init)."""
    if name.startswith("soup"):
        n_tris, seed = {"soup16": (16, 0), "soup200": (200, 2)}[name]
        o, d, t_init, _, _ = _jax_packet(n_tris, seed)
        return _soup(n_tris, seed)[1].mesh, _t(o), _t(d), _t(t_init)
    if name == "split bunny":
        mesh = _bunny_split()[2].mesh
        o, d = (_t(x) for x in random_rays(1024, 31))
        o = o + torch.tensor([0.0, 1.0, 4.0])
        return mesh, o, d, torch.full((1024,), float(KINF))
    if name == "two draws":
        b = types.SceneBuilder()
        for z in (-2.0, -4.0):
            b.add_mesh(np.array([[-1, -1, z], [1, -1, z], [0, 1, z]],
                                np.float32), np.array([0, 1, 2], np.int32))
        o = np.zeros((64, 3), np.float32)
        o[32:, 2] = -3.0
        d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (64, 1))
        return (b.build("cpu").mesh, _t(o), _t(d),
                torch.full((64,), float(KINF)))
    make = (procedural.tie_heavy_query if name == "tie-heavy"
            else procedural.signed_zero_query)
    o, d, t_init, mesh = make(2048, 4, seed=3, device="cpu", variant="bank")
    return mesh, o, d, t_init


BANKS = ["soup16", "soup200", "split bunny", "two draws", "tie-heavy",
         "signed-zero"]


@pytest.mark.parametrize("name", BANKS)
def test_walk_tables_are_exact(name):
    """Every record, followed from its draw's root as the kernel follows
    it, holds its node's boxes and vertices bit for bit; inner references
    map back to their nodes (each record reached once), leaf references
    (-2 - first index) to the leaf's first index and count."""
    mesh = _bank(name)[0]
    tables = traversal.walk_tables(mesh)
    assert traversal.walk_tables(mesh) is tables       # packed once
    f32 = (lambda x: x.numpy().view(np.int32))
    nodes, tris, draws = (f32(x) for x in (tables.nodes, tables.tris,
                                           tables.draws))
    bmin, bmax, verts = (f32(x) for x in (mesh.bvh_min, mesh.bvh_max,
                                          mesh.vertices))
    left, count, indices = (x.numpy() for x in (mesh.bvh_left,
                                                mesh.bvh_count, mesh.indices))
    nd = int(mesh.draw_count)
    assert draws.shape == (nd, traversal.DRAW_COLS)
    assert nodes.shape[1] == traversal.NODE_COLS
    reached = []

    def check(node, node_off, index_off, vert_off, ref, cnt):
        assert cnt == count[node]
        if cnt == 0:
            reached.append(ref)
            rec = nodes[ref]
            lc = node_off + left[node]
            for j, c in enumerate((lc, lc + 1)):
                np.testing.assert_array_equal(rec[6 * j:6 * j + 3], bmin[c])
                np.testing.assert_array_equal(rec[6 * j + 3:6 * j + 6],
                                              bmax[c])
                check(c, node_off, index_off, vert_off, rec[12 + j],
                      rec[14 + j])
            return
        i0 = -2 - ref
        assert i0 == index_off + left[node] and i0 % 3 == 0
        ntri = (cnt + 2) // 3
        for k in range(ntri):
            rec = tris[i0 // 3 + k]
            assert rec[3] == ntri - k
            for j in range(3):
                np.testing.assert_array_equal(
                    rec[4 * j:4 * j + 3],
                    verts[vert_off + indices[i0 + 3 * k + j]])

    for di in range(nd):
        node_off, index_off, vert_off = (int(getattr(mesh, k)[di]) for k in (
            "draw_node_offset", "draw_index_offset", "draw_vertex_offset"))
        np.testing.assert_array_equal(draws[di, 0:3], bmin[node_off])
        np.testing.assert_array_equal(draws[di, 3:6], bmax[node_off])
        check(node_off, node_off, index_off, vert_off, draws[di, 6],
              draws[di, 7])
    assert sorted(reached) == list(range(nodes.shape[0]))
    assert tables.depth == traversal.tree_depth(mesh)


@pytest.mark.parametrize("name", BANKS)
def test_record_walk_matches_plain_walk(name):
    """The kernel's data path (carried t0, filtered pushes, triangle
    records) in plain PyTorch equals the twin on t, off and the counters,
    bit for bit; on the soups both equal the JAX packet kernel's offsets
    (interpret mode)."""
    mesh, o, d, t_init = _bank(name)
    R = o.shape[0]
    cp = torch.zeros((R, traversal.COUNT_COLS), dtype=torch.int32)
    cr = torch.zeros_like(cp)
    tp, op = traversal.bvh_walk_plain(o, d, t_init, mesh, cp)
    tr, orr = traversal.bvh_walk_records_plain(o, d, t_init, mesh, cr)
    assert torch.equal(tp, tr) and torch.equal(op, orr)
    assert torch.equal(cp, cr)
    assert int((op >= 0).sum()) > 10
    # every node pushed is popped: the roots and two per inner node entered
    nd = int(mesh.draw_count)
    assert torch.equal(cp[:, 0], nd + 2 * cp[:, 1])
    if name.startswith("soup"):
        n_tris, seed = {"soup16": (16, 0), "soup200": (200, 2)}[name]
        _, _, _, t_j, off_j = _jax_packet(n_tris, seed)
        np.testing.assert_array_equal(orr.numpy(), off_j)
        hit = off_j >= 0
        np.testing.assert_allclose(tr.numpy()[hit], t_j[hit], rtol=1e-6)


@pytest.mark.parametrize("name", ["soup200", "split bunny", "two draws"])
def test_plain_walk_marks_the_records_it_reads(name):
    """The twin's ``touched`` masks: inner nodes entered and triangle slots
    tested, by any lane.  One ray enters each node and tests each slot at
    most once, so its masks count exactly its counters; a batch's masks
    are the union of its rays' and fit the walk tables' records; with an
    alive mask, only the live lanes mark."""
    mesh, o, d, t_init = _bank(name)
    tables = traversal.walk_tables(mesh)

    def walk(idx=None, alive=None):
        sel = (lambda x: x) if idx is None else (lambda x: x[idx])
        marks = (torch.zeros(mesh.bvh_left.shape[0], dtype=torch.bool),
                 torch.zeros(mesh.indices.shape[0] // 3, dtype=torch.bool))
        cnt = torch.zeros((sel(o).shape[0], traversal.COUNT_COLS),
                          dtype=torch.int32)
        traversal.bvh_walk_plain(sel(o), sel(d), sel(t_init), mesh, cnt,
                                 alive, marks)
        return marks, cnt

    rows = list(range(0, o.shape[0], o.shape[0] // 16))
    union = None
    for r in rows:
        marks, cnt = walk([r])
        assert int(marks[0].sum()) == int(cnt[0, 1])
        assert int(marks[1].sum()) == int(cnt[0, 2])
        assert bool((mesh.bvh_count[marks[0]] == 0).all())
        union = marks if union is None else [u | m for u, m in
                                             zip(union, marks)]
    marks = walk(rows)[0]
    assert all(torch.equal(a, b) for a, b in zip(marks, union))
    (nodes, tris), cnt = walk()
    assert 0 < int(tris.sum()) <= min(int(cnt[:, 2].sum()),
                                      tables.tris.shape[0])
    assert int(nodes.sum()) <= min(int(cnt[:, 1].sum()),
                                   tables.nodes.shape[0])
    alive = torch.from_numpy(np.random.default_rng(5).random(o.shape[0])
                             < 0.5)
    live = walk(alive.nonzero().squeeze(1))[0]
    masked = walk(alive=alive)[0]
    assert all(torch.equal(a, b) for a, b in zip(masked, live))


def test_walks_take_an_alive_mask():
    """With a mask, the twin, the record walk and the wrapper walk only the
    live lanes: equal to the unmasked walk there, (t_init, -1) and zero
    counters elsewhere."""
    mesh, o, d, t_init = _bank("soup200")
    alive = torch.from_numpy(np.random.default_rng(4).random(1024) < 0.6)
    cp = torch.zeros((1024, traversal.COUNT_COLS), dtype=torch.int32)
    tp, op = traversal.bvh_walk_plain(o, d, t_init, mesh, cp)
    for walk in (traversal.bvh_walk_plain, traversal.bvh_walk_records_plain,
                 traversal.bvh_walk_kernel):
        cm = torch.full_like(cp, 7)
        tm, om = walk(o, d, t_init, mesh, cm, alive=alive)
        assert torch.equal(tm, torch.where(alive, tp, t_init))
        assert torch.equal(om, torch.where(alive, op, -1))
        assert torch.equal(cm, torch.where(alive[:, None], cp, 0))


def test_walk_tables_refuse_banks_they_cannot_pack():
    """A leaf of more than 3 x max_leaf_tris indices, a leaf that does not
    start on a triangle slot, a node reached twice and a cyclic table."""
    mesh = _bank("soup200")[0]
    count, left = mesh.bvh_count, mesh.bvh_left
    leaf = int(torch.nonzero(count > 0)[0])
    assert left[0] == 1 and count[1] == 0 and count[2] == 0
    big = count.clone()
    big[leaf] = 3 * mesh.max_leaf_tris + 3
    off = left.clone()
    off[leaf] += 1
    shared = left.clone()
    shared[2] = left[1]              # the root's children share theirs
    cyclic = torch.zeros_like(left)
    for kw, match in ((dict(bvh_count=big), "more than 3 x"),
                      (dict(bvh_left=off), "triangle slot"),
                      (dict(bvh_left=shared), "reached twice"),
                      (dict(bvh_left=cyclic, bvh_count=torch.zeros_like(
                          count)), "more than 64 levels")):
        with pytest.raises(ValueError, match=match):
            traversal.walk_tables(dataclasses.replace(mesh, **kw))


def test_pallas_frame_alive_mask_keeps_the_image():
    """The "pallas" frame walks only live lanes; bit for bit the frame of
    a walk of every lane."""
    _, _, tscene, tm = _bunny_split()
    cfg = RenderConfig(**FRAME_CFG)
    assert wavefront.intersect_scene_pallas.accepts_alive

    def every_lane(scene, origin, direction, cfg):
        return wavefront.intersect_scene_pallas(scene, origin, direction, cfg)

    seen = []

    def walk(o, d, t0, mesh, alive=None):
        seen.append(int(alive.sum()))
        return traversal.bvh_walk_plain(o, d, t0, mesh, alive=alive)

    masked = wavefront.render_frame_pallas(tscene, tm, cfg, 1)
    full = golden.render_frame(tscene, tm, cfg, 1, intersect_fn=every_lane)
    golden.render_frame(tscene, tm, cfg, 1, intersect_fn=wavefront
                        .make_intersect_fn_pallas(tscene, walk))
    assert torch.equal(masked, full)
    assert seen[0] == 32 * 32 and seen[-1] < seen[0]
