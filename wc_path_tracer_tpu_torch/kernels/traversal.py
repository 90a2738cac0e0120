"""BVH walk: closest triangle hit per ray over every draw's BVH.

Port of the JAX package's kernels/traversal.py (the Pallas packet kernel)
and of the per-lane walk in its render/wavefront.py.  On the TPU one
1024-ray packet shared a single scalar stack, because a TPU lane has no
stack of its own; a GPU thread has one, so the port walks each ray on its
own in the reference shader's order (pathTracer.comp:151-201):

- draws 0 .. draw_count-1 in turn, the best ``t`` carried across draws;
- pop a node; enter it iff its slab interval is non-empty, not behind the
  ray and starts at or before the best ``t`` (``t0 <= t1 && t1 >= 0 &&
  t0 <= t_best``);
- at a leaf, test up to ``max_leaf_tris`` triangles in
  ``ops/intersect.ray_triangle``'s operation order, keeping a hit only if
  strictly closer;
- at an inner node, push the far child, then the near one, "near" by the
  reference's distance heuristic ``t0 > 0 ? t0 : t1`` of each child.

The result is ``(t, off)``: the closest ``t`` (``t_init`` where nothing
beat it) and the winner's first-index offset into ``mesh.indices`` (-1 if
none).  It equals the TPU packet kernel's except on exact ``t`` ties.

``bvh_walk_plain`` is that walk in plain PyTorch over the bank's own
tables: the twin.  ``bvh_walk_kernel`` launches the Hopper kernel in
csrc/bvh_walk.cu on CUDA tensors and runs the twin on CPU tensors; the two
agree bit for bit in ``(t, off)`` and in the per-ray counters (both round
every product and sum separately, and visit the same nodes in the same
order).  The kernel reads the bank through ``walk_tables``: child-pair node
records, triangle records and per-draw root records, packed once per bank
from bitwise copies of its boxes and vertices.  ``bvh_walk_records_plain``
walks those records as the kernel does (entry distances carried on the
stack, pushes filtered by the slab test, leaves read from triangle
records), so the CPU tests hold the packing and the kernel's data path to
the twin.  ``bvh_walk_stackless_plain`` is the escape-link walk of the JAX
package's ``wavefront._bvh_closest_tri_stackless`` (fixed DFS order).

Every walk takes an optional ``alive`` mask: lanes outside it are not
walked and return ``(t_init, -1)`` with zero counters.

The TPU form's SMEM budgeting (``smem_chunks``,
``packet_bvh_intersect_chunked``) is not ported: the tables sit in global
memory and L2, and one launch walks every draw.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from wc_path_tracer_tpu_torch.kernels import launches
from wc_path_tracer_tpu_torch.ops import intersect as ix

STACK_DEPTH = 64   # per-ray stack slots: >= the builder's 33 levels + slack
COUNT_COLS = 3     # per-ray counters: nodes popped, inner nodes entered,
#                    triangles tested
NODE_COLS = 16     # child-pair record: 4 float4 (see walk_tables)
TRI_COLS = 12      # triangle record: 3 float4
DRAW_COLS = 8      # per-draw root record: 2 float4


def tree_depth(mesh) -> int:
    """Most levels of any live draw's BVH (a lone root counts 1), counted
    up to STACK_DEPTH + 1: a deeper (or cyclic) table returns that."""
    left = mesh.bvh_left.cpu().numpy().astype(np.int64)
    count = mesh.bvh_count.cpu().numpy()
    nd = int(mesh.draw_count)
    node = mesh.draw_node_offset[:nd].cpu().numpy().astype(np.int64)
    off = node.copy()
    depth = 0
    while node.size and depth <= STACK_DEPTH:
        depth += 1
        inner = count[node] == 0
        child = off[inner] + left[node[inner]]
        node, first = np.unique(np.concatenate([child, child + 1]),
                                return_index=True)
        off = np.concatenate([off[inner], off[inner]])[first]
    return depth


_DEPTH_TABLES = ("bvh_left", "bvh_count", "draw_node_offset", "draw_count")


def check_stack_depth(mesh) -> None:
    """Raise if a stack walk of this bank could overflow STACK_DEPTH slots.

    A walk of a tree with D levels holds at most D entries (one waiting
    sibling per level above the popped node, plus its two children).  A
    bank that passes remembers the tables it passed with, so a static scene
    pays ``tree_depth``'s host copy once; a table replaced on the bank is
    checked again (nothing in the package edits a BVH table in place)."""
    tables = tuple(getattr(mesh, k) for k in _DEPTH_TABLES)
    passed = getattr(mesh, "_stack_depth_passed", ())
    if len(passed) == len(tables) and all(
            a is b for a, b in zip(passed, tables)):
        return
    if tree_depth(mesh) > STACK_DEPTH:
        raise ValueError(f"a BVH of this scene has more than {STACK_DEPTH} "
                         f"levels; the stack walk holds at most {STACK_DEPTH}")
    mesh._stack_depth_passed = tables


# -- the kernel's tables ------------------------------------------------------

@dataclasses.dataclass
class WalkTables:
    """The bank as the kernel reads it (all float32; integer fields are
    int32 bit patterns, read back with ``.view(torch.int32)``).

    ``nodes`` (NR, 16): one child-pair record per inner node reached from a
    live draw's root, each draw's records contiguous in breadth-first order
    from its root: the left child's box (min xyz, max xyz), the right
    child's, then per child its reference -- the child's record id if it is
    inner, -2 - its bank-global first index if it is a leaf -- and its
    index count (0 = inner).
    ``tris`` (T, 12): one record per triangle slot of the bank: its three
    vertices, already rebased by its draw's vertex offset, in columns 0:3,
    4:7 and 8:11; column 3 holds how many triangles of its leaf the walk
    tests from this slot on (slots no leaf reaches are zero).
    ``draws`` (D, 8): per live draw its root's box, and its reference and
    count as a child's.
    """

    nodes: torch.Tensor
    tris: torch.Tensor
    draws: torch.Tensor
    depth: int               # levels of the deepest tree
    max_leaf_tris: int
    build_s: float           # host + device seconds of the packing


_WALK_TABLES = ("bvh_min", "bvh_max", "bvh_left", "bvh_count", "indices",
                "vertices", "draw_node_offset", "draw_index_offset",
                "draw_vertex_offset", "draw_count")


def _ints(x, device):
    """int32 values as float32 bit patterns on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)) \
        .view(torch.float32).to(device)


def _node_order(mesh):
    """One host pass over the live draws' trees, breadth first from each
    root -> (inner node ids in record order, their draws, leaf node ids,
    their draws, levels of the deepest tree, and the host copies it
    read)."""
    left = mesh.bvh_left.cpu().numpy().astype(np.int64)
    count = mesh.bvh_count.cpu().numpy().astype(np.int64)
    N = left.shape[0]
    nd = int(mesh.draw_count)
    node_off = mesh.draw_node_offset[:nd].cpu().numpy().astype(np.int64)
    seen = np.zeros(N, bool)
    depth = 0
    inner, inner_d, leaf, leaf_d = [], [], [], []
    for d in range(nd):
        frontier = node_off[d:d + 1]
        level = 0
        while frontier.size:
            if level >= STACK_DEPTH or (frontier < 0).any() \
                    or (frontier >= N).any():
                raise ValueError("walk_tables: a tree of this bank leaves "
                                 "its table or is deeper than the stack walk "
                                 "takes")
            if seen[frontier].any() or \
                    np.unique(frontier).size < frontier.size:
                raise ValueError("walk_tables: a node of this bank is reached "
                                 "twice (the tables must form trees)")
            seen[frontier] = True
            is_leaf = count[frontier] > 0
            inner.append(frontier[~is_leaf])
            inner_d.append(np.full(int((~is_leaf).sum()), d))
            leaf.append(frontier[is_leaf])
            leaf_d.append(np.full(int(is_leaf.sum()), d))
            child = node_off[d] + left[frontier[~is_leaf]]
            frontier = np.stack([child, child + 1], 1).reshape(-1)
            level += 1
        depth = max(depth, level)
    cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64))
    return (cat(inner).astype(np.int64), cat(inner_d).astype(np.int64),
            cat(leaf).astype(np.int64), cat(leaf_d).astype(np.int64), depth,
            left, count, node_off)


def _pack(mesh) -> WalkTables:
    t_start = time.perf_counter()
    check_stack_depth(mesh)
    dev = mesh.bvh_min.device
    inner, inner_d, leaf, leaf_d, depth, left, count, node_off = \
        _node_order(mesh)
    nd = node_off.shape[0]
    index_off = mesh.draw_index_offset[:nd].cpu().numpy().astype(np.int64)
    vert_off = mesh.draw_vertex_offset[:nd].cpu().numpy().astype(np.int64)
    indices = mesh.indices.cpu().numpy().astype(np.int64)
    I, V = indices.shape[0], mesh.vertices.shape[0]
    T, mlt = I // 3, int(mesh.max_leaf_tris)

    rec_of = np.full(left.shape[0], -1, np.int64)
    rec_of[inner] = np.arange(inner.shape[0])

    def child_ref(node, d):
        """(reference, index count) of each child as its parent's record
        holds it: the record id of an inner child, -2 - the bank-global
        first index of a leaf (the walk's carried form)."""
        return (np.where(count[node] == 0, rec_of[node],
                         -2 - (index_off[d] + left[node])), count[node])

    # leaves: every triangle slot each reached leaf tests, with its draw
    i0 = index_off[leaf_d] + left[leaf]
    cnt = count[leaf]
    ntri = (cnt + 2) // 3
    if (cnt > 3 * mlt).any():
        raise ValueError("walk_tables: a leaf holds more than 3 x "
                         f"max_leaf_tris = {3 * mlt} indices")
    if (i0 % 3 != 0).any() or (i0 < 0).any() or (i0 + 3 * ntri > I).any():
        raise ValueError("walk_tables: a leaf's triangles do not start on a "
                         "triangle slot inside the index table")
    k = np.arange(ntri.sum()) - np.repeat(np.cumsum(ntri) - ntri, ntri)
    slot = np.repeat(i0 // 3, ntri) + k
    voff = np.repeat(vert_off[leaf_d], ntri)
    rem = np.repeat(ntri, ntri) - k
    uniq, first = np.unique(slot, return_index=True)
    if uniq.size < slot.size:
        back = np.searchsorted(uniq, slot)
        if (voff != voff[first][back]).any() or \
                (rem != rem[first][back]).any():
            raise ValueError("walk_tables: two leaves share a triangle slot "
                             "with different draws or leaf ends")
        slot, voff, rem = uniq, voff[first], rem[first]
    vid = indices[(3 * slot[:, None] + np.arange(3)).reshape(-1)] \
        .reshape(-1, 3) + voff[:, None]
    if (vid < 0).any() or (vid >= V).any():
        raise ValueError("walk_tables: a leaf's vertex index is outside the "
                         "vertex table")

    def gather(x, ids):
        return x[torch.from_numpy(ids).to(dev)]

    # child-pair records of the inner nodes, in record order
    lchild = node_off[inner_d] + left[inner]
    rchild = lchild + 1
    (lref, lcnt), (rref, rcnt) = (child_ref(c, inner_d)
                                  for c in (lchild, rchild))
    nodes = torch.cat([
        gather(mesh.bvh_min, lchild), gather(mesh.bvh_max, lchild),
        gather(mesh.bvh_min, rchild), gather(mesh.bvh_max, rchild),
        _ints(np.stack([lref, rref, lcnt, rcnt], 1).reshape(-1, 4), dev)],
        dim=1)

    tris = torch.zeros((T, TRI_COLS), dtype=torch.float32, device=dev)
    if slot.size:
        st = torch.from_numpy(slot).to(dev)
        for j in range(3):
            tris[st, 4 * j:4 * j + 3] = gather(mesh.vertices, vid[:, j])
        tris[st, 3] = _ints(rem, dev)

    d_all = np.arange(nd)
    root_ref, root_cnt = child_ref(node_off, d_all)
    draws = torch.cat([
        gather(mesh.bvh_min, node_off), gather(mesh.bvh_max, node_off),
        _ints(np.stack([root_ref, root_cnt], 1).reshape(-1, 2), dev)], dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return WalkTables(
        nodes=nodes, tris=tris, draws=draws, depth=depth, max_leaf_tris=mlt,
        build_s=time.perf_counter() - t_start)


def walk_tables(mesh) -> WalkTables:
    """The kernel's tables of this bank (see ``WalkTables``), built on the
    bank's device on its first walk and remembered with the tables they were
    built from, as ``check_stack_depth`` remembers its check.  Raises on a
    bank it cannot pack: a tree deeper than STACK_DEPTH or cyclic, a node
    reached twice, a leaf of more than 3 x ``max_leaf_tris`` indices or
    outside the index or vertex table."""
    src = tuple(getattr(mesh, k) for k in _WALK_TABLES)
    memo = getattr(mesh, "_walk_tables", None)
    if memo is not None and len(memo[0]) == len(src) and all(
            a is b for a, b in zip(memo[0], src)):
        return memo[1]
    tables = _pack(mesh)
    mesh._walk_tables = (src, tables)
    return tables


# -- the plain walks ----------------------------------------------------------

def _draws(mesh):
    """Host list of (node_off, index_off, vert_off) of the live draws."""
    nd = int(mesh.draw_count)
    return list(zip(*(getattr(mesh, k)[:nd].tolist() for k in (
        "draw_node_offset", "draw_index_offset", "draw_vertex_offset"))))


def _leaf_tests(origin, direction, mesh, enter, count, left, index_off,
                vert_off, t_best, best, tested, seen=None):
    """Test each entered leaf's triangles in order; strict ``<`` update.
    ``seen`` (triangle slots,) bool, if given, is set at each slot tested."""
    for k in range(mesh.max_leaf_tris):
        valid = enter & (3 * k < count)
        i0 = torch.where(valid, index_off + left + 3 * k, 0)
        if seen is not None:
            seen[i0[valid] // 3] = True
        ia, ib, ic = (vert_off + mesh.indices[i0 + j].long() for j in range(3))
        t, _, _, hit = ix.ray_triangle(origin, direction, mesh.vertices[ia],
                                       mesh.vertices[ib], mesh.vertices[ic])
        upd = valid & hit & (t < t_best)
        t_best = torch.where(upd, t, t_best)
        best = torch.where(upd, i0.to(torch.int32), best)
        if tested is not None:
            tested += valid
    return t_best, best


def _masked(walk, origin, direction, t_init, mesh, counts, alive, **kw):
    """``walk`` (given ``kw``) over the lanes of ``alive`` only; the others
    get ``(t_init, -1)`` and zero counters."""
    idx = alive.nonzero().squeeze(1)
    t = t_init.detach().clone()
    off = torch.full_like(t, -1, dtype=torch.int32)
    sub = None if counts is None else torch.zeros(
        (idx.shape[0], COUNT_COLS), dtype=torch.int32, device=t.device)
    t[idx], off[idx] = walk(origin[idx], direction[idx], t_init[idx], mesh,
                            sub, **kw)
    if counts is not None:
        counts.zero_()
        counts[idx] = sub
    return t, off


def bvh_walk_plain(origin, direction, t_init, mesh, counts=None, alive=None,
                   touched=None):
    """Per-lane stack walk (the module docstring's order) in plain PyTorch:
    the kernel's twin.  origin/direction (R, 3) f32, t_init (R,) f32 ->
    (t (R,) f32, off (R,) int32).  ``counts`` (R, 3) int32, if given,
    receives each ray's nodes popped, inner nodes entered and triangles
    tested; ``alive`` (R,) bool, if given, walks only its lanes.
    ``touched``, if given, is a pair of bool tensors on the rays' device,
    (node slots,) and (index slots // 3,): it is set at every inner node
    entered and every triangle slot tested by any lane, the node and
    triangle records the kernel reads (``walk_tables``).  Each step
    pops one node on every lane whose stack is not empty; lanes are
    independent, so this equals the kernel's walk of each ray.  Refuses a
    bank whose trees could overflow the stack (``check_stack_depth``)."""
    if alive is not None:
        return _masked(bvh_walk_plain, origin, direction, t_init, mesh,
                       counts, alive, touched=touched)
    check_stack_depth(mesh)
    origin, direction = origin.detach(), direction.detach()
    R = origin.shape[0]
    dev = origin.device
    inv = 1.0 / direction
    t_best = t_init.detach().clone()
    best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(R, device=dev)
    cnt = torch.zeros((R, COUNT_COLS), dtype=torch.int64, device=dev)
    for node_off, index_off, vert_off in _draws(mesh):
        stack = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
        stack[:, 0] = node_off
        ptr = torch.ones(R, dtype=torch.int64, device=dev)
        while True:
            act = ptr > 0
            if not bool(act.any()):
                break
            ptr = torch.where(act, ptr - 1, ptr)
            node = stack[lane, ptr]
            t0, t1 = ix.ray_box(origin, inv, mesh.bvh_min[node],
                                mesh.bvh_max[node])
            enter = act & (t0 <= t1) & (t1 >= 0.0) & (t0 <= t_best)
            count = mesh.bvh_count[node].long()
            left = mesh.bvh_left[node].long()
            leaf = count > 0
            cnt[:, 0] += act
            t_best, best = _leaf_tests(
                origin, direction, mesh, enter & leaf, count, left,
                index_off, vert_off, t_best, best, cnt[:, 2],
                None if touched is None else touched[1])
            push = enter & ~leaf
            cnt[:, 1] += push
            if touched is not None:
                touched[0][node[push]] = True
            lchild = torch.where(push, node_off + left, node)
            rchild = torch.where(push, lchild + 1, node)
            lt0, lt1 = ix.ray_box(origin, inv, mesh.bvh_min[lchild],
                                  mesh.bvh_max[lchild])
            rt0, rt1 = ix.ray_box(origin, inv, mesh.bvh_min[rchild],
                                  mesh.bvh_max[rchild])
            ldist = torch.where(lt0 > 0.0, lt0, lt1)
            rdist = torch.where(rt0 > 0.0, rt0, rt1)
            near_left = ldist < rdist
            far = torch.where(near_left, rchild, lchild)
            near = torch.where(near_left, lchild, rchild)
            p = lane[push]
            stack[p, ptr[push]] = far[push]
            stack[p, ptr[push] + 1] = near[push]
            ptr = torch.where(push, ptr + 2, ptr)
    if counts is not None:
        counts.copy_(cnt.to(torch.int32))
    return t_best, best


def bvh_walk_records_plain(origin, direction, t_init, mesh, counts=None,
                           alive=None):
    """``bvh_walk_plain``'s contract, walked over ``walk_tables(mesh)`` the
    way the kernel walks them: a root is pushed with its entry distance t0
    only if its slab interval is non-empty and not behind the ray; a popped
    entry is entered iff t0 <= t_best (the rest of the twin's enter test,
    on the same floats); an entered inner node tests both children from its
    record and pushes far then near, each only if its own interval passes
    (a child not pushed still counts as popped); a leaf reads its triangles
    from the triangle records.  Same result and counters as the twin."""
    if alive is not None:
        return _masked(bvh_walk_records_plain, origin, direction, t_init,
                       mesh, counts, alive)
    tables = walk_tables(mesh)
    origin, direction = origin.detach(), direction.detach()
    R = origin.shape[0]
    dev = origin.device
    inv = 1.0 / direction
    t_best = t_init.detach().clone()
    best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(R, device=dev)
    cnt = torch.zeros((R, COUNT_COLS), dtype=torch.int64, device=dev)
    nodes, tris, draws = (x.to(dev) for x in (tables.nodes, tables.tris,
                                              tables.draws))
    nodes_i, tris_i, draws_i = (x.view(torch.int32).long()
                                for x in (nodes, tris, draws))
    S = tables.depth + 1

    def push(sref, st0, ptr, mask, enc, t0):
        p = lane[mask]
        sref[p, ptr[mask]] = enc[mask]
        st0[p, ptr[mask]] = t0[mask]
        return torch.where(mask, ptr + 1, ptr)

    for di in range(draws.shape[0]):
        t0, t1 = ix.ray_box(origin, inv, draws[di, 0:3].expand(R, 3),
                            draws[di, 3:6].expand(R, 3))
        cnt[:, 0] += 1
        sref = torch.full((R, S), -1, dtype=torch.int64, device=dev)
        st0 = torch.zeros((R, S), dtype=torch.float32, device=dev)
        ptr = torch.zeros(R, dtype=torch.int64, device=dev)
        root = draws_i[di, 6].expand(R)
        ptr = push(sref, st0, ptr, (t0 <= t1) & (t1 >= 0.0), root, t0)
        while True:
            act = ptr > 0
            if not bool(act.any()):
                break
            ptr = torch.where(act, ptr - 1, ptr)
            enc = sref[lane, ptr]
            go = act & (st0[lane, ptr] <= t_best)
            # a leaf: triangles from the triangle records, strict `<`
            lf = go & (enc <= -2)
            i0 = torch.where(lf, -2 - enc, 0)
            rem = torch.where(lf, tris_i[i0 // 3, 3], 0)
            for k in range(tables.max_leaf_tris):
                valid = k < rem
                rec = tris[torch.where(valid, i0 // 3 + k, 0)]
                t, _, _, hit = ix.ray_triangle(origin, direction, rec[:, 0:3],
                                               rec[:, 4:7], rec[:, 8:11])
                upd = valid & hit & (t < t_best)
                t_best = torch.where(upd, t, t_best)
                best = torch.where(upd, (i0 + 3 * k).to(torch.int32), best)
                cnt[:, 2] += valid
            # an inner node: both children from its record
            inn = go & (enc >= 0)
            cnt[:, 0] += 2 * inn
            cnt[:, 1] += inn
            if not bool(inn.any()):
                continue
            r = torch.where(inn, enc, 0)
            rec, rec_i = nodes[r], nodes_i[r]
            lt0, lt1 = ix.ray_box(origin, inv, rec[:, 0:3], rec[:, 3:6])
            rt0, rt1 = ix.ray_box(origin, inv, rec[:, 6:9], rec[:, 9:12])
            lenc, renc = rec_i[:, 12], rec_i[:, 13]
            near_left = (torch.where(lt0 > 0.0, lt0, lt1)
                         < torch.where(rt0 > 0.0, rt0, rt1))
            lpass = (lt0 <= lt1) & (lt1 >= 0.0)
            rpass = (rt0 <= rt1) & (rt1 >= 0.0)
            for first in (False, True):           # far, then near
                left_side = near_left == first
                ptr = push(sref, st0, ptr,
                           inn & torch.where(left_side, lpass, rpass),
                           torch.where(left_side, lenc, renc),
                           torch.where(left_side, lt0, rt0))
    if counts is not None:
        counts.copy_(cnt.to(torch.int32))
    return t_best, best


def bvh_walk_stackless_plain(origin, direction, t_init, mesh):
    """Escape-link walk (JAX ``wavefront._bvh_closest_tri_stackless``): one
    node cursor per lane, fixed DFS order (left child first, no near-child
    heuristic), escape links from ``mesh.bvh_escape``.  Same signature and
    result as ``bvh_walk_plain`` except on exact ``t`` ties."""
    origin, direction = origin.detach(), direction.detach()
    R = origin.shape[0]
    dev = origin.device
    inv = 1.0 / direction
    t_best = t_init.detach().clone()
    best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for node_off, index_off, vert_off in _draws(mesh):
        cur = torch.full((R,), node_off, dtype=torch.int64, device=dev)
        while True:
            act = cur >= 0
            if not bool(act.any()):
                break
            node = cur.clamp_min(0)
            t0, t1 = ix.ray_box(origin, inv, mesh.bvh_min[node],
                                mesh.bvh_max[node])
            enter = act & (t0 <= t1) & (t1 >= 0.0) & (t0 <= t_best)
            count = mesh.bvh_count[node].long()
            left = mesh.bvh_left[node].long()
            esc = mesh.bvh_escape[node].long()
            leaf = count > 0
            t_best, best = _leaf_tests(
                origin, direction, mesh, enter & leaf, count, left,
                index_off, vert_off, t_best, best, None)
            esc_g = torch.where(esc < 0, -1, node_off + esc)
            nxt = torch.where(enter & ~leaf, node_off + left, esc_g)
            cur = torch.where(act, nxt, cur)
    return t_best, best


# -- the kernel ---------------------------------------------------------------

def bvh_walk_kernel(origin, direction, t_init, mesh, counts=None,
                    alive=None):
    """Closest triangle hit over every draw (``bvh_walk_plain``'s contract).

    On CUDA tensors this launches the Hopper kernel (csrc/bvh_walk.cu)
    through ``launches.launch``, on the current stream without
    synchronising, once per call, counted under B3; on CPU tensors it runs
    the plain walk.  With ``alive`` the kernel walks only the live lanes
    (its persistent warps queue them as they take lanes; no host sync, no
    pass before the launch).  Any other device, dtype, shape or layout
    raises, and so does a bank ``walk_tables`` cannot pack (its first walk
    packs it: host copies of the tables, once per bank).
    """
    if origin.device.type == "cpu":
        return bvh_walk_plain(origin, direction, t_init, mesh, counts, alive)
    if origin.device.type != "cuda":
        raise ValueError(f"bvh_walk_kernel: unsupported device {origin.device}")
    tables = walk_tables(mesh)
    R = origin.shape[0]
    f32, i32 = torch.float32, torch.int32
    ins = (("origin", origin, f32, (R, 3)),
           ("direction", direction, f32, (R, 3)),
           ("t_init", t_init, f32, (R,)),
           ("counts", counts, i32, (R, COUNT_COLS)),
           ("alive", alive, torch.bool, (R,)),
           ("walk tables", tables.nodes, f32, tables.nodes.shape))
    t_out = torch.empty_like(t_init)
    off = torch.empty(R, dtype=i32, device=origin.device)
    counter = torch.zeros(1, dtype=i32, device=origin.device)
    launches.launch("B3", origin.device, ins, [
        origin, direction, t_init, tables.nodes, tables.tris, tables.draws,
        alive, counter, t_out, off, counts, R, tables.draws.shape[0]])
    return t_out, off
