"""BVH walk: closest triangle hit per ray over every draw's BVH.

Port of the JAX package's kernels/traversal.py (the Pallas packet kernel)
and of the per-lane walk in its render/wavefront.py.  On the TPU one
1024-ray packet shared a single scalar stack, because a TPU lane has no
stack of its own; a GPU thread has one, so the port walks one ray per
thread in the reference shader's own order (pathTracer.comp:151-201):

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

``bvh_walk_kernel`` launches the Hopper kernel in csrc/bvh_walk.cu on
CUDA tensors and runs the plain PyTorch walk ``bvh_walk_plain`` on CPU
tensors; the two are equal bit for bit (both round every product and sum
separately).  ``bvh_walk_stackless_plain`` is the escape-link walk of the
JAX package's ``wavefront._bvh_closest_tri_stackless`` (fixed DFS order).

The TPU form's SMEM budgeting (``smem_chunks``,
``packet_bvh_intersect_chunked``) is not ported: the tables sit in global
memory and L2, and one launch walks every draw.
"""

from __future__ import annotations

import numpy as np
import torch

from wc_path_tracer_tpu_torch.kernels import build
from wc_path_tracer_tpu_torch.ops import intersect as ix

STACK_DEPTH = 64   # per-ray stack slots: >= the builder's 33 levels + slack
COUNT_COLS = 3     # per-ray counters: nodes popped, inner nodes entered,
#                    triangles tested


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


def _draws(mesh):
    """Host list of (node_off, index_off, vert_off) of the live draws."""
    nd = int(mesh.draw_count)
    return list(zip(*(getattr(mesh, k)[:nd].tolist() for k in (
        "draw_node_offset", "draw_index_offset", "draw_vertex_offset"))))


def _leaf_tests(origin, direction, mesh, enter, count, left, index_off,
                vert_off, t_best, best, tested):
    """Test each entered leaf's triangles in order; strict ``<`` update."""
    for k in range(mesh.max_leaf_tris):
        valid = enter & (3 * k < count)
        i0 = torch.where(valid, index_off + left + 3 * k, 0)
        ia, ib, ic = (vert_off + mesh.indices[i0 + j].long() for j in range(3))
        t, _, _, hit = ix.ray_triangle(origin, direction, mesh.vertices[ia],
                                       mesh.vertices[ib], mesh.vertices[ic])
        upd = valid & hit & (t < t_best)
        t_best = torch.where(upd, t, t_best)
        best = torch.where(upd, i0.to(torch.int32), best)
        if tested is not None:
            tested += valid
    return t_best, best


def bvh_walk_plain(origin, direction, t_init, mesh, counts=None):
    """Per-lane stack walk (the module docstring's order) in plain PyTorch:
    the kernel's twin.  origin/direction (R, 3) f32, t_init (R,) f32 ->
    (t (R,) f32, off (R,) int32).  ``counts`` (R, 3) int32, if given,
    receives each ray's nodes popped, inner nodes entered and triangles
    tested.  Each step pops one node on every lane whose stack is not
    empty; lanes are independent, so this equals the one-thread-per-ray
    kernel.  Refuses a bank whose trees could overflow the stack
    (``check_stack_depth``)."""
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
                index_off, vert_off, t_best, best, cnt[:, 2])
            push = enter & ~leaf
            cnt[:, 1] += push
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


def bvh_walk_kernel(origin, direction, t_init, mesh, counts=None):
    """Closest triangle hit over every draw (``bvh_walk_plain``'s contract).

    On CUDA tensors this launches the Hopper kernel (csrc/bvh_walk.cu) on
    the current stream without synchronising, and counts the launch in
    ``bvh_walk_kernel.launches``; on CPU tensors it runs the plain walk.
    Any other device, dtype, shape or layout raises, and so does a bank
    whose trees could overflow the kernel's stack (``check_stack_depth``,
    a host copy on a bank's first walk only).
    """
    if origin.device.type == "cpu":
        return bvh_walk_plain(origin, direction, t_init, mesh, counts)
    if origin.device.type != "cuda":
        raise ValueError(f"bvh_walk_kernel: unsupported device {origin.device}")
    check_stack_depth(mesh)
    R = origin.shape[0]
    N = mesh.bvh_left.shape[0]
    D = mesh.draw_node_offset.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
            ("origin", origin, f32, (R, 3)),
            ("direction", direction, f32, (R, 3)),
            ("t_init", t_init, f32, (R,)),
            ("bvh_min", mesh.bvh_min, f32, (N, 3)),
            ("bvh_max", mesh.bvh_max, f32, (N, 3)),
            ("bvh_left", mesh.bvh_left, i32, (N,)),
            ("bvh_count", mesh.bvh_count, i32, (N,)),
            ("indices", mesh.indices, i32, (mesh.indices.shape[0],)),
            ("vertices", mesh.vertices, f32, (mesh.vertices.shape[0], 3)),
            ("draw_node_offset", mesh.draw_node_offset, i32, (D,)),
            ("draw_index_offset", mesh.draw_index_offset, i32, (D,)),
            ("draw_vertex_offset", mesh.draw_vertex_offset, i32, (D,)),
            ("draw_count", mesh.draw_count, i32, ()),
            ("counts", counts, i32, (R, COUNT_COLS))):
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != origin.device:
            raise ValueError(
                f"bvh_walk_kernel: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {origin.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} contiguous={t.is_contiguous()}")
    t_out = torch.empty_like(t_init)
    off = torch.empty(R, dtype=i32, device=origin.device)
    if R == 0:
        return t_out, off
    lib = build.load("bvh_walk")
    stream = torch.cuda.current_stream(origin.device).cuda_stream
    rc = lib.wc_bvh_walk(
        origin.data_ptr(), direction.data_ptr(), t_init.data_ptr(),
        mesh.bvh_min.data_ptr(), mesh.bvh_max.data_ptr(),
        mesh.bvh_left.data_ptr(), mesh.bvh_count.data_ptr(),
        mesh.indices.data_ptr(), mesh.vertices.data_ptr(),
        mesh.draw_node_offset.data_ptr(), mesh.draw_index_offset.data_ptr(),
        mesh.draw_vertex_offset.data_ptr(), mesh.draw_count.data_ptr(),
        t_out.data_ptr(), off.data_ptr(),
        counts.data_ptr() if counts is not None else None,
        R, D, mesh.max_leaf_tris, stream)
    if rc != 0:
        raise RuntimeError("bvh_walk kernel launch failed: "
                           + lib.wc_cuda_error_string(rc).decode())
    bvh_walk_kernel.launches += 1
    return t_out, off


bvh_walk_kernel.launches = 0
