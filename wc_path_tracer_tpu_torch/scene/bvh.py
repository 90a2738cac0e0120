"""Host-side median-split BVH builder.

Semantics transcribed from the reference's builder
(src/PathTracingRenderer.jai:147-217):

- top-down, longest-axis midpoint split at ``min + extent * 0.5``
- partition key: triangle centroid ``(a+b+c)/3`` on the split axis
- in-place partition of the *index buffer* in triples (the reference swaps
  index triples, :186-191), so leaves address contiguous index runs
- leaf when ``triangleCount <= 6`` — which, per quirk SURVEY §2.1, counts
  *indices* (<= 2 triangles) — or depth cap 32, or a degenerate partition
  (all triangles on one side, :193)
- children are appended in pairs, left child first (:196-209), so an inner
  node stores only its left-child id and the right child is ``left + 1``,
  exactly the layout the traversal kernel expects (pathTracer.comp:180-181).

This is a copy of the JAX package's NumPy builder, and the plain version of
the native C++ builder that ``SceneBuilder.add_mesh`` uses
(scene/native.py; the reference builds in native Jai host code at
LoadModel time).  Both give the same trees bit for bit, as the JAX
package's builders do (tests/test_torch_native.py), so scenes built by
either package match bit for bit; this builder runs where the native
library cannot be built.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEAF_INDEX_COUNT = 6   # <= 6 indices (2 triangles) per leaf, ref :170
MAX_DEPTH = 32         # ref :167 default depth arg


@dataclasses.dataclass
class BVH:
    """Flat BVH arrays + the reordered index buffer.

    ``node_count[n] > 0``  -> leaf covering indices
    ``[node_left[n], node_left[n] + node_count[n])`` (stride 3);
    ``node_count[n] == 0`` -> inner node with children
    ``node_left[n]`` and ``node_left[n] + 1``.
    """

    node_min: np.ndarray   # (N, 3) f32
    node_max: np.ndarray   # (N, 3) f32
    node_left: np.ndarray  # (N,) i32
    node_count: np.ndarray  # (N,) i32 — INDEX count (3 * triangles)
    indices: np.ndarray    # (I,) i32 — BVH-partitioned copy of the input
    tri_order: np.ndarray  # (I//3,) i32 — new triangle slot -> original triangle

    @property
    def num_nodes(self) -> int:
        return len(self.node_left)

    def depth(self) -> int:
        d = {0: 1}
        out = 1
        for n in range(self.num_nodes):
            if self.node_count[n] == 0:
                left = int(self.node_left[n])
                d[left] = d[left + 1] = d[n] + 1
                out = max(out, d[n] + 1)
        return out


def build_bvh(vertices: np.ndarray, indices: np.ndarray,
              leaf_index_count: int = LEAF_INDEX_COUNT,
              max_depth: int = MAX_DEPTH, robust: bool = False) -> BVH:
    """Build the BVH.

    ``robust=False`` reproduces the reference builder exactly, including its
    degenerate-partition bailout (a leaf may then hold arbitrarily many
    triangles).  ``robust=True`` is the mode the vectorized TPU traversal
    requires: when the midpoint partition degenerates, fall back to a median
    split (sorted by centroid), guaranteeing every leaf holds at most
    ``leaf_index_count`` indices (2 triangles) so leaf processing can be a
    static unroll.  Identical traversal results either way — only tree shape
    differs.
    """
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    indices = np.asarray(indices, np.int64).reshape(-1).copy()
    if len(indices) % 3:
        raise ValueError("index count must be a multiple of 3")
    ntris = len(indices) // 3
    tri_order = np.arange(ntris, dtype=np.int64)

    # Precompute per-triangle vertex positions; these follow tri_order.
    node_min: list = []
    node_max: list = []
    node_left: list = []
    node_count: list = []

    def tri_points(first_index: int, index_count: int) -> np.ndarray:
        """(T, 3, 3) vertex positions of the node's triangles."""
        idx = indices[first_index:first_index + index_count].reshape(-1, 3)
        return vertices[idx]

    def new_node(first_index: int, index_count: int) -> int:
        pts = tri_points(first_index, index_count)
        if len(pts):
            bmin = pts.reshape(-1, 3).min(axis=0)
            bmax = pts.reshape(-1, 3).max(axis=0)
        else:  # matches ref Node defaults (PathTracingRenderer.jai:126-127)
            bmin = np.full(3, np.finfo(np.float32).max, np.float32)
            bmax = np.full(3, -np.finfo(np.float32).max, np.float32)
        node_min.append(bmin.astype(np.float32))
        node_max.append(bmax.astype(np.float32))
        node_left.append(first_index)
        node_count.append(index_count)
        return len(node_left) - 1

    root = new_node(0, len(indices))
    stack = [(root, max_depth)]
    while stack:
        n, depth = stack.pop()
        first, count = node_left[n], node_count[n]
        if count <= leaf_index_count or depth == 0:
            continue
        bmin, bmax = node_min[n], node_max[n]
        extent = bmax - bmin
        # exact reference axis choice (:172-175): y>x then z>current
        axis = 0
        if extent[1] > extent[0]:
            axis = 1
        if extent[2] > extent[axis]:
            axis = 2
        split = np.float32(bmin[axis] + extent[axis] * np.float32(0.5))

        # vectorized equivalent of the reference's in-place triple partition
        # (:177-191): stable order is NOT preserved by the original two-pointer
        # sweep, but membership is identical; we replicate membership and
        # contiguity (tests assert invariants, not slot order).
        tri_idx = indices[first:first + count].reshape(-1, 3)
        cent = vertices[tri_idx].mean(axis=1)[:, axis].astype(np.float32)
        left_mask = cent < split
        left_count = int(left_mask.sum()) * 3
        if left_count == 0 or left_count == count:
            if not robust:
                continue  # reference bailout (:193): node stays a big leaf
            # robust fallback: median split by centroid (stable) — always
            # yields two non-empty halves for count > 3
            order_all = np.argsort(cent, kind="stable")
            half = len(order_all) // 2
            left_mask = np.zeros(len(order_all), bool)
            left_mask[order_all[:half]] = True
            left_count = half * 3
        order = np.concatenate([np.where(left_mask)[0], np.where(~left_mask)[0]])
        indices[first:first + count] = tri_idx[order].reshape(-1)
        t0 = first // 3
        tri_order[t0:t0 + count // 3] = tri_order[t0:t0 + count // 3][order]

        lchild = new_node(first, left_count)
        rchild = new_node(first + left_count, count - left_count)
        assert rchild == lchild + 1
        node_left[n] = lchild
        node_count[n] = 0
        stack.append((rchild, depth - 1))
        stack.append((lchild, depth - 1))

    return BVH(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        node_left=np.asarray(node_left, np.int32),
        node_count=np.asarray(node_count, np.int32),
        indices=indices.astype(np.int32),
        tri_order=tri_order.astype(np.int32),
    )


def split_mesh(vertices: np.ndarray, indices: np.ndarray, max_tris: int):
    """Spatially partition a triangle mesh into chunks of <= ``max_tris``.

    Recursive longest-axis median split on triangle centroids — the same
    partition rule as the BVH builder's robust mode, applied above the tree:
    each chunk becomes its own draw command with its own (sub-)BVH, so
    SMEM-budgeted traversal kernels can process one chunk at a time while
    the chunks stay spatially tight (cheap to cull against each other).

    Returns a list of (sub_vertices, sub_indices, tri_ids) with vertices
    compacted per chunk; ``tri_ids`` maps each chunk triangle back to its
    original triangle id (for per-triangle attributes).
    """
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    indices = np.asarray(indices, np.int64).reshape(-1)
    tris = indices.reshape(-1, 3)
    cent = vertices[tris].mean(axis=1)  # (T, 3)

    out = []

    def rec(tri_ids: np.ndarray):
        if len(tri_ids) <= max_tris:
            sub = tris[tri_ids]
            used, inv = np.unique(sub.reshape(-1), return_inverse=True)
            out.append((vertices[used].copy(),
                        inv.astype(np.int32).reshape(-1),
                        tri_ids.astype(np.int32)))
            return
        c = cent[tri_ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(order) // 2
        rec(tri_ids[order[:half]])
        rec(tri_ids[order[half:]])

    rec(np.arange(len(tris)))
    return out
