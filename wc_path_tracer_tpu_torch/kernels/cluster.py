"""Cluster sweep: closest-hit queries against clustered triangles.

Port of the JAX package's kernels/cluster.py.  The triangle bank is cut into
clusters of CLUSTER_TRIS slots (in BVH leaf order, so each is spatially
tight), each with an AABB.  A query of R rays:

1. pads R to a multiple of ``ray_block`` by repeating ray 0;
2. culls every ray against every cluster AABB (``_cull``) and reduces that
   per block of ``ray_block`` rays to the block's entry distance per cluster
   (``bt0``) and each ray's farthest cluster exit (``t_lim``);
3. sorts each block's clusters by ``bt0`` (stable), active ones first;
4. sweeps every block over its active clusters front to back, keeping each
   ray's closest hit with strict ``<`` (the first-visited cluster wins an
   exact tie, the lowest lane within a cluster), and stops a block once
   every ray's min(t_best, t_lim) is at or before the next cluster's entry.

Steps 1-3 are ``cull_order_plain``; on CUDA tensors ``cluster_sweep``
hands them to C1 (``cluster_cull_kernel``, csrc/cluster_cull.cu), which
gives the same inputs of step 4 in one launch.  Step 4 is ``cluster_sweep_kernel``: on
CUDA tensors it launches the Hopper kernel in csrc/cluster_sweep.cu; on CPU
tensors it runs its plain PyTorch twin ``cluster_sweep_plain``, which
repeats the kernel's arithmetic, visit order, tie rule and early exit
exactly.  ``sweep_reference`` is an independent brute-force oracle (global
first minimum).

``variant="mxu"`` swaps step 4 for the plane-form test
(``cluster_sweep_mxu_kernel``, csrc/cluster_sweep_mxu.cu, and its twin
``cluster_sweep_mxu_plain``) over the tables of ``build_cluster_tables_mxu``;
its hits agree with Möller-Trumbore's to f32 roundoff, not bitwise.

The winner payload is (R, 16) float32: 0 t, 1:10 winner vertices
ax ay az bx by bz cx cy cz, 10 material id, 11 bank-global slot id (-1 =
none, both as floats), 12:16 zero.  Rays that find nothing closer than
their ``t_init`` keep the initial payload [t_init, 0 x 10, -1, 0 x 4].
"""

from __future__ import annotations

import torch

from wc_path_tracer_tpu_torch.kernels import launches
from wc_path_tracer_tpu_torch.ops import intersect as ix
from wc_path_tracer_tpu_torch.utils import profiling

KINF = ix.KINFINITY
CLUSTER_TRIS = 128   # triangle slots per cluster
CLUSTER_ROWS = 16    # f32 rows per cluster slab: 9 coordinates, material, pad
RAY_BLOCK = 512      # rays per kernel block (the JAX package's default)
SWEEP_CTAS = 4       # CTAs sharing one 512-ray block in both sweep kernels
SWEEP_GROUPS = 4     # threads per ray there, each testing 128 / 4 slots
PAYLOAD_COLS = 16
CULL_MATERIALIZE_ELEMS = 64 * 1024 * 1024   # largest (rays x clusters) cull
CULL_SHARED_CLUSTERS = 8192   # most clusters C1 sorts in shared memory
MXU_ROWS = 8         # K rows of a plane-form slab: o (3), d (3), 1, pad
MXU_FIELDS = 6       # Q, P, Bu, Au, Bv, Av


def _pad_rows(x, n: int, fill=0):
    if n == 0:
        return x
    return torch.cat([x, torch.full((n,) + x.shape[1:], fill, dtype=x.dtype,
                                    device=x.device)])


def _padded_tri_coords(mesh):
    """Per-slot vertex coordinates (a, b, c) each (Tpad, 3), material column
    (Tpad,) f32, live mask (Tpad,) and the cluster count C.  Dead slots are
    zeroed (degenerate triangles that can never be hit)."""
    T = mesh.triangle_capacity
    C = -(-T // CLUSTER_TRIS)
    pad = C * CLUSTER_TRIS - T
    voff = mesh.draw_vertex_offset[mesh.tri_draw.clamp_min(0)]
    tri = mesh.indices.view(-1, 3) + voff[:, None]
    live = (mesh.tri_draw >= 0) & (mesh.tri_draw < mesh.draw_count)
    a, b, c = (_pad_rows(torch.where(live[:, None], mesh.vertices[tri[:, k]],
                                     0.0), pad)
               for k in range(3))
    mat = _pad_rows(mesh.tri_material.to(torch.float32), pad)
    return a, b, c, mat, _pad_rows(live, pad, False), C


def vertex_slabs(mesh):
    """(9, C, CLUSTER_TRIS) winner-coordinate slabs, differentiable in
    ``mesh.vertices``: ``slabs[k, c, l]`` equals payload column ``1 + k``
    for the winner in slot ``c * CLUSTER_TRIS + l``."""
    a, b, c, _, _, C = _padded_tri_coords(mesh)
    coords = torch.cat([a, b, c], dim=1).T              # (9, Tpad)
    return coords.reshape(9, C, CLUSTER_TRIS)


def neighbor_slabs(mesh):
    """Detached per-slot neighbor data for the silhouette estimator's edge
    classification -> (nbrn (9, C, CLUSTER_TRIS), nbrok (3, C,
    CLUSTER_TRIS)): rows 0:3 / 3:6 / 6:9 of ``nbrn`` hold the geometric
    normal (unnormalised) of the neighbor across edge (a,b) / (b,c) / (c,a)
    of the triangle in that slot, zero where it has none; row k of
    ``nbrok`` is 1.0 where that neighbor exists and is live."""
    with torch.no_grad():
        a, b, c, _, lv, C = _padded_tri_coords(mesh)
        n_all = ix.cross(b - a, c - a)                  # (Tpad, 3)
        nbr = _pad_rows(mesh.tri_neighbor.long(),
                        C * CLUSTER_TRIS - mesh.triangle_capacity, -1)
        ok = (nbr >= 0) & lv[nbr.clamp_min(0)]          # (Tpad, 3)
        nbrn = torch.where(ok[:, :, None], n_all[nbr.clamp_min(0)], 0.0)
        return (nbrn.reshape(-1, 9).T.reshape(9, C, CLUSTER_TRIS),
                ok.T.to(torch.float32).reshape(3, C, CLUSTER_TRIS))


def tables_from_coords(a, b, c, mat, lv, C):
    """(tris, cmin, cmax) kernel tables from per-slot coordinates.

    tris: (C * CLUSTER_ROWS, CLUSTER_TRIS) f32 — cluster c occupies rows
    [16c, 16c + 16): rows 0..8 ax..cz, row 9 the material id, rows 10..15
    zero.  The AABBs cover live slots only; an all-dead cluster gets
    (+KINF, -KINF), which ``_cull`` never lets a ray enter.
    """
    Tpad = C * CLUSTER_TRIS
    zeros = torch.zeros((Tpad, CLUSTER_ROWS - 10), dtype=a.dtype,
                        device=a.device)
    cols = torch.cat([a, b, c, mat[:, None], zeros], dim=1)     # (Tpad, 16)
    tris = cols.view(C, CLUSTER_TRIS, CLUSTER_ROWS).transpose(1, 2) \
        .reshape(C * CLUSTER_ROWS, CLUSTER_TRIS).contiguous()
    vmin = torch.where(lv[:, None], torch.minimum(torch.minimum(a, b), c), KINF)
    vmax = torch.where(lv[:, None], torch.maximum(torch.maximum(a, b), c), -KINF)
    cmin = torch.amin(vmin.view(C, CLUSTER_TRIS, 3), dim=1)
    cmax = torch.amax(vmax.view(C, CLUSTER_TRIS, 3), dim=1)
    return tris, cmin, cmax


def build_cluster_tables(mesh):
    """(tris, cmin, cmax) from a MeshBank (see tables_from_coords)."""
    return tables_from_coords(*_padded_tri_coords(mesh))


def mxu_tables_from_coords(a, b, c, mat, lv, C):
    """Plane-form tables: (trisW (C * 8, 768), cmin, cmax, mat_tbl (C, 128)).

    Per triangle the barycentrics are affine in the hit point x = o + t d:
    with n = e1 x e2 and m = n.n, u(x) = au.x + bu with au = (e2 x n) / m,
    v(x) = av.x + bv with av = (n x e1) / m, and the plane is n.x + d0 = 0.
    So per (ray, triangle) six dot products of [o, d, 1, 0] with a column
    of the cluster's (8, 768) slab give Q = n.d, P = n.o + d0, Bu = au.d,
    Au = au.o + bu, Bv = av.d, Av = av.o + bv; slab column f * 128 + l holds
    field f of slot l.  Dead slots get n = au = av = 0, so Q = 0 and every
    test on them is false.  The AABBs are ``tables_from_coords``'.
    """
    e1 = b - a
    e2 = c - a
    n = ix.cross(e1, e2)
    m = ix.dot3(n, n)
    m_safe = torch.where(m > 0.0, m, 1.0)[:, None]
    au = ix.cross(e2, n) / m_safe
    av = ix.cross(n, e1) / m_safe
    d0 = -ix.dot3(n, a)
    bu = -ix.dot3(au, a)
    bv = -ix.dot3(av, a)
    z = torch.zeros_like(d0)
    zero3 = torch.zeros_like(n)

    def col(o_part, d_part, c_part):          # rows: o (3), d (3), 1, pad
        return torch.stack([o_part[:, 0], o_part[:, 1], o_part[:, 2],
                            d_part[:, 0], d_part[:, 1], d_part[:, 2],
                            c_part, z], dim=1)              # (Tpad, 8)

    W = torch.stack([col(zero3, n, z), col(n, zero3, d0),
                     col(zero3, au, z), col(au, zero3, bu),
                     col(zero3, av, z), col(av, zero3, bv)], dim=2)
    trisW = W.view(C, CLUSTER_TRIS, MXU_ROWS, MXU_FIELDS) \
        .permute(0, 2, 3, 1) \
        .reshape(C * MXU_ROWS, MXU_FIELDS * CLUSTER_TRIS).contiguous()
    _, cmin, cmax = tables_from_coords(a, b, c, mat, lv, C)
    return trisW, cmin, cmax, mat.view(C, CLUSTER_TRIS).contiguous()


def build_cluster_tables_mxu(mesh):
    """(trisW, cmin, cmax, mat_tbl) from a MeshBank (see
    mxu_tables_from_coords)."""
    return mxu_tables_from_coords(*_padded_tri_coords(mesh))


def sweep_reference(origin, direction, t_init, tris, cmin, cmax):
    """Brute-force oracle with the sweep's payload: every ray against every
    slot, global first minimum.  It equals the sweep except on exact f32
    t-ties between clusters, which the sweep gives to the first-visited
    cluster.  Memory is O(R x slots): call it on small batches."""
    C = cmin.shape[0]
    comp = tris.view(C, CLUSTER_ROWS, CLUSTER_TRIS).transpose(1, 2) \
        .reshape(C * CLUSTER_TRIS, CLUSTER_ROWS)
    t, hit = ix.ray_triangle_sweep(origin, direction, comp[:, 0:3],
                                   comp[:, 3:6], comp[:, 6:9])
    tm = torch.where(hit & (t < t_init[:, None]), t, KINF)
    t_min = torch.amin(tm, dim=-1)
    slot = torch.arange(tm.shape[-1], device=tm.device)
    idx = torch.amin(torch.where(tm == t_min[:, None], slot, tm.shape[-1]),
                     dim=-1)
    found = t_min < t_init
    R = origin.shape[0]
    return torch.cat([
        torch.where(found, t_min, t_init)[:, None],
        torch.where(found[:, None], comp[idx, :10], 0.0),
        torch.where(found, idx.to(torch.float32), -1.0)[:, None],
        torch.zeros((R, 4), dtype=origin.dtype, device=origin.device)], dim=1)


def cull_chunk_blocks(RB: int, C: int, ray_block: int) -> int:
    """Ray blocks per chunk of the cull: all ``RB`` when rays x clusters
    fit CULL_MATERIALIZE_ELEMS, else the largest divisor of ``RB`` whose
    chunk fits (at least 1)."""
    if RB * ray_block * C <= CULL_MATERIALIZE_ELEMS:
        return RB
    G = max(1, CULL_MATERIALIZE_ELEMS // (ray_block * C))
    while RB % G:
        G -= 1
    return G


def _cull(origin, direction, t_best, cmin, cmax, RB: int, ray_block: int):
    """Ray-vs-cluster AABB cull -> (bt0 (RB, C) block entry distances, KINF
    where no ray of the block enters; t_lim (Rp,) farthest exit per ray,
    -KINF where it enters nothing).  A ray enters a live cluster if its
    slab interval is non-empty, not behind it, and starts before
    ``t_best``.  An all-dead cluster's inverted box (+KINF, -KINF) is
    excluded explicitly: the slab test orders each axis's two distances,
    so it alone would let every ray in at t0 = -inf, ahead of every bound,
    and give every ray t_lim = +inf.  Above CULL_MATERIALIZE_ELEMS
    (rays x clusters) it runs in groups of blocks, bounding the scratch
    memory."""
    C = cmin.shape[0]
    Rp = origin.shape[0]
    inv_d = 1.0 / direction
    live = torch.all(cmin <= cmax, dim=1)

    def sweep(o, idv, tb):
        t0, t1 = ix.ray_box_sweep(o, idv, cmin, cmax)
        enter = (t0 <= t1) & (t1 >= 0.0) & (t0 < tb[:, None]) & live
        bt0 = torch.amin(torch.where(enter, t0, KINF).view(-1, ray_block, C),
                         dim=1)
        t_lim = torch.amax(torch.where(enter, t1, -KINF), dim=1)
        return bt0, t_lim

    G = cull_chunk_blocks(RB, C, ray_block)
    if G == RB:
        return sweep(origin, inv_d, t_best)
    n = G * ray_block
    parts = [sweep(origin[i:i + n], inv_d[i:i + n], t_best[i:i + n])
             for i in range(0, Rp, n)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def cluster_sweep(origin, direction, t_init, tris, cmin, cmax,
                  ray_block: int = RAY_BLOCK, block_fn=None,
                  variant: str = "mt", mat_tbl=None):
    """Closest hit of R rays against clustered triangles -> (R, 16) payload.

    origin/direction (R, 3) f32, t_init (R,) f32 the search bound (e.g. the
    closest sphere's t; -KINF disables a ray).  ``variant`` "mt" takes the
    tables of ``build_cluster_tables``; "mxu" the plane-form ``tris`` and
    ``mat_tbl`` of ``build_cluster_tables_mxu`` (its payload's vertex
    columns are zero).  ``block_fn`` sweeps the blocks; the default is the
    variant's kernel wrapper, which launches the CUDA kernel on CUDA
    tensors.  Steps 1-3 run in C1 on the card (its lanes counted as
    ``cull.lanes``), else in ``cull_order_plain``.  A discrete search: the
    caller re-shades the winner.
    """
    if variant == "mt":
        tbl = (tris,)
        default_fn = cluster_sweep_kernel
    elif variant == "mxu":
        if mat_tbl is None:
            raise ValueError("variant='mxu' requires mat_tbl from "
                             "build_cluster_tables_mxu")
        tbl = (tris, mat_tbl)
        default_fn = cluster_sweep_mxu_kernel
    else:
        raise ValueError(f"unknown cluster_sweep variant {variant!r}")
    if block_fn is None:
        block_fn = default_fn
    R = origin.shape[0]
    with profiling.stage("sweep.cull"):
        if on_card(direction):
            profiling.count("cull.lanes", R)
            blocks = cluster_cull_kernel(origin, direction, t_init, cmin, cmax,
                                         ray_block)
        else:
            blocks = cull_order_plain(origin, direction, t_init, cmin, cmax,
                                      ray_block)
    with profiling.stage("sweep.kernel"):
        pay = block_fn(*blocks, *tbl)
    return pay.view(-1, PAYLOAD_COLS)[:R]


def cull_order_plain(origin, direction, t_init, cmin, cmax,
                     ray_block: int = RAY_BLOCK):
    """Steps 1-3 of the sweep in plain PyTorch -> the block sweep's inputs
    (nact (RB,) int32, clist (RB, C) int32, bt0 (RB, C) sorted, rays (RB,
    ray_block, 16), prev (RB, ray_block, 16)); the twin of C1
    (``cluster_cull_kernel``) and the CPU's path.

    Pads R to a multiple of ``ray_block`` by repeating ray 0 (coherent with
    block 0, so it costs ~nothing), culls (``_cull``), counts each block's
    active clusters and orders them by entry distance (a stable argsort:
    active first, equal entries in cluster order), and packs ``rays`` = [o,
    d, t_init, t_lim, 0 x 8] and ``prev`` = [t_init, 0 x 10, -1, 0 x 4]."""
    R = origin.shape[0]
    pad = (-R) % ray_block
    Rp = R + pad
    RB = Rp // ray_block
    if pad:
        origin = torch.cat([origin, origin[:1].expand(pad, 3)])
        direction = torch.cat([direction, direction[:1].expand(pad, 3)])
        t_init = torch.cat([t_init, t_init[:1].expand(pad)])
    bt0, t_lim = _cull(origin, direction, t_init, cmin, cmax, RB, ray_block)
    nact = torch.sum(bt0 < KINF, dim=1, dtype=torch.int32)
    order = torch.argsort(bt0, dim=1, stable=True)
    bt0_sorted = torch.gather(bt0, 1, order)
    zeros = torch.zeros((Rp, 1), dtype=origin.dtype, device=origin.device)
    rays = torch.cat([origin, direction, t_init[:, None], t_lim[:, None]]
                     + [zeros] * 8, dim=1).view(RB, ray_block, PAYLOAD_COLS)
    prev = torch.cat([t_init[:, None]] + [zeros] * 10 + [zeros - 1.0]
                     + [zeros] * 4, dim=1).view(RB, ray_block, PAYLOAD_COLS)
    return nact, order.to(torch.int32), bt0_sorted, rays, prev


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a CUDA card, where C1 runs."""
    return t.device.type == "cuda"


def cluster_cull_kernel(origin, direction, t_init, cmin, cmax,
                        ray_block: int = RAY_BLOCK):
    """C1: ``cull_order_plain`` in one launch (csrc/cluster_cull.cu) ->
    the same five tensors, with nothing of size rays x clusters in device
    memory.  nact, clist and prev equal the twin's bit for bit, bt0 and
    rays as floats (an entry distance of -0.0 comes back as +0.0).

    ``origin`` (R, 3) float32 (an origin expanded from one row is read in
    place), ``direction`` (R, 3), ``t_init`` (R,), ``cmin`` / ``cmax``
    (C, 3), C >= 1; any ``ray_block``.  Above CULL_SHARED_CLUSTERS clusters
    each ray block's sort keys go to a (blocks, keys) int64 scratch, keys
    the least power of two >= C: blocks x clusters, not rays x clusters.
    Detached CUDA tensors only: the CPU runs the twin.  Launches through
    ``launches.launch``: on the current stream without synchronising,
    counted under C1."""
    if not on_card(direction):
        raise ValueError("cluster_cull_kernel: CUDA tensors only, got "
                         f"{direction.device}")
    R, C = direction.shape[0], cmin.shape[0]
    if C < 1:
        raise ValueError(f"cluster_cull_kernel: 1 or more clusters, got {C}")
    f32, i32 = torch.float32, torch.int32
    ins = (("origin", origin, f32, (R, 3)),
           ("direction", direction, f32, (R, 3)),
           ("t_init", t_init, f32, (R,)),
           ("cmin", cmin, f32, (C, 3)),
           ("cmax", cmax, f32, (C, 3)))
    origin = origin.detach()
    shared = origin.stride() == (0, 1)
    args = [origin if shared else origin.contiguous()]
    args += [t.detach().contiguous() for _, t, _, _ in ins[1:]]
    dev = direction.device
    RB = -(-R // ray_block)
    outs = [torch.empty(RB, dtype=i32, device=dev),
            torch.empty((RB, C), dtype=i32, device=dev),
            torch.empty((RB, C), dtype=f32, device=dev),
            torch.empty((RB, ray_block, PAYLOAD_COLS), dtype=f32, device=dev),
            torch.empty((RB, ray_block, PAYLOAD_COLS), dtype=f32, device=dev)]
    scratch = None
    if C > CULL_SHARED_CLUSTERS:
        scratch = torch.empty((RB, 1 << (C - 1).bit_length()),
                              dtype=torch.int64, device=dev)
    launches.launch("C1", dev, ins, args + outs + [scratch, R,
                                                   0 if shared else 3,
                                                   ray_block, C],
                    contiguous=False)
    return tuple(outs)


def _sweep_blocks(nact, clist, bt0, rays, prev, test, visits=None):
    """The block loop both plain twins share -> (t_best (RB, B), win (RB, B)
    winner slot id or -1).  Step j tests every still-running block's j-th
    cluster c with ``test(c)`` -> (t, hit) each (RB, B, 128), keeps the
    closest hit under strict ``<`` (lowest lane on a tie), then stops each
    block once every ray's min(t_best, t_lim) is at or before its next
    cluster's entry.  ``visits`` (RB,) int32, if given, receives the
    clusters each block visited."""
    RB, B, _ = rays.shape
    t_lim = rays[:, :, 7]
    t_best = prev[:, :, 0].clone()
    win = torch.full((RB, B), -1, dtype=torch.int64, device=rays.device)
    lane = torch.arange(CLUSTER_TRIS, device=rays.device)
    nact = nact.to(torch.int64)
    clist = clist.to(torch.int64)
    running = nact > 0
    steps = torch.zeros(RB, dtype=torch.int64, device=rays.device)
    for j in range(int(nact.max()) if RB else 0):
        if not bool(running.any()):
            break
        c = clist[:, j]
        t, hit = test(c)                                    # (RB, B, 128)
        tm = torch.where(hit & (t < t_best[..., None]), t, KINF)
        t_min = torch.amin(tm, dim=-1)
        sel = torch.amin(torch.where(tm == t_min[..., None], lane,
                                     CLUSTER_TRIS), dim=-1)
        better = (t_min < t_best) & running[:, None]
        t_best = torch.where(better, t_min, t_best)
        win = torch.where(better, c[:, None] * CLUSTER_TRIS + sel, win)
        steps += running
        nxt = torch.clamp(torch.minimum(nact - 1, torch.full_like(nact, j + 1)),
                          min=0)
        next_entry = torch.gather(bt0, 1, nxt[:, None])      # (RB, 1)
        go = torch.any(torch.minimum(t_best, t_lim) > next_entry, dim=1)
        running = running & go & (j + 1 < nact)
    if visits is not None:
        visits.copy_(steps.to(torch.int32))
    return t_best, win


def _winner_payload(t_best, win, cols, prev):
    """[t, cols (10), slot id, 0 x 4] where a winner was found, else prev."""
    new = torch.cat([t_best[..., None], cols,
                     win.to(torch.float32)[..., None],
                     torch.zeros(win.shape + (4,), dtype=prev.dtype,
                                 device=prev.device)], dim=-1)
    return torch.where((win >= 0)[..., None], new, prev)


def cluster_sweep_plain(nact, clist, bt0, rays, prev, tris, visits=None):
    """Plain PyTorch twin of the CUDA kernel, vectorized over blocks.

    Same inputs as ``cluster_sweep_kernel``: per block b the active count
    ``nact[b]``, cluster ids ``clist[b]`` and entry distances ``bt0[b]``
    sorted front to back, rays (RB, B, 16) = [o, d, t_init, t_lim, 0 x 8],
    the initial payload ``prev`` (RB, B, 16) and the table ``tris``.  Each
    visited cluster is tested in the kernel's operation order, with its
    update rule and early exit (``_sweep_blocks``), so payloads match the
    kernel exactly.  ``visits`` (RB,) int32, if given, receives the
    clusters each block visited.
    """
    C = tris.shape[0] // CLUSTER_ROWS
    slabs = tris.view(C, CLUSTER_ROWS, CLUSTER_TRIS)
    ox, oy, oz, dx, dy, dz = (rays[:, :, k:k + 1] for k in range(6))

    def test(c):
        slab = slabs[c]                                     # (RB, 16, 128)
        ax, ay, az = slab[:, 0:1], slab[:, 1:2], slab[:, 2:3]   # (RB, 1, 128)
        return ix._moller_trumbore(
            ox, oy, oz, dx, dy, dz,
            slab[:, 3:4] - ax, slab[:, 4:5] - ay, slab[:, 5:6] - az,
            slab[:, 6:7] - ax, slab[:, 7:8] - ay, slab[:, 8:9] - az,
            ax, ay, az)

    t_best, win = _sweep_blocks(nact, clist, bt0, rays, prev, test, visits)
    w = win.clamp_min(0)
    picked = slabs[w // CLUSTER_TRIS, :10, w % CLUSTER_TRIS]   # (RB, B, 10)
    return _winner_payload(t_best, win, picked, prev)


def cluster_sweep_mxu_plain(nact, clist, bt0, rays, prev, trisW, mat_tbl,
                            visits=None):
    """Plain PyTorch twin of the plane-form kernel, vectorized over blocks.

    ``cluster_sweep_plain``'s inputs with the slab table ``trisW`` and the
    material table ``mat_tbl``.  Each of the six fields is the dot product
    of X = [o, d, 1, 0] with its slab column, summed term by term from k = 0
    to 7 (the kernel's order; no matmul, whose reduction order is
    unspecified), then t = -P * (1 / Q), u = Au + t Bu, v = Av + t Bv and
    hit = t > 0, u >= 0, v >= 0, u + v <= 1.  The visit order, tie rule and
    early exit are ``cluster_sweep_plain``'s.  The payload of a winner is
    [t, 0 x 9, material, slot id, 0 x 4].
    """
    RB, B, _ = rays.shape
    C = trisW.shape[0] // MXU_ROWS
    K = CLUSTER_TRIS
    slabs = trisW.view(C, MXU_ROWS, MXU_FIELDS * K)
    X = [rays[:, :, k:k + 1] for k in range(6)] + [
        torch.ones((RB, B, 1), dtype=rays.dtype, device=rays.device),
        torch.zeros((RB, B, 1), dtype=rays.dtype, device=rays.device)]

    def test(c):
        slab = slabs[c]                                     # (RB, 8, 768)

        def field(f):
            w = slab[:, :, f * K:(f + 1) * K]               # (RB, 8, 128)
            y = X[0] * w[:, 0:1]
            for k in range(1, MXU_ROWS):
                y = y + X[k] * w[:, k:k + 1]
            return y                                        # (RB, B, 128)

        Q, P, Bu, Au, Bv, Av = (field(f) for f in range(MXU_FIELDS))
        t = -P * (1.0 / Q)
        u = Au + t * Bu
        v = Av + t * Bv
        return t, (t > 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)

    t_best, win = _sweep_blocks(nact, clist, bt0, rays, prev, test, visits)
    w = win.clamp_min(0)
    zeros = torch.zeros((RB, B, 9), dtype=rays.dtype, device=rays.device)
    cols = torch.cat([zeros, mat_tbl[w // K, w % K][..., None]], dim=-1)
    return _winner_payload(t_best, win, cols, prev)


def sweep_layout(ray_block: int) -> tuple[int, int, int]:
    """(CTAs, lane groups, passes) of both sweep kernels for one ray block
    (csrc/sweep_skeleton.cuh): a thread block cluster of up to SWEEP_CTAS
    CTAs, one per 128 rays, holds the block's rays, SWEEP_GROUPS threads
    per ray, each testing every SWEEP_GROUPS-th slot.  Past 1,024 threads
    per CTA the cluster grows to 8 CTAs, then the groups shrink to one
    thread per ray; a ray block larger still (above 8,192 rays) takes
    several passes per visit, 8,192 rays each."""
    ctas, groups = min(SWEEP_CTAS, max(1, ray_block // 128)), SWEEP_GROUPS
    while -(-ray_block // ctas) * groups > 1024 and (ctas < 8 or groups > 1):
        if ctas < 8:
            ctas *= 2
        else:
            groups //= 2
    return ctas, groups, -(-ray_block // (ctas * 1024 // groups))


def _sweep_launch(tag, C, nact, clist, bt0, rays, prev, tables, visits,
                  tail=()):
    """Launch B1 or B2 over C clusters -> payload (RB, B, 16).  ``tables``
    holds the kernel's tables as (name, table, shape) rows, passed after
    ``prev``; ``tail`` (name, tensor or None, dtype, shape) rows passed
    after the scratch state (B2's vote counts).  The kernel takes the ray
    blocks in order of falling ``nact`` (one device argsort here, no host
    sync)."""
    RB, B, _ = rays.shape
    f32, i32 = torch.float32, torch.int32
    ins = (("rays", rays, f32, (RB, B, PAYLOAD_COLS)),
           ("prev", prev, f32, (RB, B, PAYLOAD_COLS)),
           *((name, t, f32, shape) for name, t, shape in tables),
           ("nact", nact, i32, (RB,)),
           ("clist", clist, i32, (RB, C)),
           ("bt0", bt0, f32, (RB, C)),
           ("visits", visits, i32, (RB,)), *tail)
    out = torch.empty_like(prev)
    ctas, groups, passes = sweep_layout(B)
    state = None if passes == 1 else torch.empty((RB * B, 2), dtype=i32,
                                                 device=rays.device)
    order = torch.argsort(nact, descending=True, stable=True).to(i32)
    launches.launch(tag, rays.device, ins, [
        nact, clist, bt0, order, rays, prev, *(t for _, t, _ in tables), out,
        visits, state, *(t for _, t, _, _ in tail), RB, B, C, ctas, groups,
        passes])
    return out


def check_mxu_form(trisW) -> None:
    """Raise unless ``trisW`` has the form ``mxu_tables_from_coords`` gives
    it, which csrc/cluster_sweep_mxu.cu relies on: in each cluster's
    (8, 6, 128) view the d-fields Q, Bu, Bv are zero outside rows 3-5, the
    o-fields P, Au, Av zero in rows 3-5 and 7, and each o-field's rows 0-2
    equal its d-field's rows 3-5 (n, au, av).  A table that passes
    remembers the version it passed at, so a static table is checked once
    (one host sync); an in-place edit is checked again."""
    if getattr(trisW, "_mxu_form_version", None) == trisW._version:
        return
    W = trisW.reshape(-1, MXU_ROWS, MXU_FIELDS, CLUSTER_TRIS)
    d_f, o_f = W[:, :, 0::2], W[:, :, 1::2]
    zero = torch.cat([d_f[:, 0:3], d_f[:, 6:8], o_f[:, 3:6], o_f[:, 7:8]],
                     dim=1)
    if not bool(torch.all(zero == 0.0) & torch.all(d_f[:, 3:6] == o_f[:, 0:3])):
        raise ValueError(
            "cluster_sweep_mxu_kernel: trisW is not of the plane form of "
            "mxu_tables_from_coords (a structural entry is not zero, or n, "
            "au, av differ from their copies)")
    trisW._mxu_form_version = trisW._version


def cluster_sweep_kernel(nact, clist, bt0, rays, prev, tris, visits=None):
    """Sweep every ray block over its active clusters (the inputs of
    ``cluster_sweep_plain``) -> payload (RB, B, 16).

    On CUDA tensors this launches the Hopper kernel (csrc/cluster_sweep.cu)
    through ``launches.launch``, on the current stream without
    synchronising, counted under B1; on CPU tensors it runs the plain twin.
    Any ray block size is taken (``sweep_layout``); any other device, dtype,
    shape or layout raises.
    """
    if rays.device.type == "cpu":
        return cluster_sweep_plain(nact, clist, bt0, rays, prev, tris, visits)
    if rays.device.type != "cuda":
        raise ValueError(f"cluster_sweep_kernel: unsupported device {rays.device}")
    C = tris.shape[0] // CLUSTER_ROWS
    return _sweep_launch("B1", C, nact, clist, bt0, rays, prev, (
        ("tris", tris, (C * CLUSTER_ROWS, CLUSTER_TRIS)),), visits)


def cluster_sweep_mxu_kernel(nact, clist, bt0, rays, prev, trisW, mat_tbl,
                             visits=None, counts=None):
    """Sweep every ray block over its active clusters with the plane-form
    test (the inputs of ``cluster_sweep_mxu_plain``) -> payload (RB, B, 16).

    On CUDA tensors this launches the Hopper kernel
    (csrc/cluster_sweep_mxu.cu) through ``launches.launch``, on the current
    stream without synchronising, counted under B2; on CPU tensors it runs
    the plain twin.  On both, ``trisW`` must pass ``check_mxu_form``.  Any
    ray block size is taken (``sweep_layout``); any other device, dtype,
    shape or layout raises.  ``counts`` (3,) int64 on the card, if given,
    receives the kernel's (warp, slot step) pairs tested and those that
    passed its t and u votes (ray blocks taken in one pass only).
    """
    who = "cluster_sweep_mxu_kernel"
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {rays.device}")
    if rays.device.type == "cpu" and counts is not None:
        raise ValueError(f"{who}: vote counts exist on the card only")
    check_mxu_form(trisW)
    if rays.device.type == "cpu":
        return cluster_sweep_mxu_plain(nact, clist, bt0, rays, prev, trisW,
                                       mat_tbl, visits)
    if counts is not None and sweep_layout(rays.shape[1])[2] > 1:
        raise ValueError(f"{who}: vote counts need a ray block taken in one "
                         "pass")
    C = trisW.shape[0] // MXU_ROWS
    return _sweep_launch("B2", C, nact, clist, bt0, rays, prev, (
        ("trisW", trisW, (C * MXU_ROWS, MXU_FIELDS * CLUSTER_TRIS)),
        ("mat_tbl", mat_tbl, (C, CLUSTER_TRIS))), visits,
        (("counts", counts, torch.int64, (3,)),))
