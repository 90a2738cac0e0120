"""Cluster-sweep renderer: the closest-hit backend for meshed scenes (port of
the JAX package's render/sweep.py).

Only the closest-hit query differs from render/golden.py: spheres are
searched brute force, triangles through kernels/cluster.py, and the winner
is re-shaded by golden.resolve_hit with the brute path's selection rules.
Rays can be regrouped before the sweep (``cfg.ray_sort``) so each block of
the kernel sees a tight frustum; every mode gives the same hits except on
exact cross-cluster t-ties.  ``cfg.cluster_kernel`` picks the block test:
"mt" (Möller-Trumbore) or "mxu" (the plane form, with its own tables).

The search is detached; the re-shade fetches the winner's vertices by an
index gather from the slot id in payload column 11 through the ATTACHED
``cluster.vertex_slabs``, so vertex gradients can flow through it.  NEE's
shadow rays go through ``occluded_sweep``: the same sweep bounded at the
light's distance, with no re-shade.  The silhouette estimator's widened
primary query (``cfg.edge_grads``) goes through
``tri_edge_candidate_sweep``: the Möller-Trumbore sweep over
miter-expanded tables, under either ``cluster_kernel``.
"""

from __future__ import annotations

import torch

from wc_path_tracer_tpu_torch.kernels import cluster
from wc_path_tracer_tpu_torch.ops import intersect as ix
from wc_path_tracer_tpu_torch.render import golden
from wc_path_tracer_tpu_torch.scene.types import Scene
from wc_path_tracer_tpu_torch.utils import profiling
from wc_path_tracer_tpu_torch.utils.config import RenderConfig

KINF = ix.KINFINITY


def _tile_permuter(R: int, cfg: RenderConfig):
    """Pixel -> ~32x32 tile regrouping as a reshape/transpose -> (fwd, inv),
    or None when R does not factor into tiles."""
    W = cfg.width
    if R % W:
        return None
    rows = R // W
    th = 1
    while th < 32 and rows % (th * 2) == 0:
        th *= 2
    tw = 1
    while th * tw < cluster.RAY_BLOCK and W % (tw * 2) == 0:
        tw *= 2
    if th * tw < 4:
        return None

    def fwd(x):
        s = x.shape[1:]
        return x.reshape(rows // th, th, W // tw, tw, *s).transpose(1, 2) \
            .reshape(R, *s)

    def inv(x):
        s = x.shape[1:]
        return x.reshape(rows // th, W // tw, th, tw, *s).transpose(1, 2) \
            .reshape(R, *s)

    return fwd, inv


def _morton_key(origin, direction, lo, hi, active=None):
    """(R,) int64 coherence key: inactivity (bit 15: terminated rays sort to
    the end, into all-dead blocks), direction octant (bits 12-14), then a
    12-bit Morton code of the origin on a 16^3 grid over [lo, hi]."""
    d = direction
    octant = ((d[:, 0] < 0).long() * 4 + (d[:, 1] < 0).long() * 2
              + (d[:, 2] < 0).long())
    ext = torch.maximum(hi - lo, torch.full_like(hi, 1e-6))
    q = torch.clamp((origin - lo) / ext * 16.0, 0.0, 15.0).long()
    morton = torch.zeros_like(octant)
    for b in range(4):
        for ax, off in ((0, 2), (1, 1), (2, 0)):
            morton = morton | (((q[:, ax] >> b) & 1) << (3 * b + off))
    key = (octant << 12) | morton
    if active is not None:
        key = key | ((~active).long() << 15)
    return key


def _sort_permuter(origin, direction, cmin, cmax, active=None, scene=None):
    """Morton-sort rays for block coherence -> (fwd, inv).  The grid bounds
    are the mesh clusters' bounds widened by the live spheres, but by at
    most one mesh extent (a huge ground sphere would otherwise collapse the
    mesh into a few cells)."""
    lo = torch.amin(cmin, dim=0)
    hi = torch.amax(cmax, dim=0)
    if scene is not None:
        ext = torch.maximum(hi - lo, torch.full_like(hi, 1e-6))
        sph = scene.spheres
        live = (torch.arange(sph.capacity, device=lo.device)
                < sph.count)[:, None]
        pos, rad = sph.position.detach(), sph.radius.detach()[:, None]
        slo = torch.amin(torch.where(live, pos - rad, KINF), dim=0)
        shi = torch.amax(torch.where(live, pos + rad, -KINF), dim=0)
        lo = torch.maximum(torch.minimum(lo, slo), lo - ext)
        hi = torch.minimum(torch.maximum(hi, shi), hi + ext)
    perm = torch.argsort(_morton_key(origin, direction, lo, hi, active),
                         stable=True)

    def fwd(x):
        return x[perm]

    def inv(x):
        out = torch.empty_like(x)
        out[perm] = x
        return out

    return fwd, inv


def _permuter(origin, direction, cfg, cmin, cmax, active=None, scene=None):
    if cfg.ray_sort == "dynamic":
        return _sort_permuter(origin, direction, cmin, cmax, active, scene)
    if cfg.ray_sort == "static":
        return _tile_permuter(origin.shape[0], cfg)
    return None


def build_tables(mesh, cfg: RenderConfig | None):
    """Detached cluster tables matched to ``cfg.cluster_kernel``: a 3-tuple
    (tris, cmin, cmax) for the MT kernel, a 4-tuple (trisW, cmin, cmax,
    mat_tbl) for the plane-form ("mxu") kernel."""
    with torch.no_grad():
        if cfg is not None and cfg.cluster_kernel == "mxu":
            return cluster.build_cluster_tables_mxu(mesh)
        return cluster.build_cluster_tables(mesh)


def _unpack_tables(tables):
    """-> (tris, cmin, cmax, mat_tbl, variant) from either tuple shape."""
    if len(tables) == 4:
        tris, cmin, cmax, mat_tbl = tables
        return tris, cmin, cmax, mat_tbl, "mxu"
    tris, cmin, cmax = tables
    return tris, cmin, cmax, None, "mt"


def _sweep(origin, direction, t_init, tables, cfg: RenderConfig, block_fn,
           active=None, scene=None):
    """``cluster.cluster_sweep`` of detached rays over ``tables`` (either
    variant), in the order ``cfg.ray_sort`` regroups them (``_permuter``
    with ``active`` and ``scene``), the payload back in ray order."""
    tris, cmin, cmax, mat_tbl, variant = _unpack_tables(tables)
    kw = dict(ray_block=cfg.ray_block or cluster.RAY_BLOCK, block_fn=block_fn,
              variant=variant, mat_tbl=mat_tbl)
    with profiling.stage("sweep.sort"):
        perm = _permuter(origin, direction, cfg, cmin, cmax, active=active,
                         scene=scene)
        if perm is not None:
            fwd, inv = perm
            origin, direction, t_init = map(fwd, (origin, direction, t_init))
    pay = cluster.cluster_sweep(origin, direction, t_init, tris, cmin, cmax,
                                **kw)
    if perm is None:
        return pay
    with profiling.stage("sweep.sort"):
        return inv(pay)


def intersect_scene_sweep(scene: Scene, origin, direction, cfg: RenderConfig,
                          tables=None, vslabs=None, alive=None, block_fn=None):
    """Closest-hit query through the cluster sweep.

    ``tables``/``vslabs``: prebuilt ``build_tables`` / attached
    ``cluster.vertex_slabs`` (make_intersect_fn builds them once per frame).
    ``alive``: optional (R,) bool of lanes the transport has not terminated;
    the others get a -KINF search bound, cull to zero clusters and (under
    the dynamic sort) form all-dead blocks the kernel skips.  CONTRACT: on
    non-alive lanes only ``t`` of the returned record is defined; every
    consumer masks the rest, as golden._bounce_segment does.
    ``block_fn``: the block sweep (default: the variant's CUDA kernel
    wrapper, by ``cfg.cluster_kernel``).
    """
    o_ng, d_ng = origin.detach(), direction.detach()
    t_s, sph_center, sph_radius, sph_material = golden.sphere_closest(
        scene, origin, direction, cfg)
    if tables is None:
        tables = build_tables(scene.mesh, cfg)
    t_bound = t_s if alive is None else torch.where(alive, t_s, -KINF)
    pay = _sweep(o_ng, d_ng, t_bound, tables, cfg, block_fn, active=alive,
                 scene=scene)
    t_tri = pay[:, 0]
    if alive is not None:
        # dead lanes: restore the unbounded t (t == t_init on a miss)
        t_tri = torch.where(alive, t_tri, t_s)
    tri_hit = pay[:, 11] >= 0.0

    with profiling.stage("sweep.reshade"):
        if vslabs is None:
            vslabs = cluster.vertex_slabs(scene.mesh)
        slot = pay[:, 11].to(torch.int64).clamp_min(0)
        # attached; index_select's backward (index_add_) does not serialize
        # the lanes that share a slot
        coords = vslabs.reshape(9, -1).index_select(1, slot)     # (9, R)
        return golden.resolve_hit(
            origin, direction, cfg, t_s, sph_center, sph_radius,
            sph_material, t_tri, tri_hit, coords[0:3].T, coords[3:6].T,
            coords[6:9].T, pay[:, 10].to(torch.int32))


@torch.no_grad()
def occluded_sweep(scene: Scene, origin, direction, max_dist,
                   cfg: RenderConfig, tables=None, block_fn=None):
    """Any-hit shadow query for NEE -> (R,) bool: spheres brute force, then
    the cluster sweep bounded at ``max_dist`` (the bound doubles as the
    early out: triangles past the light never win).  Lanes with a
    non-positive bound can occlude nothing (the transport disables lanes
    with -inf); they are inactive for the dynamic sort, so they gather in
    blocks the kernel skips.  ``tables``/``block_fn`` as in
    intersect_scene_sweep."""
    origin, direction = origin.detach(), direction.detach()
    max_dist = max_dist.detach()
    s_occ = golden.sphere_occluded(scene, origin, direction, max_dist, cfg)
    if tables is None:
        tables = build_tables(scene.mesh, cfg)
    pay = _sweep(origin, direction, max_dist, tables, cfg, block_fn,
                 active=max_dist > 0.0, scene=scene)
    return s_occ | (pay[:, 11] >= 0.0)


def tri_edge_candidate_sweep(scene: Scene, origin, direction,
                             cfg: RenderConfig, pix_ang, vslabs=None,
                             block_fn=None):
    """The silhouette estimator's widened primary query through the cluster
    sweep (``golden.tri_edge_candidate_brute``'s result on meshed scenes):
    the triangles are miter-expanded by 0.55 pixel footprints at their
    distance from the camera (``origin[0]``), put in Möller-Trumbore tables
    and swept from ``t_init = KINF``, with the ray regrouping of the
    closest-hit queries.  The search is detached; the winner's true
    vertices come ATTACHED from ``vslabs`` (``cluster.vertex_slabs``) by
    ``index_select`` on payload column 11, its neighbor normals detached
    from ``cluster.neighbor_slabs``; ``golden._tri_edge_eval`` evaluates
    it.  ``block_fn``: the block sweep, default B1's kernel wrapper."""
    o_ng, d_ng = origin.detach(), direction.detach()
    with torch.no_grad():
        a, b, c, mat, lv, C = cluster._padded_tri_coords(scene.mesh)
        margin = golden._edge_margin(a, b, c, o_ng, pix_ang) * lv.float()
        tables = cluster.tables_from_coords(
            *golden._expand_triangles(a, b, c, margin), mat, lv, C)
        t_init = torch.full((o_ng.shape[0],), KINF, device=o_ng.device)
        pay = _sweep(o_ng, d_ng, t_init, tables, cfg, block_fn, scene=scene)
        found = pay[:, 11] >= 0.0
        slot = pay[:, 11].to(torch.int64).clamp_min(0)
        nslabs, oslabs = cluster.neighbor_slabs(scene.mesh)
        nbrn = nslabs.reshape(9, -1)[:, slot].T.reshape(-1, 3, 3)
        nbrok = oslabs.reshape(3, -1)[:, slot].T > 0.5
    if vslabs is None:
        vslabs = cluster.vertex_slabs(scene.mesh)
    coords = vslabs.reshape(9, -1).index_select(1, slot)     # (9, R)
    return golden._tri_edge_eval(
        origin, direction, coords[0:3].T, coords[3:6].T, coords[6:9].T,
        pay[:, 10].to(torch.int32), nbrn, nbrok, found, pix_ang)


intersect_scene_sweep.occlusion_fn = occluded_sweep
intersect_scene_sweep.edge_tri_fn = tri_edge_candidate_sweep


def make_intersect_fn(scene: Scene, cfg: RenderConfig | None = None,
                      block_fn=None):
    """intersect_fn with the cluster tables and vertex slabs built once per
    frame and shared by every bounce's closest-hit and NEE shadow query and
    by the silhouette query (``edge_tri_fn``, whose expanded tables depend
    on the camera and are built per call).  ``block_fn`` overrides the
    block sweep of all three, e.g. ``cluster.cluster_sweep_plain`` (or,
    under ``cluster_kernel="mxu"``, ``cluster.cluster_sweep_mxu_plain``) to
    render through the plain twin on the card.  The silhouette query sweeps
    Möller-Trumbore tables under either kernel, so under "mxu" it takes B1
    (``cluster_sweep_plain`` where ``block_fn`` is B2's twin)."""
    with profiling.stage("sweep.tables"):
        tables = build_tables(scene.mesh, cfg)
        vslabs = cluster.vertex_slabs(scene.mesh)
    edge_block_fn = block_fn
    if len(tables) == 4:
        edge_block_fn = {cluster.cluster_sweep_mxu_plain:
                         cluster.cluster_sweep_plain}.get(block_fn)

    def fn(scene, origin, direction, cfg, alive=None):
        return intersect_scene_sweep(scene, origin, direction, cfg,
                                     tables=tables, vslabs=vslabs,
                                     alive=alive, block_fn=block_fn)

    def occlusion_fn(scene, origin, direction, max_dist, cfg):
        return occluded_sweep(scene, origin, direction, max_dist, cfg,
                              tables=tables, block_fn=block_fn)

    def edge_tri_fn(scene, origin, direction, cfg, pix_ang):
        return tri_edge_candidate_sweep(scene, origin, direction, cfg,
                                        pix_ang, vslabs=vslabs,
                                        block_fn=edge_block_fn)

    fn.accepts_alive = True
    fn.occlusion_fn = occlusion_fn
    fn.edge_tri_fn = edge_tri_fn
    return fn


def trace_rays(scene, origin, direction, seed, cfg):
    """``golden.trace_rays`` of a ray batch through the cluster sweep."""
    return golden.trace_rays(scene, origin, direction, seed, cfg,
                             intersect_fn=make_intersect_fn(scene, cfg))


def render_rows(scene, mats, cfg, frame_count, y0, num_rows):
    """Rows [y0, y0 + num_rows) through the cluster sweep."""
    return golden.render_rows(scene, mats, cfg, frame_count, y0, num_rows,
                              intersect_fn=make_intersect_fn(scene, cfg))


def render_frame(scene, mats, cfg, frame_count):
    """One frame through the cluster sweep (golden transport)."""
    return render_rows(scene, mats, cfg, frame_count, 0, cfg.height)
