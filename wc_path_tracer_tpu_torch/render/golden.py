"""Brute-force path tracer and the shared light transport (port of the JAX
package's render/golden.py; reference: the megakernel
src/shaders/pathTracer.comp).

One tensor lane per ray; a Python loop over the ``max_bounces + 1`` bounce
segments; closest-hit queries go through an injectable ``intersect_fn``
(brute force here, the cluster sweep in render/sweep.py) while this module
stays the single source of truth for shading.  The reference's quirks are
kept: near-root-only spheres, flat triangle normals, no pixel jitter unless
asked, and per-lane PCG streams that advance exactly like the reference's
per-thread streams (masked draws).

Where the JAX package selected winners with one-hot matmuls (a TPU device),
the port uses index gathers with an explicit first-min rule (``_first_min``:
the minimum, then the lowest index among equal values), never relying on
``argmin``'s tie order; small tables (materials, spheres, the brute path's
triangle slots) are gathered by ``take_rows``, whose backward is the JAX
package's one-hot matmul.  Next-event estimation (``use_nee``) connects one
light per lane, picked by area x luminance, and under ``mis`` weights both
strategies by the balance heuristic; its shadow query is the backend's
``occlusion_fn`` where it registers one, else its full closest hit.

Where grad mode is off, NEE is off and the lanes lie on the card
(``_fused_materials``), the shading after each segment's query is one
launch of the hand-written kernel T1 (``kernels/shade.py``); ``_bounce``
stays its plain twin, bit for bit, and runs everywhere else.  Where the
lanes lie on the card, the brute-force query's search is one launch of H1
(``kernels/brute.py``), in grad mode too; ``_brute_search`` is its twin.

``edge_grads`` (the silhouette estimator, ``trace_rays_edge``) widens the
primary query by half a pixel around sphere limbs and miter-expanded
triangles, traces a hit path and a background path per ray and blends them
by the analytic coverage, so the image is continuous in geometry and
camera; NEE's sphere occluders become penumbra ramps.  ``compact``
(``trace_rays_compact``) runs the later bounces on the prefix of blocks
that holds the live lanes only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wc_path_tracer_tpu_torch.kernels import brute, shade
from wc_path_tracer_tpu_torch.ops import bsdf
from wc_path_tracer_tpu_torch.ops import intersect as ix
from wc_path_tracer_tpu_torch.ops import rng
from wc_path_tracer_tpu_torch.scene.camera import CameraMatrices, primary_ray_directions
from wc_path_tracer_tpu_torch.scene.types import (
    MATERIAL_DIELECTRIC, MATERIAL_GGX, MATERIAL_LAMBERTIAN, MATERIAL_METAL,
    Scene)
from wc_path_tracer_tpu_torch.utils import profiling
from wc_path_tracer_tpu_torch.utils.config import RenderConfig

BIAS = float(np.float32(1e-5))    # constants.glsl bias
KINF = ix.KINFINITY
# f32 constants rounded as the JAX package rounds them (F32(2.0) * pi etc.)
_TWO_PI = float(np.float32(2.0) * np.float32(np.pi))
_FOUR_PI = float(np.float32(4.0) * np.float32(np.pi))
_LUM = tuple(float(np.float32(w)) for w in (0.2126, 0.7152, 0.0722))


@dataclasses.dataclass
class HitRecord:
    """Vectorized mirror of the reference HitInfo (pathTracer.comp:50-58)."""

    t: torch.Tensor         # (R,)
    p: torch.Tensor         # (R, 3)
    normal: torch.Tensor    # (R, 3) — flipped to face the ray
    hit: torch.Tensor       # (R,) bool
    front: torch.Tensor     # (R,) bool
    material: torch.Tensor  # (R,) int32


class _TakeRows(torch.autograd.Function):
    """``table[idx]`` whose backward is one one-hot matmul."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        onehot = idx[None, :] == torch.arange(ctx.rows, device=idx.device)[
            :, None]
        g = onehot.double() @ grad.reshape(grad.shape[0], -1).double()
        return g.to(grad.dtype).view((ctx.rows,) + grad.shape[1:]), None


def take_rows(table, idx):
    """Rows of a small table (materials, spheres, the brute path's triangle
    slots) at per-lane indices.  The forward is an exact index gather; the
    backward is ``onehot(idx)^T @ grad`` in float64 (deterministic, and
    independent of the TF32 setting), where the index gather's own backward,
    an accumulating index_put, serializes the many lanes that share a row
    and took ~95 % of a 1024^2 fwd+bwd step on the card.  The JAX package
    gathers these tables by one-hot matmuls for the same reason."""
    return _TakeRows.apply(table, idx)


def _first_min(t):
    """(t_min, idx) over the last axis: the lowest index among the minima."""
    t_min = torch.amin(t, dim=-1)
    P = t.shape[-1]
    iota = torch.arange(P, device=t.device)
    idx = torch.amin(torch.where(t == t_min[..., None], iota, P), dim=-1)
    return t_min, idx


def _live_triangle_mask(scene: Scene):
    """(T,) bool — triangle slots that belong to a live draw command."""
    mesh = scene.mesh
    return (mesh.tri_draw >= 0) & (mesh.tri_draw < mesh.draw_count)


def triangle_vertices(mesh):
    """Per-slot bank-global vertex rows (a, b, c), each (T, 3): indices are
    draw-relative, rebased with each triangle's draw vertex offset."""
    voff = mesh.draw_vertex_offset[mesh.tri_draw.clamp_min(0)]
    tri = mesh.indices.view(-1, 3) + voff[:, None]
    return (mesh.vertices[tri[:, 0]], mesh.vertices[tri[:, 1]],
            mesh.vertices[tri[:, 2]])


def _sphere_search(scene: Scene, origin, direction, cfg: RenderConfig):
    """Detached closest-sphere search -> (t (R,) with KINF on a miss, the
    winning slot (R,)).  Earliest sphere wins a tie."""
    sph = scene.spheres
    near, far = ix.ray_sphere_sweep(origin.detach(), direction.detach(),
                                    sph.position.detach(),
                                    sph.radius.detach())            # (R, S)
    s_live = torch.arange(sph.capacity, device=near.device) < sph.count
    if cfg.sphere_near_root_only:
        t_cand = near   # quirk 1: only the near root (pathTracer.comp:141)
    else:
        t_cand = torch.where(near > 0.0, near, far)
    t_sph = torch.where(s_live & (t_cand > 0.0), t_cand, KINF)
    return _first_min(t_sph)


def _sphere_rows(scene: Scene, idx):
    """The winning spheres' center, radius and material."""
    sph = scene.spheres
    pr = take_rows(torch.cat([sph.position, sph.radius[:, None]], 1), idx)
    return pr[:, 0:3], pr[:, 3], sph.material[idx]


def sphere_closest(scene: Scene, origin, direction, cfg: RenderConfig):
    """Detached closest-sphere search -> (t (R,) with KINF on a miss, and the
    winner's center, radius, material).  Earliest sphere wins a tie."""
    t_s, idx = _sphere_search(scene, origin, direction, cfg)
    return (t_s,) + _sphere_rows(scene, idx)


def resolve_hit(origin, direction, cfg: RenderConfig, t_s, sph_center,
                sph_radius, sph_material, t_tri, tri_hit, a, b, c,
                tri_material) -> HitRecord:
    """Combine the detached sphere and triangle winners into a HitRecord,
    re-shading the winner differentiably from its own parameters.

    The triangle wins only if strictly closer (pathTracer.comp:171); the
    normal is flat for triangles, flipped to face the ray, with ``front``
    recorded (:206-207).  Miss lanes get finite placeholders so no inf/NaN
    reaches an unselected ``where`` branch in reverse mode.
    """
    use_tri = tri_hit & (t_tri < t_s)
    hit = torch.minimum(t_tri, t_s) < KINF

    unit = torch.eye(3, dtype=a.dtype, device=a.device)
    safe = tri_hit[:, None]
    a = torch.where(safe, a, 0.0)
    b = torch.where(safe, b, unit[0])
    c = torch.where(safe, c, unit[1])
    t_tri_w = ix.ray_triangle_reshade(origin, direction, a, b, c)

    near_w, far_w = ix.ray_sphere(origin, direction, sph_center, sph_radius)
    if cfg.sphere_near_root_only:
        t_sph_w = near_w
    else:
        t_sph_w = torch.where(near_w.detach() > 0.0, near_w, far_w)

    t_best = torch.where(use_tri, t_tri_w, t_sph_w)
    t_safe = torch.where(hit, t_best, 1.0)
    p = origin + t_safe[:, None] * direction

    safe_radius = torch.where(sph_radius.detach() > 0.0, sph_radius, 1.0)
    n_sph = (p - sph_center) / safe_radius[:, None]        # pathTracer.comp:145
    n_tri = ix.normalize(ix.cross(b - a, c - a), eps=1e-20)  # flat, :173

    normal = torch.where(use_tri[:, None], n_tri, n_sph)
    material = torch.where(use_tri, tri_material, sph_material)
    front = ix.dot3(direction.detach(), normal.detach()) < 0.0
    normal = torch.where(front[:, None], normal, -normal)
    normal = torch.where(hit[:, None], normal,
                         torch.tensor([0.0, 0.0, 1.0], device=normal.device))
    return HitRecord(t=t_safe, p=p, normal=normal, hit=hit, front=front,
                     material=material.to(torch.int32))


def _brute_search(scene: Scene, origin, direction, cfg: RenderConfig,
                  a, b, c):
    """The detached discrete search of ``intersect_scene_brute`` over every
    sphere slot and every triangle slot (vertex rows ``a``, ``b``, ``c``)
    -> (t_s, s_idx, t_tri, t_idx): each set's ``_first_min`` over its live
    hits, KINF and slot 0 where nothing counts.  The plain twin of H1
    (kernels/brute.py), bit for bit."""
    t_s, s_idx = _sphere_search(scene, origin, direction, cfg)
    t_t, t_hit = ix.ray_triangle_sweep(origin.detach(), direction.detach(),
                                       a.detach(), b.detach(),
                                       c.detach())                    # (R, T)
    t_tri, t_idx = _first_min(torch.where(t_hit & _live_triangle_mask(scene),
                                          t_t, KINF))
    return t_s, s_idx, t_tri, t_idx


def intersect_scene_brute(scene: Scene, origin, direction,
                          cfg: RenderConfig) -> HitRecord:
    """Closest-hit query against every sphere and triangle (masked brute
    force), with the selection semantics of the reference Intersect
    (pathTracer.comp:135-211): spheres first with the earliest index winning
    ties, triangles override only when strictly closer.

    The search is one launch of H1 where the lanes lie on the card (its
    lanes counted as ``brute.lanes``), else ``_brute_search``; the winners
    are re-shaded differentiably either way."""
    mesh = scene.mesh
    a_all, b_all, c_all = triangle_vertices(mesh)
    if brute.on_card(direction):
        profiling.count("brute.lanes", direction.shape[0])
        sph = scene.spheres
        t_s, s_idx, t_tri, idx = brute.brute_hit_kernel(
            origin, direction, sph.position, sph.radius, sph.count, a_all,
            b_all, c_all, mesh.tri_draw, mesh.draw_count,
            cfg.sphere_near_root_only)
    else:
        t_s, s_idx, t_tri, idx = _brute_search(scene, origin, direction, cfg,
                                               a_all, b_all, c_all)
    sph_center, sph_radius, sph_material = _sphere_rows(scene, s_idx)
    abc = take_rows(torch.cat([a_all, b_all, c_all], 1), idx)
    return resolve_hit(origin, direction, cfg, t_s, sph_center, sph_radius,
                       sph_material, t_tri, t_tri < KINF, abc[:, 0:3],
                       abc[:, 3:6], abc[:, 6:9], mesh.tri_material[idx])


def sphere_occluded(scene: Scene, origin, direction, max_dist,
                    cfg: RenderConfig):
    """(R,) bool: a live sphere root in (0, max_dist), with the closest-hit
    query's root rule (near root only under quirk 1).  Detached inputs."""
    sph = scene.spheres
    near, far = ix.ray_sphere_sweep(origin, direction, sph.position.detach(),
                                    sph.radius.detach())
    s_live = torch.arange(sph.capacity, device=near.device) < sph.count
    if cfg.sphere_near_root_only:
        t_cand = near
    else:
        t_cand = torch.where(near > 0.0, near, far)
    return torch.any(s_live & (t_cand > 0.0) & (t_cand < max_dist[:, None]),
                     dim=-1)


@torch.no_grad()
def occluded_brute(scene: Scene, origin, direction, max_dist,
                   cfg: RenderConfig):
    """Boolean any-hit shadow query: does any primitive block ``origin +
    t*direction`` for t in (0, max_dist)?  Visibility carries no gradient,
    so nothing is re-shaded; the selection rules are intersect_scene_brute's
    (near-root-only spheres, live masks), so ``occluded == (closest_hit.t <
    max_dist)`` bit for bit."""
    origin, direction = origin.detach(), direction.detach()
    max_dist = max_dist.detach()
    s_occ = sphere_occluded(scene, origin, direction, max_dist, cfg)
    a, b, c = (x.detach() for x in triangle_vertices(scene.mesh))
    t_t, t_hit = ix.ray_triangle_sweep(origin, direction, a, b, c)
    t_occ = torch.any(t_hit & _live_triangle_mask(scene)
                      & (t_t < max_dist[:, None]), dim=-1)
    return s_occ | t_occ


# the brute backend's registered any-hit (sample_direct_light's
# ``occlusion_fn`` protocol, shared by the sweep backend)
intersect_scene_brute.occlusion_fn = occluded_brute


def _expand_triangles(a, b, c, margin):
    """Detached in-plane offset of each triangle's edges outward by
    ``margin`` (T,), for the widened silhouette search: every edge line
    moves out by exactly ``margin``, corners are mitered with the miter
    factor clamped at 0.25 (sliver corners would spike).  Zero-area
    (padding) triangles stay degenerate."""

    def outward(p0, p1, q):
        e = p1 - p0
        ee = _at_least(ix.dot3(e, e), 1e-12)[:, None]
        w = q - p0
        w_perp = w - e * (ix.dot3(w, e)[:, None] / ee)
        return -w_perp / torch.sqrt(_at_least(ix.dot3(w_perp, w_perp),
                                              1e-12))[:, None]

    n_ab = outward(a, b, c)
    n_bc = outward(b, c, a)
    n_ca = outward(c, a, b)
    mm = margin[:, None]

    def corner(v, n1, n2):
        denom = _at_least(1.0 + ix.dot3(n1, n2), 0.25)[:, None]
        return v + mm * (n1 + n2) / denom

    return corner(a, n_ca, n_ab), corner(b, n_ab, n_bc), corner(c, n_bc, n_ca)


_DSIL_NONE = float(np.float32(1e9))   # "no silhouette edge" distance
# |cos| below which a neighbor counts as on the horizon: at a tessellated
# fold every adjacent face can be a barely front-facing sliver that covers
# no ray, so the strict front/back flip misses the visible silhouette.
# Edges whose neighbor is within ~81 degrees of edge-on count as silhouette;
# the cost is a one-pixel ramp on steeply grazing interior edges.
_HORIZON_COS = float(np.float32(0.15))


def _tri_edge_eval(origin, direction, a, b, c, material, nbrn, nbrok,
                   found, pix_ang):
    """Evaluate the widened triangle query's winner: the attached plane-park
    ``t``, the flat normal and the coverage ``alpha``.

    ``a``/``b``/``c`` are the winner's ATTACHED vertices, ``nbrn`` (R, 3, 3)
    the detached normals of the neighbors across edges (a,b), (b,c), (c,a)
    and ``nbrok`` (R, 3) whether each exists and is live.  Only SILHOUETTE
    edges ramp the coverage: a boundary, a front/back flip between the two
    faces, or a neighbor on the horizon; shared interior edges of a surface
    keep alpha = 1."""
    unit = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                        dtype=a.dtype, device=a.device)
    safe = found[:, None]
    a = torch.where(safe, a, unit[0])
    b = torch.where(safe, b, unit[1])
    c = torch.where(safe, c, unit[2])
    t_w = ix.ray_triangle_reshade(origin, direction, a, b, c)
    t_ok = found & (t_w.detach() > 0.0) & (t_w.detach() < KINF)
    t_w = torch.where(t_ok, t_w, 1.0)
    x = origin + t_w[:, None] * direction
    n_tri = ix.cross(b - a, c - a)

    def edge_dist(p0, p1, q):
        # signed in-plane distance of x from the edge line (p0, p1),
        # positive toward the opposite vertex q (inside)
        e = p1 - p0
        ee = _at_least(ix.dot3(e, e), 1e-12)
        w = q - p0
        wp = w - e * (ix.dot3(w, e) / ee)[:, None]
        nin = wp / torch.sqrt(_at_least(ix.dot3(wp, wp), 1e-12))[:, None]
        return ix.dot3(x - p0, nin)

    dists = (edge_dist(a, b, c), edge_dist(b, c, a), edge_dist(c, a, b))
    d_ng = direction.detach()
    dn_i = ix.dot3(d_ng, n_tri.detach())
    dlen = torch.sqrt(_at_least(ix.dot3(d_ng, d_ng), 1e-12))
    d_sil = torch.full_like(dn_i, _DSIL_NONE)
    for k, dk in enumerate(dists):
        nbk = nbrn[:, k, :]
        dn_k = ix.dot3(d_ng, nbk)
        nk_len = torch.sqrt(_at_least(ix.dot3(nbk, nbk), 1e-12))
        graze = torch.abs(dn_k) < _HORIZON_COS * nk_len * dlen
        sil = (~nbrok[:, k]) | (dn_i * dn_k < 0.0) | graze
        d_sil = torch.minimum(d_sil, torch.where(sil, dk, _DSIL_NONE))
    w = pix_ang.detach() * _at_least(t_w.detach(), 1e-3)
    alpha = torch.clamp(0.5 + d_sil / w, 0.0, 1.0)
    alpha = torch.where(t_ok, alpha, 1.0)
    # candidates wholly outside the band occlude nothing (the miters can
    # overshoot the half-pixel band by ~a quarter pixel at corners)
    t_ok = t_ok & (alpha.detach() > 0.0)
    return dict(found=t_ok, t_ng=torch.where(t_ok, t_w.detach(), KINF),
                t_w=t_w, normal=ix.normalize(n_tri, eps=1e-20),
                material=material, alpha=alpha)


def _edge_margin(a, b, c, origin, pix_ang):
    """(T,) half-pixel-plus expansion margin of each (detached) triangle:
    0.55 pixel footprints at its centroid's distance from the camera (the
    primary rays' shared origin)."""
    cent = (a + b + c) / 3.0
    rel = cent - origin.detach()[0]
    dist = torch.sqrt(_at_least(ix.dot3(rel, rel), 1e-6))
    return 0.55 * pix_ang.detach() * dist


def tri_edge_candidate_brute(scene: Scene, origin, direction,
                             cfg: RenderConfig, pix_ang):
    """Widened primary closest hit over miter-expanded triangles for the
    silhouette estimator, brute force (rays x every slot).  The search is
    detached; the winner's true vertices are gathered ATTACHED by
    ``index_select`` (whose backward, ``index_add_``, does not serialize
    lanes sharing a triangle) and its neighbor normals detached."""
    mesh = scene.mesh
    a_all, b_all, c_all = triangle_vertices(mesh)
    live = _live_triangle_mask(scene)
    with torch.no_grad():
        aD, bD, cD = a_all.detach(), b_all.detach(), c_all.detach()
        margin = _edge_margin(aD, bD, cD, origin, pix_ang)
        ae, be, ce = _expand_triangles(aD, bD, cD, margin)
        t_t, t_hit = ix.ray_triangle_sweep(origin.detach(),
                                           direction.detach(), ae, be, ce)
        t_ng, idx = _first_min(torch.where(t_hit & live, t_t, KINF))
        found = t_ng < KINF
        n_all = ix.cross(bD - aD, cD - aD)
        nbr = mesh.tri_neighbor.long()
        nbr_live = (nbr >= 0) & live[nbr.clamp_min(0)]
        nbrn = torch.where(nbr_live[:, :, None], n_all[nbr.clamp_min(0)], 0.0)
        win_nbrn, win_ok = nbrn[idx], nbr_live[idx]
    abc = torch.cat([a_all, b_all, c_all], 1).index_select(0, idx)
    return _tri_edge_eval(origin, direction, abc[:, 0:3], abc[:, 3:6],
                          abc[:, 6:9], mesh.tri_material[idx], win_nbrn,
                          win_ok, found, pix_ang)


def intersect_primary_edge(scene: Scene, origin, direction, cfg: RenderConfig,
                           pix_ang, tri_edge_fn=None):
    """Edge-aware primary closest hit for silhouette gradients
    (``cfg.edge_grads``) -> (HitRecord, alpha (R,), background HitRecord).

    The hit/miss step has no gradient under autodiff, so the primal is made
    continuous instead (the coverage estimator):

    - a sphere is accepted within half a pixel footprint ``w = t * pix_ang``
      of its limb; grazing rays park at the closest approach, with coverage
      ``clip(0.5 + (r - b) / w, 0, 1)`` (the discriminant clamped a quarter
      pixel from tangency keeps the slope bounded);
    - triangles are searched miter-expanded (``tri_edge_fn``: the brute
      query by default, the backend's ``edge_tri_fn`` where it has one);
      coverage ramps over the distance to the nearest silhouette edge.

    The caller blends ``alpha * L_hit + (1 - alpha) * L_background``; the
    background record is the per-ray loser: the triangle candidate behind a
    winning sphere, the sphere behind a winning triangle (spheres win ties,
    as in intersect_scene_brute)."""
    sph = scene.spheres
    pix_ang = pix_ang.detach()
    if tri_edge_fn is None:
        tri_edge_fn = tri_edge_candidate_brute
    tc = tri_edge_fn(scene, origin, direction, cfg, pix_ang)

    # the widened sphere search (detached)
    with torch.no_grad():
        o_ng, d_ng = origin.detach(), direction.detach()
        q = sph.position.detach()[None, :, :] - o_ng[:, None, :]  # (R, S, 3)
        t_ca = ix.dot3(q, d_ng[:, None, :])
        b2 = ix.dot3(q, q) - t_ca * t_ca
        r = sph.radius.detach()[None, :]
        w = _at_least(t_ca, 1e-3) * pix_ang
        r_eff = r + 0.5 * w
        disc = r * r - b2
        # near root only (quirk 1); grazing rays park at t_ca
        t_cand = torch.where(disc > 0.0,
                             t_ca - torch.sqrt(_at_least(disc, 0.0)), t_ca)
        s_live = torch.arange(sph.capacity, device=q.device) < sph.count
        valid = s_live & (b2 < r_eff * r_eff) & (t_cand > 0.0)
        t_s_ng, idx = _first_min(torch.where(valid, t_cand, KINF))

    # the attached re-shade of the winning sphere
    pr = take_rows(torch.cat([sph.position, sph.radius[:, None]], 1), idx)
    cen, rad, s_mat = pr[:, 0:3], pr[:, 3], sph.material[idx]
    qw = cen - origin
    t_ca_w = ix.dot3(qw, direction)
    b2_w = ix.dot3(qw, qw) - t_ca_w * t_ca_w
    b_w = ix.safe_sqrt(b2_w)
    w_w = _at_least(t_ca_w, 1e-3).detach() * pix_ang
    disc_w = rad * rad - b2_w
    qw4 = 0.25 * w_w
    disc_c = torch.maximum(disc_w, qw4 * qw4)   # bounded slope at the limb
    t_w = torch.where(disc_w.detach() > 0.0, t_ca_w - torch.sqrt(disc_c),
                      t_ca_w)

    # merge the two widened candidates (spheres win ties)
    sphere_found = t_s_ng < KINF
    use_s = sphere_found & (t_s_ng <= tc["t_ng"])
    use_t = tc["found"] & ~use_s
    hit = use_s | use_t
    t_best = torch.where(use_s, t_w, torch.where(use_t, tc["t_w"], 1.0))
    t_safe = torch.where(hit, t_best, 1.0)
    p = origin + t_safe[:, None] * direction
    rad_safe = torch.where(rad.detach() > 0.0, rad, 1.0)
    n_s = (p - cen) / rad_safe[:, None]
    up = torch.tensor([0.0, 0.0, 1.0], device=p.device)

    def record(hit, t, p, normal, material):
        front = ix.dot3(direction.detach(), normal.detach()) < 0.0
        normal = torch.where(front[:, None], normal, -normal)
        normal = torch.where(hit[:, None], normal, up)
        return HitRecord(t=t, p=p, normal=normal, hit=hit, front=front,
                         material=material.to(torch.int32))

    rec = record(hit, t_safe, p,
                 torch.where(use_s[:, None], n_s, tc["normal"]),
                 torch.where(use_s, s_mat, tc["material"]))
    alpha_s = torch.clamp(0.5 + (rad - b_w) / w_w, 0.0, 1.0)
    alpha = torch.where(use_s, alpha_s, torch.where(use_t, tc["alpha"], 1.0))

    # the background record: the per-ray LOSER candidate (a triangle behind
    # a winning sphere, the sphere behind a winning triangle, else a miss)
    bg_hit = torch.where(use_s, tc["found"], sphere_found)
    bg_t = torch.where(bg_hit, torch.where(use_s, tc["t_w"], t_w), 1.0)
    bg_p = origin + bg_t[:, None] * direction
    bg_n_s = (bg_p - cen) / rad_safe[:, None]
    rec_bg = record(bg_hit, bg_t, bg_p,
                    torch.where(use_s[:, None], tc["normal"], bg_n_s),
                    torch.where(use_s, tc["material"], s_mat))
    return rec, alpha, rec_bg


def _fresnel_reflectance(in_dir, normal, ior_a, ior_b):
    """Unpolarized Fresnel, CalculateReflectance (pathTracer.comp:213-234)."""
    ratio = ior_a / ior_b
    cos_in = -ix.dot3(in_dir, normal)
    sin_sqr_refr = ratio * ratio * (1.0 - cos_in * cos_in)
    tir = sin_sqr_refr >= 1.0
    cos_refr = ix.safe_sqrt(1.0 - sin_sqr_refr)
    denom_perp = ior_a * cos_in + ior_b * cos_refr
    denom_par = ior_b * cos_in + ior_a * cos_refr
    degenerate = torch.minimum(denom_perp, denom_par) < 1e-8
    safe_perp = torch.where(torch.abs(denom_perp) < 1e-8, 1.0, denom_perp)
    safe_par = torch.where(torch.abs(denom_par) < 1e-8, 1.0, denom_par)
    r_perp = (ior_a * cos_in - ior_b * cos_refr) / safe_perp
    r_perp = r_perp * r_perp
    r_par = (ior_b * cos_in - ior_a * cos_refr) / safe_par
    r_par = r_par * r_par
    refl = (r_perp + r_par) * 0.5
    return torch.where(tir | degenerate, 1.0, refl)


def sky_color(direction, cfg: RenderConfig):
    """Vertical gradient sky (pathTracer.comp:236-239):
    mix(vec3(.5,.7,1), vec3(1), 0.5*(d.y+1)) — white at the top."""
    if cfg.sky == "black":
        return torch.zeros_like(direction)
    a = 0.5 * (direction[..., 1:2] + 1.0)
    blue = torch.tensor([0.5, 0.7, 1.0], device=direction.device)
    return blue * (1.0 - a) + a


def _at_least(x, lo):
    """max(x, lo) as jnp.maximum: NaN-propagating, ties split the gradient."""
    return torch.maximum(x, torch.full_like(x, lo))


def _luminance(rgb):
    return (_LUM[0] * rgb[..., 0] + _LUM[1] * rgb[..., 1]
            + _LUM[2] * rgb[..., 2])


def _material_luminance(materials, mid):
    """(emission x strength (R, 3), luminance x strength (R,)) of the
    materials ``mid``: an emitter's radiance and its light-pick weight per
    unit area."""
    es = take_rows(torch.cat([materials.emission,
                              materials.emission_strength[:, None]], 1), mid)
    emission, strength = es[:, 0:3], es[:, 3]
    return emission * strength[:, None], _luminance(emission) * strength


def _light_tables(scene: Scene):
    """Per-primitive light-sampling tables shared by NEE and the MIS
    emission weight -> (weights (S+T,), s_lum, t_lum, tri, a, b, c).

    weights = area x luminance per live emissive primitive, so the pick pdf
    in area measure is lum / total (the areas cancel) and the BSDF-side
    light pdf of hitting an emitter needs only its luminance and ``total =
    sum(weights)``.  Triangle areas use safe_sqrt: padded slots are
    degenerate, and a norm's gradient at 0 would poison the vertex grads
    even though their weights are masked out."""
    sph, mesh = scene.spheres, scene.mesh
    s_live = torch.arange(sph.capacity, device=sph.radius.device) < sph.count
    s_lum = _material_luminance(scene.materials, sph.material.long())[1]
    s_area = _FOUR_PI * sph.radius * sph.radius
    s_w = torch.where(s_live & (s_lum > 0.0), s_area * s_lum, 0.0)

    voff = mesh.draw_vertex_offset[mesh.tri_draw.clamp_min(0)]
    tri = mesh.indices.view(-1, 3) + voff[:, None]        # bank-global ids
    a, b, c = (mesh.vertices[tri[:, k]] for k in range(3))
    t_lum = _material_luminance(scene.materials, mesh.tri_material.long())[1]
    cr = ix.cross(b - a, c - a)
    t_area = 0.5 * ix.safe_sqrt(ix.dot3(cr, cr))
    t_w = torch.where(_live_triangle_mask(scene) & (t_lum > 0.0),
                      t_area * t_lum, 0.0)
    return torch.cat([s_w, t_w]), s_lum, t_lum, tri, a, b, c


_SHADOW_BAND = float(np.float32(0.15))   # the soft shadow's ramp, as a
#   fraction of the geometric penumbra (see _soft_sphere_shadow)


def _soft_sphere_shadow(scene: Scene, origin, wi, dist, extent, mask):
    """Fractional sphere-occluder visibility for the coverage estimator
    (``cfg.edge_grads``) -> (R,): the product over live spheres between the
    point and the light of a linear penumbra ramp ``clip(0.5 + (b - r) / w,
    0, 1)``, b the ray's (attached) miss distance from the center and w a
    small fraction of the picked light's geometric penumbra at the
    occluder, ``extent * t_ca / (dist - t_ca)`` (extent = light radius or
    sqrt(triangle area)).  Attached, no PCG draws; exact for penumbras that
    do not overlap.  The Monte Carlo sampling of the light area already
    integrates the true penumbra; the ramp only makes each sample's step
    continuous, so w stays small (a full-penumbra band over-blurs)."""
    sph = scene.spheres
    q = sph.position[None, :, :] - origin[:, None, :]          # (R, S, 3)
    t_ca = ix.dot3(q, wi[:, None, :])                          # (R, S)
    b2 = ix.dot3(q, q) - t_ca * t_ca
    b = ix.safe_sqrt(_at_least(b2, 0.0))
    live = (torch.arange(sph.capacity, device=q.device) < sph.count)[None, :]
    between = (t_ca > 0.0) & (t_ca < dist[:, None])
    ratio = torch.clamp(t_ca / _at_least(dist[:, None] - t_ca, 1e-4),
                        0.0, 4.0)
    w = _at_least(_SHADOW_BAND * extent[:, None] * ratio, 1e-5)
    v = torch.clamp(0.5 + (b - sph.radius[None, :]) / w, 0.0, 1.0)
    v = torch.where(live & between & mask[:, None], v, 1.0)
    return torch.prod(v, dim=-1)


def sample_direct_light(scene: Scene, rec: HitRecord, seed, mask,
                        intersect_fn, cfg: RenderConfig):
    """Next-event estimation: one area-sampled light connection per lane.

    The light set is every live emissive sphere and triangle, picked by
    area x luminance.  Returns (direct radiance without the BRDF and the
    throughput (R, 3), wi (R, 3), solid-angle pdf (R,), seed); wi and the
    pdf feed the MIS balance weight.  Draws per lane where ``mask``: 1
    light pick, then 2 point draws, all masked, so other lanes keep their
    PCG streams.  Under ``cfg.edge_grads`` sphere occluders are soft
    (``_soft_sphere_shadow``) and the shadow query sees the triangles only.
    """
    sph, mesh, mats = scene.spheres, scene.mesh, scene.materials
    with profiling.stage("nee.tables"):
        weights, _, _, tri, a, b, c = _light_tables(scene)
    cum = torch.cumsum(weights, dim=0)
    total_w = cum[-1]
    has_lights = total_w > 0.0

    u_pick, seed = rng.rand_masked(seed, mask)
    u1, seed = rng.rand_masked(seed, mask)
    u2, seed = rng.rand_masked(seed, mask)

    pick = torch.searchsorted(cum.detach(), (u_pick * total_w).detach(),
                              right=True)
    pick = pick.clamp(0, weights.shape[0] - 1)
    is_sphere_light = pick < sph.capacity
    s_idx = pick.clamp(0, sph.capacity - 1)
    t_idx = (pick - sph.capacity).clamp(0, tri.shape[0] - 1)

    # sphere: a uniform point on the surface
    z = 1.0 - 2.0 * u1
    r_xy = ix.safe_sqrt(1.0 - z * z)
    phi = _TWO_PI * u2
    n_sph = torch.stack([r_xy * torch.cos(phi), r_xy * torch.sin(phi), z], -1)
    pr = take_rows(torch.cat([sph.position, sph.radius[:, None]], 1), s_idx)
    p_sph = pr[:, 0:3] + pr[:, 3:4] * n_sph

    # triangle: uniform barycentrics by the square-root trick
    su = torch.sqrt(torch.clamp(u1, 1e-12, 1.0))
    b0 = 1.0 - su
    b1 = u2 * su
    # index_select: its backward (index_add_) takes the many lanes that share
    # a row (every sphere pick clamps to row 0) without serializing them
    abc = torch.cat([a, b, c], 1).index_select(0, t_idx)
    ta, tb, tc = abc[:, 0:3], abc[:, 3:6], abc[:, 6:9]
    p_tri = ta * b0[:, None] + tb * b1[:, None] \
        + tc * (1.0 - b0 - b1)[:, None]
    n_tri = ix.normalize(ix.cross(tb - ta, tc - ta), eps=1e-20)

    p_light = torch.where(is_sphere_light[:, None], p_sph, p_tri)
    n_light = torch.where(is_sphere_light[:, None], n_sph, n_tri)
    light_mat = torch.where(is_sphere_light, sph.material[s_idx],
                            mesh.tri_material[t_idx]).long()
    # the picked light's radiance, and its luminance (= s_lum[s_idx] or
    # t_lum[t_idx], the same floats, gathered per lane by material)
    L_e, lum_pick = _material_luminance(mats, light_mat)

    # geometric term and shadow ray; safe_sqrt keeps coincident points
    # (masked lanes, degenerate picks) from injecting NaN gradients
    to_light = p_light - rec.p
    dist = ix.safe_sqrt(ix.dot3(to_light, to_light))
    safe_dist = _at_least(dist, 1e-6)
    wi = to_light / safe_dist[:, None]
    cos_surf = ix.dot3(rec.normal, wi)
    cos_light_raw = ix.dot3(n_light, -wi)
    # triangles emit on both sides (the tracer flips normals toward the
    # ray); spheres emit outward only
    cos_light = torch.where(is_sphere_light, cos_light_raw,
                            torch.abs(cos_light_raw))

    shadow_o = rec.p + rec.normal * BIAS
    thresh = dist - 1e-3 * safe_dist
    enabled = mask & has_lights
    scene_hard = scene
    if cfg.edge_grads:
        # spheres shadow softly (attached); the shadow query sees the
        # triangles alone, so no sphere counts twice
        scene_hard = dataclasses.replace(scene, spheres=dataclasses.replace(
            scene.spheres, count=torch.zeros_like(scene.spheres.count)))
        cr = ix.cross(tb - ta, tc - ta)
        extent = torch.where(is_sphere_light, pr[:, 3], ix.safe_sqrt(
            0.5 * ix.safe_sqrt(ix.dot3(cr, cr))))
        v_soft = _soft_sphere_shadow(scene, shadow_o, wi, dist, extent,
                                     enabled)
    occ_fn = getattr(intersect_fn, "occlusion_fn", None)
    profiling.count("shadow.lanes", shadow_o.shape[0])
    with profiling.stage("shadow"):
        if occ_fn is not None:
            # disabled lanes (non-NEE lobes, dead rays, lightless scenes)
            # get a -inf bound: ``ok`` masks them, and the cluster sweep
            # culls them
            visible = ~occ_fn(scene_hard, shadow_o, wi,
                              torch.where(enabled, thresh, -KINF), cfg)
        else:
            # the full closest hit; a backend that skips dead lanes gets
            # ``enabled`` as its alive mask (``ok`` masks every other lane)
            with torch.no_grad():
                if getattr(intersect_fn, "accepts_alive", False):
                    shadow = intersect_fn(scene_hard, shadow_o, wi, cfg,
                                          alive=enabled)
                else:
                    shadow = intersect_fn(scene_hard, shadow_o, wi, cfg)
            visible = (~shadow.hit) | (shadow.t >= thresh)

    # pdf_area = (w_pick / total) / area_pick = lum_pick / total
    pdf_a = _at_least(lum_pick / _at_least(total_w, 1e-20), 1e-20)
    G = _at_least(cos_surf, 0.0) * _at_least(cos_light, 0.0) \
        / (safe_dist * safe_dist)
    contrib = L_e * (G / pdf_a)[:, None]
    if cfg.edge_grads:
        contrib = contrib * v_soft[:, None]
    ok = enabled & visible & (cos_surf > 0.0) & (cos_light > 0.0) \
        & (lum_pick > 0.0)
    # solid-angle pdf of this light sample: pdf_area * dist^2 / cos_light
    pdf_sa = pdf_a * (safe_dist * safe_dist) \
        / _at_least(_at_least(cos_light, 0.0), 1e-6)
    return (torch.where(ok[:, None], contrib, 0.0), wi,
            torch.where(ok, pdf_sa, 1.0), seed)


def _gather_material(materials, mid):
    """Per-ray material fields (pathTracer.comp:251): one gather of the
    packed (M, 14) float table (``shade.pack_materials``, its columns
    ``shade.COLUMNS``; ``take_rows``) and the type ids."""
    mid = mid.long()
    table, mtype = shade.pack_materials(materials)
    g = take_rows(table, mid)
    out, col = dict(mtype=mtype[mid]), 0
    for name, width in shade.COLUMNS:
        out[name] = g[:, col:col + width] if width > 1 else g[:, col]
        col += width
    return out


@dataclasses.dataclass
class PathState:
    """Per-lane state carried across bounce segments."""

    o: torch.Tensor       # (R, 3) ray origin
    d: torch.Tensor       # (R, 3) ray direction
    total: torch.Tensor   # (R, 3) accumulated radiance
    trans: torch.Tensor   # (R, 3) path throughput
    seed: torch.Tensor    # (R,) int64 PCG state in [0, 2^32)
    alive: torch.Tensor   # (R,) bool
    pdf_prev: torch.Tensor  # (R,) BSDF pdf of the last scatter under NEE
    #                         (0 = the next hit's emission counts in full)
    bounce: int = 0


def _fused_materials(scene: Scene, cfg: RenderConfig, direction):
    """The packed material table (``shade.pack_materials``) where the
    segments of this trace are shaded by the fused kernel T1, else None:
    ``_bounce`` shades them.

    T1 takes the lanes where grad mode is off, NEE is off and they lie on
    the card.  Training, NEE/MIS, the edge estimator (``trace_rays_edge``),
    any caller under grad mode and the CPU keep ``_bounce``.  Packed once
    per trace, so once a frame per sample."""
    if torch.is_grad_enabled() or cfg.use_nee \
            or not shade.on_card(direction):
        return None
    return shade.pack_materials(scene.materials)


def _bounce_segment(scene: Scene, cfg: RenderConfig, intersect_fn,
                    s: PathState, materials=None) -> PathState:
    """One bounce segment of TraceRay (pathTracer.comp:241-284) over a lane
    batch: closest hit, emission/NEE/sky accumulation, BSDF scatter,
    Russian roulette.  The masked draws come in the JAX package's order, so
    every lane's PCG stream matches the reference's per-thread stream.
    The segment is the ``bounce`` span, its closest-hit query the
    ``intersect`` span (utils/profiling.py), which counts the lanes handed
    to the query and the live ones among them.  With ``materials``
    (``_fused_materials``'s table) the shading is one launch of T1."""
    with profiling.stage("bounce"):
        if materials is None:
            return _bounce(scene, cfg, intersect_fn, s)
        return _bounce_fused(scene, cfg, intersect_fn, s, materials)


def _closest_hit(scene: Scene, cfg: RenderConfig, intersect_fn,
                 s: PathState) -> HitRecord:
    """The segment's closest-hit query (the ``intersect`` span) and its lane
    counters."""
    profiling.count("intersect.lanes", s.o.shape[0])
    profiling.count("intersect.alive", s.alive)
    # terminated lanes keep stale (o, d); a backend that can skip them
    # (the cluster sweep) declares ``accepts_alive`` and gets the mask
    with profiling.stage("intersect"):
        if getattr(intersect_fn, "accepts_alive", False):
            return intersect_fn(scene, s.o, s.d, cfg, alive=s.alive)
        return intersect_fn(scene, s.o, s.d, cfg)


def _bounce_fused(scene: Scene, cfg: RenderConfig, intersect_fn,
                  s: PathState, materials) -> PathState:
    """``_bounce`` with everything after the query in one launch of T1.
    NEE is off, so ``pdf_prev`` stays as it is."""
    rec = _closest_hit(scene, cfg, intersect_fn, s)
    profiling.count("shade.lanes", s.o.shape[0])
    o, d, total, trans, seed, alive = shade.shade_segment_kernel(
        s.o, s.d, s.total, s.trans, s.seed, s.alive, rec, materials,
        sky_gradient=cfg.sky != "black",
        rr=cfg.use_rr and s.bounce >= cfg.rr_start_bounce)
    return PathState(o=o, d=d, total=total, trans=trans, seed=seed,
                     alive=alive, pdf_prev=s.pdf_prev, bounce=s.bounce + 1)


def _bounce(scene: Scene, cfg: RenderConfig, intersect_fn,
            s: PathState) -> PathState:
    """``_bounce_segment``'s work on the plain path, op by op (T1's
    twin)."""
    o, d, trans, seed = s.o, s.d, s.trans, s.seed
    rec = _closest_hit(scene, cfg, intersect_fn, s)

    # miss -> sky * throughput, path ends (pathTracer.comp:248-249)
    miss = s.alive & ~rec.hit
    total = s.total + torch.where(miss[:, None], sky_color(d, cfg) * trans, 0.0)
    live = s.alive & rec.hit

    m = _gather_material(scene.materials, rec.material)
    is_dielectric = m["mtype"] == MATERIAL_DIELECTRIC
    is_metal = m["mtype"] == MATERIAL_METAL
    is_lambert = m["mtype"] == MATERIAL_LAMBERTIAN
    is_ggx = m["mtype"] == MATERIAL_GGX

    # emission (:253).  Under NEE an emitter reached by BSDF sampling from
    # a light-sampled lobe is weighted by the balance heuristic (pdf_prev:
    # the previous scatter's BSDF pdf, 0 = full emission); with mis off it
    # is skipped after an NEE bounce
    emitted = m["emission"] * m["emission_strength"][:, None] * trans
    if cfg.use_nee:
        if cfg.mis:
            # the light pdf of having sampled this point instead, in solid
            # angle at the previous vertex.  The weight stays attached; the
            # double where keeps 0/0 out of reverse mode where pdf_prev = 0
            with profiling.stage("nee.tables"):
                weights = _light_tables(scene)[0]
            total_w = _at_least(torch.sum(weights), 1e-20)
            lum_hit = _luminance(m["emission"]) * m["emission_strength"]
            cos_hit = _at_least(-ix.dot3(rec.normal, d), 1e-6)
            pdf_l_sa = (lum_hit / total_w) * rec.t * rec.t / cos_hit
            use_ratio = s.pdf_prev > 0.0
            den_b = torch.where(use_ratio, s.pdf_prev + pdf_l_sa, 1.0)
            w_b = torch.where(use_ratio, s.pdf_prev / den_b, 1.0)
        else:
            w_b = torch.where(s.pdf_prev > 0.0, 0.0, 1.0)
        emitted = emitted * w_b[:, None]
    total = total + torch.where(live[:, None], emitted, 0.0)

    # NEE: a light connection for the sampled lobes (Lambertian, and GGX
    # under MIS), 3 masked draws.  METAL's fuzzy lobe and DIELECTRIC have
    # no closed-form pdf: they count as delta lobes, their emitter hits keep
    # full weight
    if cfg.use_nee:
        nee_mask = live & ((is_lambert | is_ggx) if cfg.mis else is_lambert)
        profiling.count("nee.lanes", nee_mask)
        with profiling.stage("nee"):
            direct, wi_l, pdf_l, seed = sample_direct_light(
                scene, rec, seed, nee_mask, intersect_fn, cfg)
            f = bsdf.lambert_brdf_over_pi(m["albedo"])
            if cfg.mis:
                f_ggx = bsdf.ggx_eval(rec.normal, -d, wi_l, m["albedo"],
                                      m["roughness"], m["metallic"])
                f = torch.where(is_ggx[:, None], f_ggx, f)
                pdf_b_l = torch.where(
                    is_ggx,
                    bsdf.ggx_pdf(rec.normal, -d, wi_l, m["roughness"]),
                    bsdf.lambert_pdf(rec.normal, wi_l))
                # the same guard: a masked GGX lane's pdf_b_l may be garbage
                ok_l = pdf_l > 1e-12
                den_l = torch.where(ok_l, pdf_l + pdf_b_l, 1.0)
                w_l = torch.where(ok_l, pdf_l / den_l, 0.0)
                direct = direct * f * trans * w_l[:, None]
            else:
                direct = direct * f * trans
            total = total + torch.where(nee_mask[:, None], direct, 0.0)

    # dielectric pre-draw (:268-273): the short-circuit `||` skips the draw
    # under total internal reflection
    eta_i = torch.where(rec.front, 1.0, m["ior"])
    eta_t = torch.where(rec.front, m["ior"], 1.0)
    reflect_prob = _fresnel_reflectance(d, rec.normal, eta_i, eta_t)
    refr, tir = ix.refract(d, rec.normal, eta_i / eta_t)
    u_refl, seed = rng.rand_masked(seed, live & is_dielectric & ~tir)

    # GGX slot (extension): 2 masked draws for the half vector
    u_g1, seed = rng.rand_masked(seed, live & is_ggx)
    u_g2, seed = rng.rand_masked(seed, live & is_ggx)

    # shared 6-draw RandomDirection (metal :258, dielectric :275, lambert)
    rdir, seed = rng.random_direction(seed, live & ~is_ggx)

    refl = ix.reflect(d, rec.normal)
    rough = m["roughness"][:, None]

    # METAL (:256-262)
    d_metal = ix.normalize(refl + rough * rdir, eps=1e-20)
    o_metal = rec.p + rec.normal * BIAS

    # DIELECTRIC (:263-280)
    follow_reflect = tir | (u_refl <= reflect_prob)
    base = torch.where(follow_reflect[:, None], refl, refr)
    d_diel = ix.normalize(base + rough * rdir, eps=1e-20)
    absorb = (~follow_reflect) & (~rec.front)
    beer = torch.exp(-m["absorption"] * m["absorption_strength"][:, None]
                     * rec.t[:, None])
    o_diel = rec.p + BIAS * rec.normal * torch.sign(
        ix.dot3(d_diel, rec.normal))[:, None]

    # LAMBERTIAN (extension): cosine-weighted via normal + unit sphere dir
    d_lam = rec.normal + rdir
    lam_len = torch.sqrt(torch.clamp_min(ix.dot3(d_lam, d_lam), 1e-12))[:, None]
    d_lam = torch.where(lam_len < 1e-6, rec.normal, d_lam / lam_len)
    o_lam = rec.p + rec.normal * BIAS

    # GGX (extension): microfacet conductor lobe
    d_ggx, w_ggx, ggx_valid = bsdf.ggx_sample(
        rec.normal, -d, m["albedo"], m["roughness"], m["metallic"], u_g1, u_g2)
    d_ggx = ix.normalize(d_ggx, eps=1e-20)

    new_d = torch.where(is_dielectric[:, None], d_diel,
                        torch.where(is_lambert[:, None], d_lam,
                                    torch.where(is_ggx[:, None], d_ggx,
                                                d_metal)))
    new_o = torch.where(is_dielectric[:, None], o_diel,
                        torch.where((is_lambert | is_ggx)[:, None], o_lam,
                                    o_metal))
    tput = torch.where((is_metal | is_lambert)[:, None], m["albedo"],
                       torch.where(is_ggx[:, None], w_ggx,
                                   torch.where(absorb[:, None], beer, 1.0)))
    trans = torch.where(live[:, None], trans * tput, trans)
    # GGX samples that dipped under the surface carry zero weight: kill
    live = live & (~is_ggx | ggx_valid)

    # Russian roulette (extension): 1 masked draw per eligible lane
    if cfg.use_rr:
        rr_mask = live & (s.bounce >= cfg.rr_start_bounce)
        p_survive = torch.clamp(torch.amax(trans, dim=-1), 0.05, 1.0)
        u_rr, seed = rng.rand_masked(seed, rr_mask)
        killed = rr_mask & (u_rr > p_survive)
        live = live & ~killed
        keep = rr_mask & ~killed
        trans = torch.where(keep[:, None], trans / p_survive[:, None], trans)

    # the pdf of this scatter, for the next hit's MIS emission weight (only
    # where NEE handled this bounce's direct light)
    pdf_prev = s.pdf_prev
    if cfg.use_nee:
        if cfg.mis:
            pdf_scatter = torch.where(
                is_ggx, bsdf.ggx_pdf(rec.normal, -d, new_d, m["roughness"]),
                bsdf.lambert_pdf(rec.normal, new_d))
            pdf_prev = torch.where(nee_mask & live,
                                   _at_least(pdf_scatter, 1e-12), 0.0)
        else:
            pdf_prev = torch.where(nee_mask & live, 1.0, 0.0)

    return PathState(o=torch.where(live[:, None], new_o, o),
                     d=torch.where(live[:, None], new_d, d),
                     total=total, trans=trans, seed=seed, alive=live,
                     pdf_prev=pdf_prev, bounce=s.bounce + 1)


def _initial_state(origin, direction, seed) -> PathState:
    zeros = torch.zeros_like(direction)
    return PathState(o=origin.expand_as(direction), d=direction, total=zeros,
                     trans=zeros + 1.0, seed=seed,
                     alive=torch.ones(direction.shape[0], dtype=torch.bool,
                                      device=direction.device),
                     pdf_prev=zeros[:, 0])


def trace_rays(scene: Scene, origin, direction, seed, cfg: RenderConfig,
               intersect_fn=None):
    """TraceRay (pathTracer.comp:241-284) over a ray batch: origin/direction
    (R, 3), seed (R,) int64 -> (radiance (R, 3), new_seed).  The loop runs
    ``max_bounces + 1`` segments (`i <= maxBounceCount`, :245);
    ``cfg.compact`` runs it through ``trace_rays_compact``."""
    if intersect_fn is None:
        intersect_fn = intersect_scene_brute
    if cfg.compact:
        return trace_rays_compact(scene, origin, direction, seed, cfg,
                                  intersect_fn)
    s = _initial_state(origin, direction, seed)
    materials = _fused_materials(scene, cfg, direction)
    for _ in range(cfg.max_bounces + 1):
        s = _bounce_segment(scene, cfg, intersect_fn, s, materials)
    return s.total, s.seed


def _lanes(s: PathState) -> dict:
    """The per-lane fields of ``s``: every one but ``bounce``."""
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(PathState)
            if f.name != "bounce"}


def trace_rays_compact(scene: Scene, origin, direction, seed,
                       cfg: RenderConfig, intersect_fn=None):
    """``trace_rays`` with alive-lane compaction: the same lanes, the same
    per-lane math, the work of the later bounces cut to the live lanes.

    Bounces before ``cfg.compact_from_resolved`` run on every lane.  Before
    each later bounce one stable partition (cumsum positions, one scatter)
    puts the live lanes of those still in play first, and the bounce runs
    ``_bounce_segment`` on the first ``ceil(n_alive / B) * B`` of them only,
    B = R / compact_blocks lanes (the block count lowered until it divides
    R); the rest leave play.  A lane only ever dies, and a dead lane's
    bounce changes neither its radiance nor its seed, so they need no more
    work.  The partition repeats each bounce because lanes die in place.
    Each bounce costs one host read of ``n_alive``; lanes carry their PCG
    streams, and a scatter through the carried ray index undoes the
    permutation of ``total`` and ``seed`` at the end.  Autograd saves the
    prefixes' residuals only.  Each partition and the final restore are the
    ``compact`` span; ``compact.alive`` counts ``n_alive`` and
    ``compact.kept`` the prefix handed to the bounce."""
    if intersect_fn is None:
        intersect_fn = intersect_scene_brute
    R = direction.shape[0]
    nblk = min(cfg.compact_blocks, R)
    while R % nblk:
        nblk -= 1
    B = R // nblk
    n_dense = min(max(cfg.compact_from_resolved, 0), cfg.max_bounces + 1)
    s = _initial_state(origin, direction, seed)
    materials = _fused_materials(scene, cfg, direction)
    for _ in range(n_dense):
        s = _bounce_segment(scene, cfg, intersect_fn, s, materials)
    lanes = _lanes(s)
    orig = torch.arange(R, device=direction.device)   # lane -> ray
    done = []             # (total, seed, ray) of the lanes out of play
    for bounce in range(n_dense, cfg.max_bounces + 1):
        with profiling.stage("compact"):
            alive = lanes["alive"]
            n_alive = int(alive.sum())
            live_i = alive.long()
            pos = torch.where(alive, torch.cumsum(live_i, 0) - 1,
                              n_alive + torch.cumsum(1 - live_i, 0) - 1)
            order = torch.empty_like(pos).scatter_(0, pos, torch.arange(
                pos.shape[0], device=pos.device))
            lanes = {k: v.index_select(0, order) for k, v in lanes.items()}
            orig = orig.index_select(0, order)
            n = -(-n_alive // B) * B
            profiling.count("compact.alive", n_alive)
            profiling.count("compact.kept", n)
            done.append((lanes["total"][n:], lanes["seed"][n:], orig[n:]))
            lanes = {k: v[:n] for k, v in lanes.items()}
            orig = orig[:n]
        if n == 0:
            break
        lanes = _lanes(_bounce_segment(scene, cfg, intersect_fn,
                                       PathState(**lanes, bounce=bounce),
                                       materials))
    with profiling.stage("compact"):
        total = torch.cat([lanes["total"]] + [d[0] for d in done])
        seed = torch.cat([lanes["seed"]] + [d[1] for d in done])
        orig = torch.cat([orig] + [d[2] for d in done])
        inv = torch.empty_like(orig).scatter_(0, orig, torch.arange(
            R, device=orig.device))
        return total.index_select(0, inv), seed.index_select(0, inv)


def trace_rays_edge(scene: Scene, origin, direction, seed, seed_bg,
                    cfg: RenderConfig, pix_ang, intersect_fn=None):
    """``trace_rays`` with the edge-aware primary bounce (``cfg.edge_grads``)
    -> (blended radiance, seed, seed_bg).

    Two paths per ray: the hit path, whose bounce 0 is the widened record
    of ``intersect_primary_edge``, and the background path, whose bounce 0
    is the per-ray loser record; later bounces of both see the full scene
    (only primary visibility is smoothed), each on its own PCG stream.  They
    are blended by the coverage: ``alpha * L + (1 - alpha) * L_bg``.  The
    widened triangle query is the backend's ``edge_tri_fn`` where it has
    one (the cluster sweep), else brute force.  Bounce 0 swaps in a closure
    returning the precomputed record; its NEE shadow query still goes to the
    backend's ``occlusion_fn`` (``occluded_brute`` where it has none), or
    every surface nearer than its light sample would shadow itself."""
    if intersect_fn is None:
        intersect_fn = intersect_scene_brute
    rec0, alpha, rec_bg = intersect_primary_edge(
        scene, origin, direction, cfg, pix_ang,
        getattr(intersect_fn, "edge_tri_fn", None))
    real_occ = getattr(intersect_fn, "occlusion_fn", None) or occluded_brute

    def run(rec_primary, seed):
        def fn0(scene, o, d, cfg):
            return rec_primary

        fn0.occlusion_fn = real_occ
        s = _initial_state(origin, direction, seed)
        for i in range(cfg.max_bounces + 1):
            s = _bounce_segment(scene, cfg, fn0 if i == 0 else intersect_fn,
                                s)
        return s.total, s.seed

    light, seed = run(rec0, seed)
    light_bg, seed_bg = run(rec_bg, seed_bg)
    blended = alpha[:, None] * light + (1.0 - alpha[:, None]) * light_bg
    return blended, seed, seed_bg


def render_rows(scene: Scene, mats: CameraMatrices, cfg: RenderConfig,
                frame_count: int, y0: int, num_rows: int, intersect_fn=None):
    """Render rows [y0, y0 + num_rows) -> (num_rows, W, 3).  Pixel seeds use
    global pixel indices (pathTracer.comp:304), so a band is pixel-identical
    to the same rows of a full frame.  Under ``cfg.edge_grads`` each sample
    is ``trace_rays_edge``'s blend, its background path on a stream of its
    own seeded with ``frame_count + 747796405`` (mod 2^32)."""
    H, W = cfg.height, cfg.width
    dev = mats.position.device
    xs = torch.arange(W, device=dev)[None, :]
    ys = (y0 + torch.arange(num_rows, device=dev))[:, None]
    pixel_index = (xs + ys * W).reshape(-1)
    seed = rng.pixel_seed(pixel_index, frame_count)
    origin = mats.position.expand(num_rows * W, 3)

    def band_directions(jitter=None):
        dirs = primary_ray_directions(mats, W, H, jitter=jitter)
        return dirs[y0:y0 + num_rows].reshape(-1, 3)

    acc = torch.zeros((num_rows * W, 3), device=dev)
    dirs = None if cfg.pixel_jitter else band_directions()
    if cfg.edge_grads:
        # the angular pixel height: inverse_projection[1, 1] = tan(fov / 2)
        pix_ang = (2.0 * mats.inverse_projection[1, 1] / float(H)).detach()
        seed_bg = rng.pixel_seed(pixel_index, int(frame_count) + 747796405)
        for _ in range(cfg.samples):
            blended, seed, seed_bg = trace_rays_edge(
                scene, origin, dirs, seed, seed_bg, cfg, pix_ang,
                intersect_fn)
            acc = acc + blended
        return (acc / float(cfg.samples)).view(num_rows, W, 3)
    for _ in range(cfg.samples):
        if cfg.pixel_jitter:
            # 2 draws per sample per pixel (extension; the reference never
            # jitters)
            jx, seed = rng.rand(seed)
            jy, seed = rng.rand(seed)
            jit = torch.zeros((H, W, 2), device=dev)
            jit[y0:y0 + num_rows] = torch.stack([jx, jy], -1).view(
                num_rows, W, 2)
            dirs = band_directions(jit)
        light, seed = trace_rays(scene, origin, dirs, seed, cfg, intersect_fn)
        acc = acc + light
    return (acc / float(cfg.samples)).view(num_rows, W, 3)


def render_rows_frames(scene: Scene, mats: CameraMatrices, cfg: RenderConfig,
                       frame_counts, y0: int, num_rows: int,
                       intersect_fn=None):
    """Rows [y0, y0 + num_rows) of n frames, one per entry of
    ``frame_counts`` -> (n, num_rows, W, 3): frame i equals
    ``render_rows(..., frame_counts[i], y0, num_rows)`` bit for bit, but
    the n frames go through the transport as one batch of n * num_rows * W
    lanes, one ``trace_rays`` per sample (the JAX package maps
    ``render_rows`` over frames with ``jax.vmap``).  Lanes repeat the
    band's pixel indices per frame and carry their own frame count into
    ``rng.pixel_seed``.  Jittered pixels and the edge estimator are not
    batched: either raises."""
    for field in ("pixel_jitter", "edge_grads"):
        if getattr(cfg, field):
            raise ValueError(f"render_rows_frames does not batch "
                             f"cfg.{field}=True; call render_rows per frame")
    H, W = cfg.height, cfg.width
    dev = mats.position.device
    frames = torch.as_tensor(frame_counts, dtype=torch.int64, device=dev)
    n, P = frames.shape[0], num_rows * W
    xs = torch.arange(W, device=dev)[None, :]
    ys = (y0 + torch.arange(num_rows, device=dev))[:, None]
    pixel_index = (xs + ys * W).reshape(-1)
    seed = rng.pixel_seed(pixel_index.repeat(n),
                          frames.repeat_interleave(P))
    origin = mats.position.expand(n * P, 3)
    dirs = primary_ray_directions(mats, W, H)[y0:y0 + num_rows].reshape(
        -1, 3).repeat(n, 1)
    acc = torch.zeros((n * P, 3), device=dev)
    for _ in range(cfg.samples):
        light, seed = trace_rays(scene, origin, dirs, seed, cfg, intersect_fn)
        acc = acc + light
    return (acc / float(cfg.samples)).view(n, num_rows, W, 3)


def render_frame(scene: Scene, mats: CameraMatrices, cfg: RenderConfig,
                 frame_count: int, intersect_fn=None):
    """One progressive frame (H, W, 3): the average of cfg.samples paths per
    pixel (main(), pathTracer.comp:289-312)."""
    return render_rows(scene, mats, cfg, frame_count, 0, cfg.height,
                       intersect_fn)


@torch.no_grad()
def alive_per_bounce(scene: Scene, mats: CameraMatrices, cfg: RenderConfig,
                     frame_count: int, intersect_fn=None):
    """(max_bounces + 1,) int64: the lanes alive entering each bounce of one
    frame's first sample (every lane on bounce 0), the transport run with
    every lane, as the reference marches them."""
    if intersect_fn is None:
        intersect_fn = intersect_scene_brute
    H, W = cfg.height, cfg.width
    dev = mats.position.device
    seed = rng.pixel_seed(torch.arange(H * W, device=dev), frame_count)
    dirs = primary_ray_directions(mats, W, H).reshape(-1, 3)
    s = _initial_state(mats.position.expand(H * W, 3), dirs, seed)
    materials = _fused_materials(scene, cfg, dirs)
    counts = []
    for _ in range(cfg.max_bounces + 1):
        counts.append(s.alive.sum())
        s = _bounce_segment(scene, cfg, intersect_fn, s, materials)
    return torch.stack(counts)


def count_alive_segments(scene: Scene, mats: CameraMatrices,
                         cfg: RenderConfig, frame_count: int,
                         intersect_fn=None) -> int:
    """Alive lane-segments of one frame: the sum of ``alive_per_bounce``
    times ``cfg.samples``.  The dispatched count W*H*samples*(max_bounces+1)
    marches every lane through every bounce, as the reference does; with
    Russian roulette and sky misses most lanes are dead late, and a rate
    over this count says how much of the work was live.  Callers pass their
    active backend as ``intersect_fn`` (default brute force)."""
    return int(alive_per_bounce(scene, mats, cfg, frame_count,
                                intersect_fn).sum()) * cfg.samples


def accumulate(old_image, new_frame, frame_count: int):
    """Progressive running mean (pathTracer.comp:314-318): weight
    1/(frame_count+1); frame 0 overwrites."""
    if frame_count == 0:
        return new_frame
    w = float(np.float32(1.0) / (np.float32(frame_count) + np.float32(1.0)))
    return old_image * float(np.float32(1.0) - np.float32(w)) + new_frame * w


def render_step(scene: Scene, mats: CameraMatrices, cfg: RenderConfig,
                frame_count: int, old_image, frame_fn=None):
    """The per-frame serving call: render one frame with the frame function
    ``render/dispatch.py`` "auto" picks for this scene (or ``frame_fn``) and
    fold it into the running mean."""
    if frame_fn is None:
        from wc_path_tracer_tpu_torch.render import dispatch
        frame_fn = dispatch.get_render_frame("auto", scene, cfg)
    return accumulate(old_image, frame_fn(scene, mats, cfg, frame_count),
                      frame_count)
