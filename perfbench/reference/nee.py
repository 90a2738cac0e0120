"""Plain reference of the configurations with next-event estimation: one
light sample a scattering vertex, weighed against the BSDF sample of the
same light by the balance heuristic, over the four material models.

Plain PyTorch in float32, on whatever device its inputs are on; it imports
nothing of the measured package.  It shares ``transport``'s PCG streams,
camera rays, group-culled brute-force closest hits and accumulation, and
``bsdf``'s material table, hit record, Fresnel, refraction, GGX sampling
and Smith G1, with the transport of the four lobes as ``bsdf`` defines it.
It writes here what those leave out, after the published equations:

- the light set: every emissive sphere in slot order, then every emissive
  triangle in the order of its centroid (x, then y, then z; slot order
  where two centroids are equal), each weighted by its area times the
  Rec. 709 luminance of its emission times the strength.  One draw
  against the cumulative weights picks a light, so the pick's pdf in area
  measure is luminance / total (the areas cancel).  The order decides
  which light a draw picks, and so which pixels the two sides compare: the
  program picks in the order in which its scene stores the triangles, its
  bounding volume hierarchy's leaf order, which puts the lower side of each
  split first; that is the centroid order wherever one light's centroid
  lies below another's on every axis, as the two triangles of the Cornell
  box's ceiling light do;
- the point on the light: on a sphere, uniform on its surface from two
  draws (z = 1 - 2 u1, phi = 2 pi u2); on a triangle, uniform by the
  square-root barycentrics b0 = 1 - sqrt(u1), b1 = u2 sqrt(u1) (pbrt,
  "Sampling Triangles").  Triangles emit on both faces, spheres outward;
- the shadow ray: from the hit point biased along the normal towards the
  light point, answered by ``closest_hit``: the point is visible where
  nothing is hit before the bound;
- the light term L_e cos_surf cos_light / (d^2 pdf_area) times the BSDF:
  albedo / pi for the Lambertian lobe; for GGX the reflection term of
  Walter et al. 2007, "Microfacet Models for Refraction through Rough
  Surfaces", F D G1(wo) G1(wi) / (4 cos_o cos_i), in ``bsdf``'s
  conventions (alpha = roughness^2, Schlick F0 = lerp(0.04, albedo,
  metallic), separable Smith G1).  The BSDF pdfs in solid angle are
  cos / pi and D cos_h / (4 wo.h), the density of the half-vector
  sampling;
- MIS (Veach 1995, ch. 9), the balance heuristic: a light sample weighs
  p_light / (p_light + p_bsdf); an emitter reached by the BSDF sample of a
  lobe that sampled a light weighs p_bsdf / (p_bsdf + p_light), with
  p_light = luminance / total * t^2 / cos_hit.  Lambertian and GGX lobes
  sample lights; metal and dielectric count as delta lobes, whose emitter
  hits keep their full weight.  With ``mis`` off only Lambertian lobes
  sample lights, and an emitter reached from one counts 0.

The draws of a lane in a segment come in the measured program's order:
the three of the light sample (the pick, then two for the point), on live
lanes whose lobe samples a light; the dielectric's; GGX's two; the six of
the random direction; roulette's.  So every lane's stream is the
program's.

Departures from the published equations, each one the measured program
makes too: the shadow ray stops at 0.999 of the distance to the light
point (d - 1e-3 d), so the light's own surface never occludes; the light
pdf is taken in solid angle, pdf_area d^2 / cos_light; guards against 0/0
(the distance floored at 1e-6, the first triangle draw at 1e-12, the
light's cosine at 1e-6 in the pdf, the total weight and the area pdf at
1e-20, the emitter's cosine at 1e-6 in p_light, the half vector's length
at 1e-12, D's denominator at 1e-12, the GGX denominators at 1e-6, the
BSDF pdf carried to the next hit at 1e-12, a light pdf not above 1e-12
weighs 0); and a pick draw that rounds to 1 (the float32 rounding of a
32-bit draw) falls past the last light and samples none.  ``bsdf``'s
departures hold as it lists them.  Pixel jitter, the edge estimator and
far sphere roots are outside it (``covers``).  It has no ``loss_grad``: no
training cell names it.

``dtype`` is the float type of the whole computation: float32 is the
reference, bfloat16 the control that must fail the comparison.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bsdf
from . import transport as tp
from .bsdf import prepare  # noqa: F401
from .transport import (accumulate, exact_matmuls,  # noqa: F401
                        with_camera, with_material)

METAL, DIELECTRIC, LAMBERTIAN, GGX = (bsdf.METAL, bsdf.DIELECTRIC,
                                      bsdf.LAMBERTIAN, bsdf.GGX)
PI = float(np.float32(np.pi))
FOUR_PI = float(np.float32(4.0) * np.float32(np.pi))
LUMA = tuple(float(np.float32(w)) for w in (0.2126, 0.7152, 0.0722))
SHADOW_SHORT = 1e-3     # the shadow ray stops this share short of the light


def covers(raw: dict, render: dict) -> str | None:
    """Why this raw scene and render dictionary lie outside the reference,
    or None."""
    types = {m.get("mtype", METAL) for m in raw["materials"]}
    if not types <= {METAL, DIELECTRIC, LAMBERTIAN, GGX}:
        return f"the reference covers material types 0-3, not {types}"
    if render.get("pixel_jitter"):
        return "the reference traces pixel centres (pixel_jitter off)"
    if render.get("edge_grads"):
        return "the reference has no edge estimator (edge_grads off)"
    if render.get("sphere_near_root_only") is False:
        return "the reference answers spheres with the near root alone"
    return None


def _luminance(rgb):
    return LUMA[0] * rgb[..., 0] + LUMA[1] * rgb[..., 1] \
        + LUMA[2] * rgb[..., 2]


@dataclasses.dataclass
class Lights:
    """The light set in pick order: spheres, then triangles."""

    on_sphere: torch.Tensor    # (L,) bool
    index: torch.Tensor        # (L,) int64, a sphere or a triangle row
    cum: torch.Tensor          # (L,) cumulative weights
    total: torch.Tensor        # () the sum of the weights


def light_set(sc: tp.Scene) -> Lights:
    """Every emissive sphere and triangle, weighted by area x luminance."""
    mat = sc.materials
    lum = _luminance(mat["emission"]) * mat["emission_strength"]
    s_area = FOUR_PI * sc.sph_radius * sc.sph_radius
    s_w = s_area * lum[sc.sph_material]
    cr = tp._cross(sc.b - sc.a, sc.c - sc.a)
    t_area = 0.5 * tp._safe_sqrt(tp._dot(cr, cr))
    t_w = t_area * lum[sc.tri_material]
    s_ids = torch.nonzero(s_w > 0.0).squeeze(1)
    t_ids = torch.nonzero(t_w > 0.0).squeeze(1)
    centroid = ((sc.a[t_ids] + sc.b[t_ids] + sc.c[t_ids]) / 3.0).float()
    for axis in (2, 1, 0):          # stable sorts: x, then y, then z
        order = torch.sort(centroid[:, axis], stable=True).indices
        t_ids, centroid = t_ids[order], centroid[order]
    w = torch.cat([s_w[s_ids], t_w[t_ids]])
    cum = torch.cumsum(w, 0)
    total = cum[-1] if w.numel() else torch.zeros((), dtype=w.dtype,
                                                  device=w.device)
    on_sphere = torch.arange(len(s_ids) + len(t_ids), device=w.device) \
        < len(s_ids)
    return Lights(on_sphere=on_sphere, index=torch.cat([s_ids, t_ids]),
                  cum=cum, total=total)


def _half(wo, wi):
    h = wo + wi
    return h / torch.clamp_min(tp._safe_sqrt(tp._dot(h, h)), 1e-12)[:, None]


def _ggx_d(cos_h, alpha):
    """The GGX distribution of normals, alpha^2 / (pi (cos^2 (alpha^2 - 1)
    + 1)^2)."""
    a2 = alpha * alpha
    c = torch.clamp(cos_h, 0.0, 1.0)
    k = c * c * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(PI * k * k, 1e-12)


def ggx_eval(n, wo, wi, albedo, rough, metallic):
    """Walter et al.'s reflection term F D G1(wo) G1(wi) / (4 cos_o cos_i);
    0 below the surface."""
    alpha = torch.clamp(rough * rough, min=1e-4)
    h = _half(wo, wi)
    cos_h, cos_oh = tp._dot(h, n), tp._dot(wo, h)
    cos_o, cos_i = tp._dot(wo, n), tp._dot(wi, n)
    f0 = 0.04 * (1.0 - metallic[:, None]) + albedo * metallic[:, None]
    x = 1.0 - torch.clamp(cos_oh, 0.0, 1.0)[:, None]
    fresnel = f0 + (1.0 - f0) * (x * ((x * x) * (x * x)))
    g = bsdf._smith_g1(cos_o, alpha) * bsdf._smith_g1(cos_i, alpha)
    f = fresnel * (_ggx_d(cos_h, alpha) * g
                   / torch.clamp_min(4.0 * cos_o * cos_i, 1e-6))[:, None]
    valid = (cos_i > 0.0) & (cos_o > 0.0) & (cos_oh > 0.0)
    return torch.where(valid[:, None], f, 0.0)


def ggx_pdf(n, wo, wi, rough):
    """The solid-angle density of the half-vector sampling, D cos_h /
    (4 wo.h); 0 below the surface."""
    alpha = torch.clamp(rough * rough, min=1e-4)
    h = _half(wo, wi)
    cos_h, cos_oh = tp._dot(h, n), tp._dot(wo, h)
    pdf = _ggx_d(cos_h, alpha) * torch.clamp_min(cos_h, 0.0) \
        / torch.clamp_min(4.0 * cos_oh, 1e-6)
    valid = (tp._dot(wi, n) > 0.0) & (tp._dot(wo, n) > 0.0) & (cos_oh > 0.0)
    return torch.where(valid, pdf, 0.0)


def lambert_pdf(n, wi):
    return torch.clamp_min(tp._dot(n, wi), 0.0) / PI


def light_sample(sc: tp.Scene, lights: Lights, p, n, seed, mask):
    """One light sample per lane of ``mask`` -> (L_e G / pdf_area where the
    light point is visible, else 0 (R, 3); the direction to it (R, 3); its
    pdf in solid angle where visible, else 0 (R,); seed).  Three masked
    draws: the pick, then two for the point."""
    dtype = sc.dtype
    u_pick, seed = tp._rand_masked(seed, mask, dtype)
    u1, seed = tp._rand_masked(seed, mask, dtype)
    u2, seed = tp._rand_masked(seed, mask, dtype)
    R = p.shape[0]
    if lights.index.numel() == 0:
        return torch.zeros_like(p), torch.zeros_like(p), \
            torch.zeros(R, dtype=dtype, device=p.device), seed
    k = torch.searchsorted(lights.cum, u_pick * lights.total, right=True)
    picked = k < lights.index.numel()
    k = k.clamp_max(lights.index.numel() - 1)
    on_sphere, row = lights.on_sphere[k], lights.index[k]
    mat = sc.materials

    # a point on the sphere, uniform over its surface
    z = 1.0 - 2.0 * u1
    r_xy = tp._safe_sqrt(1.0 - z * z)
    phi = tp.TWO_PI * u2
    n_sph = torch.stack([r_xy * torch.cos(phi), r_xy * torch.sin(phi), z], -1)
    if sc.sph_radius.numel():
        s_row = torch.where(on_sphere, row, 0)
        p_sph = sc.sph_center[s_row] + sc.sph_radius[s_row][:, None] * n_sph
        s_mat = sc.sph_material[s_row]
    else:
        p_sph, s_mat = torch.zeros_like(p), torch.zeros_like(row)
    # a point on the triangle, uniform by the square-root barycentrics
    t_row = torch.where(on_sphere, 0, row)
    a, b, c = sc.a[t_row], sc.b[t_row], sc.c[t_row]
    su = torch.sqrt(torch.clamp(u1, 1e-12, 1.0))
    b0, b1 = 1.0 - su, u2 * su
    p_tri = a * b0[:, None] + b * b1[:, None] + c * (1.0 - b0 - b1)[:, None]
    n_tri = tp._normalize(tp._cross(b - a, c - a), 1e-20)

    p_light = torch.where(on_sphere[:, None], p_sph, p_tri)
    n_light = torch.where(on_sphere[:, None], n_sph, n_tri)
    light_mat = torch.where(on_sphere, s_mat, sc.tri_material[t_row])
    radiance = mat["emission"][light_mat] \
        * mat["emission_strength"][light_mat][:, None]
    lum = _luminance(mat["emission"][light_mat]) \
        * mat["emission_strength"][light_mat]

    to_light = p_light - p
    dist = tp._safe_sqrt(tp._dot(to_light, to_light))
    d_safe = torch.clamp_min(dist, 1e-6)
    wi = to_light / d_safe[:, None]
    cos_surf = tp._dot(n, wi)
    cos_light = tp._dot(n_light, -wi)
    cos_light = torch.where(on_sphere, cos_light, torch.abs(cos_light))

    enabled = mask & picked & (lights.total > 0.0)
    hits = tp.closest_hit(sc, p + n * tp.BIAS, wi, enabled)
    visible = torch.minimum(hits[0], hits[2]) >= dist - SHADOW_SHORT * d_safe

    pdf_area = torch.clamp_min(lum / torch.clamp_min(lights.total, 1e-20),
                               1e-20)
    geometry = torch.clamp_min(cos_surf, 0.0) \
        * torch.clamp_min(cos_light, 0.0) / (d_safe * d_safe)
    ok = enabled & visible & (cos_surf > 0.0) & (cos_light > 0.0) \
        & (lum > 0.0)
    pdf_sa = pdf_area * (d_safe * d_safe) \
        / torch.clamp_min(torch.clamp_min(cos_light, 0.0), 1e-6)
    return (torch.where(ok[:, None], radiance * (geometry / pdf_area)[:, None],
                        0.0),
            wi, torch.where(ok, pdf_sa, 0.0), seed)


def trace(sc: tp.Scene, o, d, seed, cfg: dict):
    """max_bounces + 1 segments over a ray batch -> (radiance (R, 3), the
    lanes' streams after the last draw)."""
    dtype = sc.dtype
    mat = sc.materials
    alive = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    total = torch.zeros_like(d)
    trans = torch.ones_like(d)
    pdf_prev = torch.zeros_like(d[:, 0])   # 0: the next emitter counts whole
    rr_from = cfg.get("rr_start_bounce", 3) if cfg.get("use_rr") else None
    nee, mis = cfg.get("use_nee", False), cfg.get("mis", True)
    lights = light_set(sc) if nee else None
    for bounce in range(cfg["max_bounces"] + 1):
        t, p, n, front, hit, mid = bsdf._resolve(
            sc, o, d, tp.closest_hit(sc, o, d, alive))
        total = total + torch.where((alive & ~hit)[:, None],
                                    tp._sky(d, cfg["sky"]) * trans, 0.0)
        live = alive & hit
        m = {k: v[mid] for k, v in mat.items()}
        kind = m["mtype"]
        is_diel, is_lam, is_ggx = (kind == DIELECTRIC, kind == LAMBERTIAN,
                                   kind == GGX)

        # emission, weighed against the light sample that the last vertex
        # made (pdf_prev > 0 there)
        emitted = m["emission"] * m["emission_strength"][:, None] * trans
        if nee:
            after_light = pdf_prev > 0.0
            if mis:
                lum_hit = _luminance(m["emission"]) * m["emission_strength"]
                cos_hit = torch.clamp_min(-tp._dot(n, d), 1e-6)
                p_light = lum_hit / torch.clamp_min(lights.total, 1e-20) \
                    * t * t / cos_hit
                w_emit = torch.where(after_light,
                                     pdf_prev / (pdf_prev + p_light), 1.0)
            else:
                w_emit = torch.where(after_light, 0.0, 1.0)
            emitted = emitted * w_emit[:, None]
        total = total + torch.where(live[:, None], emitted, 0.0)

        # the light sample
        if nee:
            samples_light = live & ((is_lam | is_ggx) if mis else is_lam)
            direct, wi, p_l, seed = light_sample(sc, lights, p, n, seed,
                                                 samples_light)
            f = m["albedo"] / PI
            if mis:
                f = torch.where(is_ggx[:, None],
                                ggx_eval(n, -d, wi, m["albedo"],
                                         m["roughness"], m["metallic"]), f)
                p_b = torch.where(is_ggx, ggx_pdf(n, -d, wi, m["roughness"]),
                                  lambert_pdf(n, wi))
                use = p_l > 1e-12
                w_light = torch.where(use, p_l / torch.where(use, p_l + p_b,
                                                             1.0), 0.0)
                direct = direct * f * trans * w_light[:, None]
            else:
                direct = direct * f * trans
            total = total + torch.where(samples_light[:, None], direct, 0.0)

        # the four lobes, as ``bsdf`` defines them
        eta_i = torch.where(front, 1.0, m["ior"])
        eta_t = torch.where(front, m["ior"], 1.0)
        reflect_prob = bsdf._fresnel(d, n, eta_i, eta_t)
        refr, tir = bsdf._refract(d, n, eta_i / eta_t)
        u_refl, seed = tp._rand_masked(seed, live & is_diel & ~tir, dtype)
        u_g1, seed = tp._rand_masked(seed, live & is_ggx, dtype)
        u_g2, seed = tp._rand_masked(seed, live & is_ggx, dtype)
        rdir, seed = tp._random_direction(seed, live & ~is_ggx, dtype)

        rough = m["roughness"][:, None]
        refl = d - 2.0 * tp._dot(d, n)[:, None] * n
        d_metal = tp._normalize(refl + rough * rdir, 1e-20)
        follow_reflect = tir | (u_refl <= reflect_prob)
        d_diel = tp._normalize(
            torch.where(follow_reflect[:, None], refl, refr) + rough * rdir,
            1e-20)
        beer = torch.exp(-m["absorption"] * m["absorption_strength"][:, None]
                         * t[:, None])
        d_lam = n + rdir
        lam_len = torch.sqrt(torch.clamp_min(tp._dot(d_lam, d_lam),
                                             1e-12))[:, None]
        d_lam = torch.where(lam_len < 1e-6, n, d_lam / lam_len)
        d_ggx, w_ggx, ggx_valid = bsdf._ggx_sample(
            n, -d, m["albedo"], m["roughness"], m["metallic"], u_g1, u_g2)
        d_ggx = tp._normalize(d_ggx, 1e-20)

        new_d = torch.where(is_diel[:, None], d_diel,
                            torch.where(is_lam[:, None], d_lam,
                                        torch.where(is_ggx[:, None], d_ggx,
                                                    d_metal)))
        new_o = torch.where(
            is_diel[:, None],
            p + tp.BIAS * n * torch.sign(tp._dot(d_diel, n))[:, None],
            p + n * tp.BIAS)
        absorb = ~follow_reflect & ~front
        tput = torch.where((is_diel | is_ggx)[:, None],
                           torch.where(is_ggx[:, None], w_ggx,
                                       torch.where(absorb[:, None], beer,
                                                   1.0)),
                           m["albedo"])
        trans = torch.where(live[:, None], trans * tput, trans)
        live = live & (~is_ggx | ggx_valid)

        if rr_from is not None and bounce >= rr_from:
            survive = torch.clamp(torch.amax(trans, -1), 0.05, 1.0)
            u_rr, seed = tp._rand_masked(seed, live, dtype)
            keep = live & ~(u_rr > survive)
            trans = torch.where(keep[:, None], trans / survive[:, None],
                                trans)
            live = keep

        # the BSDF pdf of the sampled direction, for the next emitter's
        # weight, where this vertex sampled a light
        if nee:
            if mis:
                p_scatter = torch.where(
                    is_ggx, ggx_pdf(n, -d, new_d, m["roughness"]),
                    lambert_pdf(n, new_d))
                pdf_prev = torch.where(samples_light & live,
                                       torch.clamp_min(p_scatter, 1e-12),
                                       0.0)
            else:
                pdf_prev = torch.where(samples_light & live, 1.0, 0.0)
        o = torch.where(live[:, None], new_o, o)
        d = torch.where(live[:, None], new_d, d)
        alive = live
    return total, seed


@torch.no_grad()
def render_frame(sc: tp.Scene, cfg: dict, frame: int):
    """One frame (H, W, 3): the mean of ``samples`` paths per pixel."""
    W, H = cfg["width"], cfg["height"]
    dev = sc.a.device
    pos, dirs = tp.camera_rays(sc.camera, W, H, dev)
    dirs = dirs.reshape(-1, 3).to(sc.dtype)
    seed = tp.pixel_seed(torch.arange(W * H, device=dev), frame)
    origin = pos.to(sc.dtype).expand(W * H, 3)
    acc = torch.zeros_like(dirs)
    for _ in range(cfg["samples"]):
        light, seed = trace(sc, origin, dirs, seed, cfg)
        acc = acc + light
    return (acc / float(cfg["samples"])).view(H, W, 3)
