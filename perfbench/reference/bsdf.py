"""Plain reference of the full-BSDF configuration: the four material models
(metal, dielectric, Lambertian, GGX) and Russian roulette, for serving.

Plain PyTorch, on whatever device its inputs are on; it imports nothing of
the measured package.  It shares ``transport``'s PCG streams, camera rays,
group-culled brute-force closest hits and accumulation, and writes here
what ``transport`` leaves out: a material table with every field the four
models read, a hit record with the front/back flag and the distance, and
the transport of each model as the reference shader and its extensions
define it (src/shaders/pathTracer.comp; SURVEY.md section 2):

- sky and emission (:248-253), as ``transport``;
- METAL (:256-262): the mirror direction plus roughness times the
  random direction, normalized; throughput times albedo;
- DIELECTRIC (:263-280): unpolarized Fresnel, CalculateReflectance
  (:213-234), against one draw that is skipped under total internal
  reflection (the short-circuit ``||`` of :273); reflect or refract (GLSL
  ``refract``, zero under total internal reflection), plus roughness times
  the random direction, normalized; Beer-Lambert ``exp(-absorption *
  strength * t)`` where the path refracts out through a back face; the
  origin biased along the side of the surface the new direction leaves to;
- LAMBERTIAN (extension): cosine-weighted, the normal plus the unit random
  direction, normalized; throughput times albedo;
- GGX (extension): the microfacet conductor lobe of Walter et al. 2007,
  "Microfacet Models for Refraction through Rough Surfaces": the half
  vector drawn from the GGX distribution (alpha = roughness squared) with
  two draws, in a Frisvad basis around the normal; Smith's separable G1 for
  both directions; Schlick's Fresnel with F0 = lerp(0.04, albedo,
  metallic); weight F G |wo.h| / (|wo.n| |h.n|); a sample under the
  surface weighs 0 and ends the path;
- Russian roulette (extension) from ``rr_start_bounce``: survival
  clamp(max(throughput), 0.05, 1), one draw, throughput over the survival
  where the path survives.

The draws of a lane in a segment come in the measured program's order: the
dielectric's (live dielectric lanes not under total internal reflection),
GGX's two (live GGX lanes), the six of the random direction (live lanes
not GGX), then roulette's (live lanes from ``rr_start_bounce``), so every
lane's stream is the program's.  Spheres answer with their near root alone
(SURVEY.md 2.4, quirk 1): a refracted ray that enters a glass sphere leaves
it without a second hit.  Every lane runs every segment: the program's
alive-lane compaction is a schedule and changes no value.

Departures from the published equations: guards against 0/0 (Fresnel's
denominators below 1e-8 give reflectance 1; normalizations carry a floor
on the squared norm; the Lambertian direction falls back to the normal
where its length is below 1e-6; GGX clamps alpha to 1e-4, the first draw
below 1 - 1e-7, its cosines to [1e-6, 1] in G1 and the denominator to
1e-6), and the extension lobes' own conventions above.  NEE, pixel jitter,
the edge estimator and far sphere roots are outside it (``covers``).  It
has no ``loss_grad``: no training cell names it.

``dtype`` is the float type of the whole computation: float32 is the
reference, bfloat16 the control that must fail the comparison.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import transport as tp
from .transport import (accumulate, exact_matmuls,  # noqa: F401
                        with_camera, with_material)

METAL, DIELECTRIC, LAMBERTIAN, GGX = 0, 1, 2, 3
# every field a material row carries, with the builder's default
FIELDS = {"albedo": (3, 0.0), "emission": (3, 0.0),
          "emission_strength": (1, 0.0), "roughness": (1, 0.0),
          "metallic": (1, 0.0), "absorption": (3, 0.0),
          "absorption_strength": (1, 1.0), "ior": (1, 1.0)}
U1_MAX = float(np.float32(1.0 - 1e-7))


def covers(raw: dict, render: dict) -> str | None:
    """Why this raw scene and render dictionary lie outside the reference,
    or None."""
    types = {m.get("mtype", METAL) for m in raw["materials"]}
    if not types <= {METAL, DIELECTRIC, LAMBERTIAN, GGX}:
        return f"the reference covers material types 0-3, not {types}"
    if render.get("use_nee"):
        return "the reference has no next-event estimation (use_nee)"
    if render.get("pixel_jitter"):
        return "the reference traces pixel centres (pixel_jitter off)"
    if render.get("edge_grads"):
        return "the reference has no edge estimator (edge_grads off)"
    if render.get("sphere_near_root_only") is False:
        return "the reference answers spheres with the near root alone"
    return None


def prepare(raw: dict, device, dtype=torch.float32) -> tp.Scene:
    """The reference's tensors of a raw scene: ``transport``'s geometry
    (its check of the material types is handed Lambertian rows, since the
    table is built here) and a material table with every field."""
    mats = raw["materials"]
    sc = tp.prepare(dict(raw, materials=[{"mtype": LAMBERTIAN}] * len(mats)),
                    device, dtype)
    dev = torch.device(device)
    table = {"mtype": torch.tensor([m.get("mtype", METAL) for m in mats],
                                   device=dev)}
    for key, (width, default) in FIELDS.items():
        v = np.asarray([np.broadcast_to(np.asarray(m.get(key, default),
                                                   np.float32), (width,))
                        for m in mats], np.float32)
        table[key] = torch.tensor(v if width > 1 else v[:, 0], device=dev,
                                  dtype=dtype)
    return dataclasses.replace(sc, materials=table)


def _resolve(sc: tp.Scene, o, d, hits):
    """Re-shade the winners from (o, d) -> (t, p, normal turned against the
    ray, front, hit, material); ``front`` is whether the ray met the
    surface's outer side (pathTracer.comp:206-207)."""
    t_s, s_idx, t_tri, t_idx = hits
    kinf = tp._kinf(d.dtype)
    tri_hit = t_tri < kinf
    use_tri = tri_hit & (t_tri < t_s)
    hit = torch.minimum(t_tri, t_s) < kinf
    unit = torch.eye(3, dtype=d.dtype, device=d.device)
    a = torch.where(tri_hit[:, None], sc.a[t_idx], 0.0)
    e1 = torch.where(tri_hit[:, None], sc.b[t_idx], unit[0]) - a
    e2 = torch.where(tri_hit[:, None], sc.c[t_idx], unit[1]) - a
    det = tp._dot(e1, tp._cross(d, e2))
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    t_tri_w = tp._dot(e2, tp._cross(o - a, e1)) * inv_det
    if sc.sph_radius.shape[0]:
        center, radius = sc.sph_center[s_idx], sc.sph_radius[s_idx]
        sph_mat = sc.sph_material[s_idx]
    else:
        center = torch.zeros_like(d)
        radius = torch.zeros_like(d[:, 0])
        sph_mat = torch.zeros_like(t_idx)
    t_sph_w = tp._ray_sphere_near(o, d, center, radius)
    t = torch.where(hit, torch.where(use_tri, t_tri_w, t_sph_w), 1.0)
    p = o + t[:, None] * d
    n_sph = (p - center) / torch.where(radius > 0.0, radius, 1.0)[:, None]
    n_tri = tp._normalize(tp._cross(e1, e2), 1e-20)
    normal = torch.where(use_tri[:, None], n_tri, n_sph)
    front = tp._dot(d, normal) < 0.0
    normal = torch.where(front[:, None], normal, -normal)
    normal = torch.where(hit[:, None], normal,
                         torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype,
                                      device=d.device))
    material = torch.where(use_tri, sc.tri_material[t_idx], sph_mat)
    return t, p, normal, front, hit, material


def _fresnel(d, n, eta_a, eta_b):
    """CalculateReflectance (pathTracer.comp:213-234): unpolarized Fresnel
    from the medium of index ``eta_a`` into ``eta_b``; 1 under total
    internal reflection and where a denominator vanishes."""
    ratio = eta_a / eta_b
    cos_in = -tp._dot(d, n)
    sin2 = ratio * ratio * (1.0 - cos_in * cos_in)
    cos_t = tp._safe_sqrt(1.0 - sin2)
    den_s = eta_a * cos_in + eta_b * cos_t
    den_p = eta_b * cos_in + eta_a * cos_t
    r_s = (eta_a * cos_in - eta_b * cos_t) \
        / torch.where(torch.abs(den_s) < 1e-8, 1.0, den_s)
    r_p = (eta_b * cos_in - eta_a * cos_t) \
        / torch.where(torch.abs(den_p) < 1e-8, 1.0, den_p)
    refl = (r_s * r_s + r_p * r_p) * 0.5
    return torch.where((sin2 >= 1.0) | (torch.minimum(den_s, den_p) < 1e-8),
                       1.0, refl)


def _refract(d, n, eta):
    """GLSL refract -> (direction, total internal reflection); the zero
    vector under total internal reflection."""
    cos_i = tp._dot(n, d)[:, None]
    eta = eta[:, None]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = eta * d - (eta * cos_i + tp._safe_sqrt(k)) * n
    return torch.where(k < 0.0, 0.0, out), (k < 0.0)[:, 0]


def _basis(n):
    """Frisvad's orthonormal basis (t, b) around the unit normal n."""
    sign = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    bb = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * (n[:, 0] * n[:, 0]) * a, sign * bb,
                     -sign * n[:, 0]], -1)
    b = torch.stack([bb, sign + (n[:, 1] * n[:, 1]) * a, -n[:, 1]], -1)
    return t, b


def _smith_g1(cos_v, alpha):
    c = torch.clamp(cos_v, 1e-6, 1.0)
    tan2 = (1.0 - c * c) / (c * c)
    return 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))


def _ggx_sample(n, wo, albedo, rough, metallic, u1, u2):
    """The GGX conductor lobe around ``n``, ``wo`` pointing away from the
    surface -> (wi, f cos / pdf, valid)."""
    alpha = torch.clamp(rough * rough, min=1e-4)
    u1 = torch.clamp(u1, 0.0, U1_MAX)
    tan2 = (alpha * alpha) * u1 / (1.0 - u1)
    cos_h = 1.0 / torch.sqrt(1.0 + tan2)
    sin_h = tp._safe_sqrt(1.0 - cos_h * cos_h)
    phi = tp.TWO_PI * u2
    t, b = _basis(n)
    h = (t * (sin_h * torch.cos(phi))[:, None]
         + b * (sin_h * torch.sin(phi))[:, None] + n * cos_h[:, None])
    cos_oh = tp._dot(wo, h)
    wi = 2.0 * cos_oh[:, None] * h - wo
    cos_o, cos_i, cos_hn = tp._dot(wo, n), tp._dot(wi, n), tp._dot(h, n)
    f0 = 0.04 * (1.0 - metallic[:, None]) + albedo * metallic[:, None]
    x = 1.0 - torch.clamp(cos_oh, 0.0, 1.0)[:, None]
    fresnel = f0 + (1.0 - f0) * (x * ((x * x) * (x * x)))
    g = _smith_g1(cos_o, alpha) * _smith_g1(cos_i, alpha)
    weight = fresnel * (g * torch.clamp(cos_oh, min=0.0)
                        / torch.clamp(cos_o * cos_hn, min=1e-6))[:, None]
    valid = (cos_i > 0.0) & (cos_o > 0.0) & (cos_oh > 0.0)
    return wi, torch.where(valid[:, None], weight, 0.0), valid


def trace(sc: tp.Scene, o, d, seed, cfg: dict):
    """max_bounces + 1 segments over a ray batch -> (radiance (R, 3), the
    lanes' streams after the last draw)."""
    dtype = sc.dtype
    mat = sc.materials
    alive = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    total = torch.zeros_like(d)
    trans = torch.ones_like(d)
    rr_from = cfg.get("rr_start_bounce", 3) if cfg.get("use_rr") else None
    for bounce in range(cfg["max_bounces"] + 1):
        t, p, n, front, hit, mid = _resolve(
            sc, o, d, tp.closest_hit(sc, o, d, alive))
        total = total + torch.where((alive & ~hit)[:, None],
                                    tp._sky(d, cfg["sky"]) * trans, 0.0)
        live = alive & hit
        m = {k: v[mid] for k, v in mat.items()}
        kind = m["mtype"]
        is_diel, is_lam, is_ggx = (kind == DIELECTRIC, kind == LAMBERTIAN,
                                   kind == GGX)
        total = total + torch.where(
            live[:, None],
            m["emission"] * m["emission_strength"][:, None] * trans, 0.0)

        eta_i = torch.where(front, 1.0, m["ior"])
        eta_t = torch.where(front, m["ior"], 1.0)
        reflect_prob = _fresnel(d, n, eta_i, eta_t)
        refr, tir = _refract(d, n, eta_i / eta_t)
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
        d_ggx, w_ggx, ggx_valid = _ggx_sample(
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
