"""Plain reference path tracer for the benchmark's configurations.

Plain PyTorch, on whatever device its inputs are on; it imports nothing of
the measured package and takes nothing the program made: it is handed the
raw scene (vertices, indices, materials, spheres, camera) that the
benchmark loads for both sides.

It follows the measured renderer's transport as the reference shader
defines it (src/shaders/pathTracer.comp): one lane per ray, max_bounces + 1
path segments, the shader's per-pixel PCG streams with masked draws,
near-root-only spheres, flat triangle normals that face the ray, the
running-mean accumulation.  It covers the two material types the
benchmark's scenes use, Lambertian and metal, with next-event estimation,
Russian roulette and pixel jitter off; anything else raises.

Closest hits are brute force: every ray is tested against every triangle
of each fixed group of triangles whose padded box it crosses (the groups
are this module's own, built from the raw triangles).  The search is
detached; the winner is re-shaded from the ray so that material gradients
follow the ray's dependence on earlier bounces, as in the program.

``dtype`` is the float type of the whole computation: float32 is the
reference, bfloat16 the control that must fail the comparison.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
KINF = float(np.float32(3.402823466e38))
BIAS = float(np.float32(1e-5))
TWO_PI = float(np.float32(2.0) * np.float32(np.pi))
METAL, LAMBERTIAN = 0, 2
GROUP_TRIS = 1024          # triangles per culling group
TRAINABLE = ("albedo", "emission", "emission_strength", "roughness")


# --- PCG streams (src/shaders/include/Random.glsl)

def _permute(state):
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def pixel_seed(pixel_index, frame: int):
    frame = (int(frame) & MASK32) * 719393
    return _permute((((pixel_index + frame) & MASK32) * 747796405
                     + 2891336453) & MASK32)


def _rand_masked(state, mask, dtype):
    x = _permute(state)
    return (x.to(torch.float32) * 2.0 ** -32).to(dtype), \
        torch.where(mask, x, state)


def _random_direction(state, mask, dtype):
    """Six masked draws: three Box-Muller normals, normalized."""
    comps = []
    for _ in range(3):
        u1, state = _rand_masked(state, mask, dtype)
        u2, state = _rand_masked(state, mask, dtype)
        comps.append(torch.sqrt(-2.0 * torch.log(u2))
                     * torch.cos(TWO_PI * u1))
    x, y, z = comps
    norm = torch.sqrt(x * x + y * y + z * z)
    return torch.stack([x / norm, y / norm, z / norm], -1), state


# --- vector helpers

def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _safe_sqrt(x):
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _normalize(v, eps):
    guard = float(np.float32(max(eps * eps, 1.1754944e-38)))
    n2 = _dot(v, v)[..., None]
    return v / torch.sqrt(torch.maximum(n2, torch.full_like(n2, guard)))


# --- the scene

@dataclasses.dataclass
class Scene:
    """Raw scene tensors: live rows only."""

    materials: dict          # mtype (M,) int64; float tables (M, k)
    a: torch.Tensor          # (T, 3) triangle corners
    b: torch.Tensor
    c: torch.Tensor
    tri_material: torch.Tensor   # (T,) int64
    groups: list             # [(triangle ids (n,), box min (3,), max (3,))]
    sph_center: torch.Tensor     # (S, 3)
    sph_radius: torch.Tensor     # (S,)
    sph_material: torch.Tensor   # (S,) int64
    camera: dict
    dtype: torch.dtype


def _groups(centroids: np.ndarray, ids: np.ndarray) -> list:
    """Median splits along the widest centroid axis down to GROUP_TRIS."""
    if len(ids) <= GROUP_TRIS:
        return [np.sort(ids)]
    c = centroids[ids]
    axis = int(np.argmax(c.max(0) - c.min(0)))
    order = ids[np.argsort(c[:, axis], kind="stable")]
    half = len(order) // 2
    return _groups(centroids, order[:half]) + _groups(centroids, order[half:])


def prepare(raw: dict, device, dtype=torch.float32) -> Scene:
    """The reference's tensors of a raw scene (perfbench.scenes)."""
    dev = torch.device(device)
    mats = raw["materials"]
    types = {m["mtype"] for m in mats}
    if not types <= {METAL, LAMBERTIAN}:
        raise NotImplementedError(
            f"the reference covers metal and Lambertian materials, not "
            f"{types}")

    def col(key, width):
        v = np.asarray([np.broadcast_to(np.asarray(m.get(key, 0.0),
                                                   np.float32), (width,))
                        for m in mats], np.float32)
        return torch.tensor(v if width > 1 else v[:, 0], device=dev,
                            dtype=dtype)

    materials = dict(mtype=torch.tensor([m["mtype"] for m in mats],
                                        device=dev),
                     albedo=col("albedo", 3), emission=col("emission", 3),
                     emission_strength=col("emission_strength", 1),
                     roughness=col("roughness", 1))
    v = np.asarray(raw["vertices"], np.float32).reshape(-1, 3)
    tri = v[np.asarray(raw["indices"], np.int64).reshape(-1, 3)]   # (T, 3, 3)
    corners = torch.tensor(tri, device=dev, dtype=dtype)
    pad = 1e-4 * float(np.abs(v).max() + 1.0)
    groups = []
    for ids in _groups(tri.mean(1), np.arange(len(tri))):
        pts = tri[ids].reshape(-1, 3)
        groups.append((torch.tensor(ids, device=dev),
                       torch.tensor(pts.min(0) - pad, device=dev),
                       torch.tensor(pts.max(0) + pad, device=dev)))
    sph = raw["spheres"]
    return Scene(
        materials=materials, a=corners[:, 0], b=corners[:, 1],
        c=corners[:, 2],
        tri_material=torch.tensor(np.asarray(raw["tri_material"], np.int64),
                                  device=dev),
        groups=groups,
        sph_center=torch.tensor([s["position"] for s in sph],
                                dtype=dtype, device=dev).reshape(-1, 3),
        sph_radius=torch.tensor([s["radius"] for s in sph], dtype=dtype,
                                device=dev),
        sph_material=torch.tensor([s["material"] for s in sph],
                                  dtype=torch.int64, device=dev),
        camera=raw["camera"], dtype=dtype)


# --- camera (src/PathTracingRenderer.jai:6-36, pathTracer.comp:289-302)

def _camera_matrices(cam: dict, aspect: float, device):
    """Inverse projection, inverse view and position, in float32."""
    f32 = torch.float32
    t = lambda x: torch.as_tensor(np.array(x, np.float32), device=device)
    pos, yaw, pitch, fov = (t(cam["position"]), t(cam["yaw"]),
                            t(cam["pitch"]), t(cam["fov"]))
    ry, rp = torch.deg2rad(yaw), torch.deg2rad(pitch)
    d = torch.stack([torch.cos(ry) * torch.cos(rp), torch.sin(rp),
                     torch.sin(ry) * torch.cos(rp)])
    d = d / torch.linalg.vector_norm(d)
    f = (pos + d) - pos
    f = f / torch.linalg.vector_norm(f)
    up = torch.tensor((0.0, 1.0, 0.0), dtype=f32, device=device)

    def cross(p, q):
        return torch.stack([p[1] * q[2] - p[2] * q[1],
                            p[2] * q[0] - p[0] * q[2],
                            p[0] * q[1] - p[1] * q[0]])
    s = cross(f, up)
    s = s / torch.linalg.vector_norm(s)
    u = cross(s, f)
    zero = torch.zeros((), dtype=f32, device=device)
    view = torch.stack([
        torch.cat([s, -torch.dot(s, pos)[None]]),
        torch.cat([u, -torch.dot(u, pos)[None]]),
        torch.cat([-f, torch.dot(f, pos)[None]]),
        torch.stack([zero, zero, zero, zero + 1.0])])
    g = 1.0 / torch.tan(torch.deg2rad(fov) * 0.5)
    near, far = np.float32(0.1), np.float32(100.0)
    z = torch.zeros_like(g)
    proj = torch.stack([
        torch.stack([g / float(np.float32(aspect)), z, z, z]),
        torch.stack([z, g, z, z]),
        torch.stack([z, z, z + float((far + near) / (near - far)),
                     z + float(np.float32(2.0) * far * near / (near - far))]),
        torch.stack([z, z, z - 1.0, z])])
    return torch.linalg.inv(proj), torch.linalg.inv(view), pos


def _mat4_vec(m, v):
    return torch.stack([m[i, 0] * v[..., 0] + m[i, 1] * v[..., 1]
                        + m[i, 2] * v[..., 2] + m[i, 3] * v[..., 3]
                        for i in range(4)], -1)


def _unit_rows(v):
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v / torch.sqrt(n2)[..., None]


def camera_rays(cam: dict, width: int, height: int, device):
    """(origin (3,), directions (H, W, 3)) in float32."""
    inv_proj, inv_view, pos = _camera_matrices(cam, width / height, device)
    f32 = torch.float32
    x = (torch.arange(width, dtype=f32, device=device) + 0.5) / float(width)
    y = (torch.arange(height, dtype=f32, device=device) + 0.5) / float(height)
    cy, cx = torch.meshgrid(y, x, indexing="ij")
    cy = (1.0 - cy) * 2.0 - 1.0
    cx = cx * 2.0 - 1.0
    ones = torch.ones_like(cx)
    target = _mat4_vec(inv_proj, torch.stack([cx, cy, ones, ones], -1))
    d_cam = _unit_rows(target[..., :3] / target[..., 3:4])
    d_cam4 = torch.cat([d_cam, torch.zeros_like(d_cam[..., :1])], -1)
    return pos, _unit_rows(_mat4_vec(inv_view, d_cam4)[..., :3])


# --- closest hit

def _kinf(dtype) -> float:
    """The no-hit distance: float32's largest value, as the shader's
    kInfinity, or the largest of a narrower type."""
    return min(KINF, torch.finfo(dtype).max)


def _moller_trumbore(o, d, a, b, c):
    """(R, 3) rays x (n, 3) triangles -> t (R, n), no-hit where missed."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ax, ay, az = a[None, :, 0], a[None, :, 1], a[None, :, 2]
    e1x, e1y, e1z = (b[None, :, 0] - ax, b[None, :, 1] - ay,
                     b[None, :, 2] - az)
    e2x, e2y, e2z = (c[None, :, 0] - ax, c[None, :, 1] - ay,
                     c[None, :, 2] - az)
    oax, oay, oaz = ox - ax, oy - ay, oz - az
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    inv_det = 1.0 / (e1x * px + e1y * py + e1z * pz)
    qx = oay * e1z - oaz * e1y
    qy = oaz * e1x - oax * e1z
    qz = oax * e1y - oay * e1x
    u = (oax * px + oay * py + oaz * pz) * inv_det
    v = dx * (qx * inv_det) + dy * (qy * inv_det) + dz * (qz * inv_det)
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (t > 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(hit, t, _kinf(t.dtype))


def _ray_sphere_near(o, d, center, radius):
    oc = o - center
    b = _dot(oc, d)
    c = _dot(oc, oc) - radius * radius
    disc = b * b - c
    return torch.where(disc < 0.0, -1.0, -b - _safe_sqrt(disc))


@torch.no_grad()
def closest_hit(sc: Scene, o, d, alive=None):
    """-> (t_sphere, sphere id, t_triangle, triangle id); the no-hit
    distance on a miss and on every lane not ``alive`` (whose results the
    transport never reads).  Spheres: the earliest index wins a tie;
    triangles: the lowest id."""
    R = d.shape[0]
    dev = d.device
    kinf = _kinf(d.dtype)
    t_s = torch.full((R,), kinf, dtype=d.dtype, device=dev)
    s_idx = torch.zeros(R, dtype=torch.int64, device=dev)
    best_t = torch.full((R,), kinf, dtype=d.dtype, device=dev)
    best_i = torch.zeros(R, dtype=torch.int64, device=dev)
    lanes = torch.arange(R, device=dev) if alive is None \
        else torch.nonzero(alive).squeeze(1)
    if lanes.numel() == 0:
        return t_s, s_idx, best_t, best_i
    o, d = o[lanes], d[lanes]
    S = sc.sph_radius.shape[0]
    if S:
        near = _ray_sphere_near(o[:, None, :], d[:, None, :],
                                sc.sph_center[None], sc.sph_radius[None])
        t_sph = torch.where(near > 0.0, near, kinf)
        ts = torch.amin(t_sph, -1)
        si = torch.amin(torch.where(t_sph == ts[:, None],
                                    torch.arange(S, device=dev), S), -1)
        t_s[lanes], s_idx[lanes] = ts, si.clamp_max(S - 1)
    lt = torch.full((len(lanes),), kinf, dtype=d.dtype, device=dev)
    li = torch.zeros(len(lanes), dtype=torch.int64, device=dev)
    tiny = torch.finfo(d.dtype).tiny
    d_safe = torch.where(d.abs() < tiny, torch.copysign(
        torch.full_like(d, tiny), d), d)
    inv = 1.0 / d_safe.float()
    of = o.float()
    for ids, bmin, bmax in sc.groups:
        t0 = (bmin - of) * inv
        t1 = (bmax - of) * inv
        enter = torch.amax(torch.minimum(t0, t1), -1)
        leave = torch.amin(torch.maximum(t0, t1), -1)
        rows = torch.nonzero((leave >= torch.clamp_min(enter, 0.0))
                             & (enter <= lt.float())).squeeze(1)
        if rows.numel() == 0:
            continue
        t = _moller_trumbore(o[rows], d[rows], sc.a[ids], sc.b[ids],
                             sc.c[ids])
        t_min = torch.amin(t, -1)
        local = torch.amin(torch.where(t == t_min[:, None],
                                       torch.arange(len(ids), device=dev),
                                       len(ids)), -1)
        cand = ids[local.clamp_max(len(ids) - 1)]
        bt, bi = lt[rows], li[rows]
        better = (t_min < bt) | ((t_min == bt) & (t_min < kinf) & (cand < bi))
        lt[rows] = torch.where(better, t_min, bt)
        li[rows] = torch.where(better, cand, bi)
    best_t[lanes], best_i[lanes] = lt, li
    return t_s, s_idx, best_t, best_i


def _resolve(sc: Scene, o, d, hits):
    """Re-shade the winners from (o, d) -> (t, p, normal, hit, material)."""
    t_s, s_idx, t_tri, t_idx = hits
    kinf = _kinf(d.dtype)
    tri_hit = t_tri < kinf
    use_tri = tri_hit & (t_tri < t_s)
    hit = torch.minimum(t_tri, t_s) < kinf
    unit = torch.eye(3, dtype=d.dtype, device=d.device)
    safe = tri_hit[:, None]
    a = torch.where(safe, sc.a[t_idx], 0.0)
    b = torch.where(safe, sc.b[t_idx], unit[0])
    c = torch.where(safe, sc.c[t_idx], unit[1])
    e1, e2 = b - a, c - a
    oa = o - a
    det = _dot(e1, _cross(d, e2))
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    t_tri_w = _dot(e2, _cross(oa, e1)) * inv_det
    if sc.sph_radius.shape[0]:
        center, radius = sc.sph_center[s_idx], sc.sph_radius[s_idx]
        sph_mat = sc.sph_material[s_idx]
    else:
        center = torch.zeros_like(d)
        radius = torch.zeros_like(d[:, 0])
        sph_mat = torch.zeros_like(t_idx)
    t_sph_w = _ray_sphere_near(o, d, center, radius)
    t_safe = torch.where(hit, torch.where(use_tri, t_tri_w, t_sph_w), 1.0)
    p = o + t_safe[:, None] * d
    n_sph = (p - center) / torch.where(radius > 0.0, radius, 1.0)[:, None]
    n_tri = _normalize(_cross(e1, e2), 1e-20)
    normal = torch.where(use_tri[:, None], n_tri, n_sph)
    material = torch.where(use_tri, sc.tri_material[t_idx], sph_mat)
    front = _dot(d.detach(), normal.detach()) < 0.0
    normal = torch.where(front[:, None], normal, -normal)
    normal = torch.where(hit[:, None], normal,
                         torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype,
                                      device=d.device))
    return t_safe, p, normal, hit, material


# --- transport

def _sky(d, sky: str):
    if sky == "black":
        return torch.zeros_like(d)
    a = 0.5 * (d[..., 1:2] + 1.0)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return blue * (1.0 - a) + a


def _gather(table, onehot):
    """Rows of a small table by a one-hot matrix (exact forward; the
    backward is onehot^T @ grad)."""
    return onehot @ table.reshape(table.shape[0], -1)


def trace(sc: Scene, params: dict, o, d, seed, cfg: dict):
    """max_bounces + 1 segments over a ray batch -> (radiance (R, 3),
    the lanes' streams after the last draw)."""
    dtype = sc.dtype
    alive = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    total = torch.zeros_like(d)
    trans = torch.ones_like(d)
    mtype = sc.materials["mtype"]
    M = mtype.shape[0]
    for _ in range(cfg["max_bounces"] + 1):
        hits = closest_hit(sc, o.detach(), d.detach(), alive)
        t, p, n, hit, mid = _resolve(sc, o, d, hits)
        miss = alive & ~hit
        total = total + torch.where(miss[:, None], _sky(d, cfg["sky"]) * trans,
                                    0.0)
        live = alive & hit
        onehot = (mid[:, None] == torch.arange(M, device=d.device)).to(dtype)
        albedo = _gather(params["albedo"], onehot)
        emission = _gather(params["emission"], onehot)
        strength = _gather(params["emission_strength"], onehot)[:, 0]
        rough = _gather(params["roughness"], onehot)
        kind = mtype[mid]
        total = total + torch.where(live[:, None],
                                    emission * strength[:, None] * trans, 0.0)
        rdir, seed = _random_direction(seed, live, dtype)
        # the draws of lanes that do not scatter (and of the other lobe) are
        # never used, and are kept out of the arithmetic: a lane that no
        # longer advances its stream draws one value six times, and where
        # that value is 1.0 its direction is 0/0; that NaN must not reach
        # the grads through a branch the lane does not take
        is_lam = (kind == LAMBERTIAN)[:, None]
        r_lam = torch.where(live[:, None] & is_lam, rdir, 0.0)
        r_metal = torch.where(live[:, None] & ~is_lam, rdir, 0.0)
        refl = d - 2.0 * _dot(d, n)[:, None] * n
        d_metal = _normalize(refl + rough * r_metal, 1e-20)
        d_lam = n + r_lam
        lam_len = torch.sqrt(torch.clamp_min(_dot(d_lam, d_lam),
                                             1e-12))[:, None]
        d_lam = torch.where(lam_len < 1e-6, n, d_lam / lam_len)
        o_new = p + n * BIAS
        new_d = torch.where(is_lam, d_lam, d_metal)
        trans = torch.where(live[:, None], trans * albedo, trans)
        o = torch.where(live[:, None], o_new, o)
        d = torch.where(live[:, None], new_d, d)
        alive = live
    return total, seed


def live_params(sc: Scene) -> dict:
    return {k: sc.materials[k] for k in TRAINABLE}


def render_rows(sc: Scene, params: dict, cfg: dict, frame: int, y0: int,
                rows: int):
    """Rows [y0, y0 + rows) of one frame -> (rows, W, 3)."""
    if cfg.get("use_nee") or cfg.get("use_rr") or cfg.get("pixel_jitter"):
        raise NotImplementedError("the reference has NEE, RR and jitter off")
    W, H = cfg["width"], cfg["height"]
    dev = sc.a.device
    pos, dirs = camera_rays(sc.camera, W, H, dev)
    dirs = dirs[y0:y0 + rows].reshape(-1, 3).to(sc.dtype)
    xs = torch.arange(W, device=dev)[None, :]
    ys = (y0 + torch.arange(rows, device=dev))[:, None]
    seed = pixel_seed((xs + ys * W).reshape(-1), frame)
    origin = pos.to(sc.dtype).expand(rows * W, 3)
    acc = torch.zeros_like(dirs)
    for _ in range(cfg["samples"]):
        light, seed = trace(sc, params, origin, dirs, seed, cfg)
        acc = acc + light
    return (acc / float(cfg["samples"])).view(rows, W, 3)


def loss_grad(sc: Scene, cfg: dict, frame: int, trainable=TRAINABLE,
              block_rows: int | None = None):
    """The bench loss, mean((img - 0)^2), and its grads with respect to
    ``trainable`` (live material rows), summed over blocks of rows so that
    a large frame fits."""
    W, H = cfg["width"], cfg["height"]
    block = block_rows or H
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in live_params(sc).items()}
    npix = float(H * W * 3)
    loss = torch.zeros((), dtype=torch.float64, device=sc.a.device)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    for y0 in range(0, H, block):
        rows = min(block, H - y0)
        img = render_rows(sc, params, cfg, frame, y0, rows)
        part = torch.sum(img * img) / npix
        g = torch.autograd.grad(part, [params[k] for k in trainable],
                                allow_unused=True)
        for k, gk in zip(trainable, g):
            if gk is not None:
                grads[k] += gk
        loss += part.detach().double()
    return loss, {k: grads[k] for k in trainable}


@torch.no_grad()
def render_frame(sc: Scene, cfg: dict, frame: int):
    return render_rows(sc, live_params(sc), cfg, frame, 0, cfg["height"])


def accumulate(old, new, frame_count: int):
    """Running mean of the shader (pathTracer.comp:314-318)."""
    if frame_count == 0:
        return new
    w = float(np.float32(1.0) / (np.float32(frame_count) + np.float32(1.0)))
    return old * float(np.float32(1.0) - np.float32(w)) + new * w


def with_material(sc: Scene, index: int, **fields) -> Scene:
    """``sc`` with one material row's fields replaced (an editor edit)."""
    mats = dict(sc.materials)
    for k, v in fields.items():
        col = mats[k].clone()
        col[index] = torch.as_tensor(np.asarray(v, np.float32),
                                     dtype=col.dtype, device=col.device)
        mats[k] = col
    return dataclasses.replace(sc, materials=mats)


def with_camera(sc: Scene, **fields) -> Scene:
    return dataclasses.replace(sc, camera={**sc.camera, **fields})


@contextlib.contextmanager
def exact_matmuls():
    """float32 matrix products in float32, not TF32, while the reference
    runs."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
