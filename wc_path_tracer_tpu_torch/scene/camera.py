"""Camera model: yaw/pitch fly camera with look-at view + perspective projection.

The port of ``wc_path_tracer_tpu/scene/camera.py`` (reference: Camera +
Update, src/PathTracingRenderer.jai:6-36; per-pixel ray reconstruction,
pathTracer.comp:292-302).  Matrices are row-major with column-vector
convention (m @ v).  All math is float32 and differentiable; the small
matrix-vector products are written out as sums of products, so no TF32
matmul path can ever touch them on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wc_path_tracer_tpu_torch.utils.device import resolve_device

F32 = torch.float32


@dataclasses.dataclass
class Camera:
    """Camera state; ``yaw``/``pitch``/``fov`` in degrees (0-d tensors)."""

    position: torch.Tensor  # (3,) f32
    yaw: torch.Tensor       # () f32
    pitch: torch.Tensor     # () f32
    fov: torch.Tensor       # () f32, vertical

    @staticmethod
    def create(position=(0.0, 0.0, 0.0), yaw=-90.0, pitch=0.0, fov=90.0,
               device=None) -> "Camera":
        dev = resolve_device(device)

        def t(x):
            return torch.as_tensor(np.array(x, np.float32), device=dev)

        return Camera(position=t(position), yaw=t(yaw), pitch=t(pitch),
                      fov=t(fov))

    def to(self, device) -> "Camera":
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})

    @property
    def direction(self) -> torch.Tensor:
        """yaw/pitch -> unit direction (PathTracingRenderer.jai:23-26)."""
        ry = torch.deg2rad(self.yaw)
        rp = torch.deg2rad(self.pitch)
        cp = torch.cos(rp)
        d = torch.stack([torch.cos(ry) * cp, torch.sin(rp), torch.sin(ry) * cp])
        return d / torch.linalg.vector_norm(d)


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def look_at(eye, center, up=(0.0, 1.0, 0.0)):
    """Right-handed look-at view matrix (world -> camera)."""
    f = center - eye
    f = f / torch.linalg.vector_norm(f)
    up = torch.tensor(up, dtype=F32, device=eye.device)
    s = _cross(f, up)
    s = s / torch.linalg.vector_norm(s)
    u = _cross(s, f)
    zero = torch.zeros((), dtype=F32, device=eye.device)
    return torch.stack([
        torch.cat([s, -torch.dot(s, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        torch.stack([zero, zero, zero, zero + 1.0]),
    ])


def perspective(fov_y_deg, aspect, near=0.1, far=100.0):
    """GL-style right-handed perspective projection (near/far as the
    reference, PathTracingRenderer.jai:32)."""
    g = 1.0 / torch.tan(torch.deg2rad(fov_y_deg) * 0.5)
    near, far = np.float32(near), np.float32(far)
    z = torch.zeros_like(g)
    return torch.stack([
        torch.stack([g / float(np.float32(aspect)), z, z, z]),
        torch.stack([z, g, z, z]),
        torch.stack([z, z, z + float((far + near) / (near - far)),
                     z + float(np.float32(2.0) * far * near / (near - far))]),
        torch.stack([z, z, z - 1.0, z]),
    ])


@dataclasses.dataclass
class CameraMatrices:
    """What the renderer consumes: inverses + position (SceneData,
    pathTracer.comp:10-19)."""

    inverse_projection: torch.Tensor  # (4, 4)
    inverse_view: torch.Tensor        # (4, 4)
    position: torch.Tensor            # (3,)


def camera_matrices(camera: Camera, aspect: float) -> CameraMatrices:
    """Build view/proj and invert them in float32, as the reference's Update
    does (PathTracingRenderer.jai:22-36)."""
    view = look_at(camera.position, camera.position + camera.direction)
    proj = perspective(camera.fov, aspect)
    return CameraMatrices(inverse_projection=torch.linalg.inv(proj),
                          inverse_view=torch.linalg.inv(view),
                          position=camera.position)


def matrices_from_numpy(inverse_projection, inverse_view, position,
                        device=None) -> CameraMatrices:
    """CameraMatrices from NumPy arrays, e.g. the JAX package's matrices."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    return CameraMatrices(t(inverse_projection), t(inverse_view), t(position))


def _mat4_vec(m, v):
    """(4, 4) @ (..., 4) -> (..., 4), each row a left-to-right sum."""
    return torch.stack([
        m[i, 0] * v[..., 0] + m[i, 1] * v[..., 1]
        + m[i, 2] * v[..., 2] + m[i, 3] * v[..., 3]
        for i in range(4)], dim=-1)


def _normalize_rows(v):
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v / torch.sqrt(n2)[..., None]


def primary_ray_directions(mats: CameraMatrices, width: int, height: int,
                           jitter=None):
    """Per-pixel world-space ray directions, (H, W, 3).

    Transcribes pathTracer.comp:289-302: pixel-center NDC with a y flip,
    target = invProj @ (x, y, 1, 1); dir = normalize(invView @
    (normalize(target.xyz / target.w), 0)).  ``jitter``: optional (H, W, 2)
    subpixel offsets in [0, 1).
    """
    dev = mats.inverse_projection.device
    x = (torch.arange(width, dtype=F32, device=dev) + 0.5) / float(width)
    y = (torch.arange(height, dtype=F32, device=dev) + 0.5) / float(height)
    cy, cx = torch.meshgrid(y, x, indexing="ij")   # (H, W)
    if jitter is not None:
        cx = cx + (jitter[..., 0] - 0.5) / float(width)
        cy = cy + (jitter[..., 1] - 0.5) / float(height)
    cy = 1.0 - cy                      # y flip (pathTracer.comp:296)
    cx = cx * 2.0 - 1.0                # -> [-1, 1]
    cy = cy * 2.0 - 1.0
    ones = torch.ones_like(cx)
    target = _mat4_vec(mats.inverse_projection,
                       torch.stack([cx, cy, ones, ones], dim=-1))
    d_cam = _normalize_rows(target[..., :3] / target[..., 3:4])
    d_cam4 = torch.cat([d_cam, torch.zeros_like(d_cam[..., :1])], dim=-1)
    return _normalize_rows(_mat4_vec(mats.inverse_view, d_cam4)[..., :3])
