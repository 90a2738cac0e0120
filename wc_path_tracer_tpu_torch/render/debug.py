"""Debug visualization: BVH AABB wireframe overlay (port of the JAX
package's render/debug.py).

The reference wires a line renderer for BVH-box visualization but the call
site is commented out (SURVEY §2.3: src/editor.jai:159-171,
src/Renderer2D.jai DrawLineCube).  Here the capability is live: project
BVH node boxes through the camera and rasterize their edges over a rendered
image, on the host in NumPy (a debug path, not a hot path).
"""

from __future__ import annotations

import numpy as np
import torch

from wc_path_tracer_tpu_torch.scene.camera import CameraMatrices

_BOX_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),   # bottom
    (4, 5), (5, 7), (7, 6), (6, 4),   # top
    (0, 4), (1, 5), (2, 6), (3, 7),   # verticals
]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _project(points, mats: CameraMatrices, width, height):
    """World -> pixel coordinates (+ in-front mask)."""
    view = np.linalg.inv(_host(mats.inverse_view))
    proj = np.linalg.inv(_host(mats.inverse_projection))
    p4 = np.concatenate([points, np.ones((len(points), 1), np.float32)], -1)
    cam = p4 @ view.T
    clip = cam @ proj.T
    w = clip[:, 3:4]
    in_front = w[:, 0] > 1e-6
    ndc = clip[:, :3] / np.where(np.abs(w) < 1e-6, 1e-6, w)
    x = (ndc[:, 0] * 0.5 + 0.5) * width
    y = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * height  # y flip (pathTracer.comp:296)
    return np.stack([x, y], -1), in_front


def _draw_line(img, x0, y0, x1, y1, color):
    h, w, _ = img.shape
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    ts = np.linspace(0.0, 1.0, n)
    xs = np.round(x0 + (x1 - x0) * ts).astype(int)
    ys = np.round(y0 + (y1 - y0) * ts).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def draw_aabb_overlay(image, mats: CameraMatrices, bvh_min, bvh_max,
                      node_ids=None, color=(1.0, 0.3, 0.1)):
    """Return a copy of ``image`` (H, W, 3 float; a tensor or an array) as
    a NumPy array with BVH box wireframes.  ``bvh_min``/``bvh_max``: the
    bank's (N, 3) node bounds; ``node_ids``: which nodes to draw (default:
    all with valid bounds)."""
    img = np.array(_host(image), np.float32, copy=True)
    h, w, _ = img.shape
    bvh_min = _host(bvh_min)
    bvh_max = _host(bvh_max)
    if node_ids is None:
        node_ids = np.where(bvh_min[:, 0] <= bvh_max[:, 0])[0]
    color = np.asarray(color, np.float32)

    for n in np.asarray(node_ids).reshape(-1):
        mn, mx = bvh_min[n], bvh_max[n]
        if not (mn[0] <= mx[0]):
            continue
        corners = np.array([[mn[0], mn[1], mn[2]],
                            [mx[0], mn[1], mn[2]],
                            [mn[0], mx[1], mn[2]],
                            [mx[0], mx[1], mn[2]],
                            [mn[0], mn[1], mx[2]],
                            [mx[0], mn[1], mx[2]],
                            [mn[0], mx[1], mx[2]],
                            [mx[0], mx[1], mx[2]]], np.float32)
        px, in_front = _project(corners, mats, w, h)
        for a, b in _BOX_EDGES:
            if in_front[a] and in_front[b]:
                _draw_line(img, px[a, 0], px[a, 1], px[b, 0], px[b, 1], color)
    return img
