"""Render-path dispatch: choose the closest-hit backend per scene (port of the
JAX package's render/dispatch.py).

- ``golden``    — masked brute-force sweep over every primitive.
- ``sweep``     — block-sparse cluster sweep (kernels/cluster.py) through the
  hand-written CUDA kernel of ``cfg.cluster_kernel`` ("mt" or "mxu").
- ``wavefront`` — plain PyTorch per-lane BVH walk, ``cfg.traversal``
  "stack" or "stackless" (render/wavefront.py).
- ``pallas``    — the BVH stack walk through the hand-written CUDA kernel
  (kernels/csrc/bvh_walk.cu); the name is the JAX package's, whose kernel
  was written in Pallas.
- ``auto``      — brute force up to BRUTE_FORCE_MAX_TRIS triangle slots, the
  cluster sweep above.

The 256-slot crossover is the JAX package's, measured on a TPU; it is kept
until the port measures its own on the card (ROADMAP).
"""

from __future__ import annotations

from wc_path_tracer_tpu_torch.render import golden, sweep, wavefront

BRUTE_FORCE_MAX_TRIS = 256


def get_render_frame(name: str, scene, cfg):
    if name == "golden":
        return golden.render_frame
    if name == "sweep":
        return sweep.render_frame
    if name == "wavefront":
        return wavefront.render_frame
    if name == "pallas":
        return wavefront.render_frame_pallas
    if name != "auto":
        raise ValueError(f"unknown renderer {name!r}")
    n_tris = scene.mesh.indices.shape[0] // 3
    if n_tris > BRUTE_FORCE_MAX_TRIS:
        return sweep.render_frame
    return golden.render_frame
