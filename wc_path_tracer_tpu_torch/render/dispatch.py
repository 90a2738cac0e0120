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
# The JAX package's packet kernel's draw limit (its tables had to fit the
# TPU's scalar memory).  The port's BVH walk has none; the limit is kept so
# that the bench's "pallas" cells split the bunny into the same draws.
PALLAS_MAX_TRIS = 8192


# renderer name -> (scene, cfg) -> closest-hit backend for golden's transport
_BACKENDS = {
    "golden": lambda scene, cfg: golden.intersect_scene_brute,
    "sweep": sweep.make_intersect_fn,
    "wavefront": lambda scene, cfg: wavefront.intersect_scene_bvh,
    "pallas": lambda scene, cfg: wavefront.intersect_scene_pallas,
}


def _backend(name: str, scene) -> str:
    if name == "auto":
        name = _auto(scene)
    if name not in _BACKENDS:
        raise ValueError(f"unknown renderer {name!r}")
    return name


def get_intersect_fn(name: str, scene, cfg):
    """The closest-hit backend of renderer ``name`` for golden's transport
    (``golden.render_rows(..., intersect_fn=...)``), built for this scene:
    the sweep's tables and attached vertex slabs come from ``scene`` as
    given, so parameters applied to it reach the re-shade."""
    return _BACKENDS[_backend(name, scene)](scene, cfg)


def get_render_frame(name: str, scene, cfg):
    """(scene, mats, cfg, frame_count) -> one frame through renderer
    ``name`` ("auto" picks by ``scene``); the backend is built per call
    from the scene the call gets.  The returned function's ``backend`` is
    the picked name."""
    backend = _backend(name, scene)

    def render_frame(scene, mats, cfg, frame_count):
        return golden.render_frame(scene, mats, cfg, frame_count,
                                   _BACKENDS[backend](scene, cfg))

    render_frame.backend = backend
    return render_frame


def _auto(scene) -> str:
    """"auto"'s choice: brute force up to BRUTE_FORCE_MAX_TRIS triangle
    slots, the cluster sweep above."""
    n_tris = scene.mesh.indices.shape[0] // 3
    return "sweep" if n_tris > BRUTE_FORCE_MAX_TRIS else "golden"
