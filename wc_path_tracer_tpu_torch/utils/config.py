"""Render configuration: the JAX package's ``RenderConfig``, field for field.

Same fields, defaults and validation as ``wc_path_tracer_tpu/utils/config.py``
so one config describes a render in either package.  ``row_chunks`` only
changed how the JAX package batched a frame (its pixels are identical
either way); the port always renders one band.  ``tonemap``, ``gamma`` and
``bloom*`` are read by post-processing (``Renderer.output``), not by the
transport.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render parameters.  Defaults reproduce the reference's semantics
    (src/PathTracingRenderer.jai:119-120, src/shaders/pathTracer.comp)."""

    width: int = 256
    height: int = 256
    samples: int = 1           # ref default (PathTracingRenderer.jai:119)
    max_bounces: int = 3       # ref default (:120); the bounce loop runs
    #                            max_bounces + 1 path segments
    #                            (pathTracer.comp:245 `i <= maxBounceCount`)

    # --- extensions beyond the reference (all off by default) ---
    pixel_jitter: bool = False   # subpixel jitter per sample (the ref never
    #                              jitters, pathTracer.comp:309-310)
    use_nee: bool = False        # next-event estimation
    mis: bool = True             # balance-heuristic MIS under NEE
    use_rr: bool = False         # Russian roulette termination
    rr_start_bounce: int = 3     # first bounce index eligible for RR
    sky: str = "gradient"        # "gradient" = ref's vertical mix
    #                              (pathTracer.comp:236-239); "black" = none
    tonemap: str = "none"
    gamma: float = 1.0
    bloom: bool = False
    bloom_threshold: float = 1.0
    bloom_knee: float = 0.1
    bloom_strength: float = 1.0
    edge_grads: bool = False     # silhouette gradients by the coverage
    #                              estimator (golden.trace_rays_edge): a
    #                              half-pixel widened primary query, hit and
    #                              background paths blended by the coverage,
    #                              soft sphere shadows; ~2x the forward work
    compact: bool = False        # alive-lane compaction of the later bounces
    #                              (golden.trace_rays_compact): the same image,
    #                              less work once lanes die (RR, sky misses)
    compact_blocks: int = 16     # lanes are taken in blocks of
    #                              num_rays / compact_blocks
    compact_from: int | None = None  # first compacted bounce; None tracks
    #                              the kill sources: rr_start_bounce + 1
    #                              with RR, else 1
    ray_sort: str = "dynamic"    # ray regrouping before the cluster sweep:
    #                              "dynamic" = per-query Morton sort
    #                              (aliveness, direction octant, origin cell);
    #                              "static" = fixed pixel-tile permutation;
    #                              "off".  All three give the same hits
    #                              except on exact cross-cluster t-ties.
    row_chunks: int = 0
    cluster_kernel: str = "mt"   # "mt" = Möller-Trumbore kernel; "mxu" =
    #                              plane-form variant
    ray_block: int = 0           # rays per cluster-sweep block (0 = 512)
    traversal: str = "stackless"  # BVH walk of the "wavefront" renderer:
    #                               "stackless" (escape links) or "stack"

    # --- compat quirks (True = reproduce reference behavior bit-for-bit) ---
    sphere_near_root_only: bool = True  # quirk 1: only the near root `.x` of
    #                                     raySphereIntersect (:141-142)

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("width/height must be positive")
        if self.samples <= 0:
            raise ValueError("samples must be positive")
        if self.max_bounces < 0:
            raise ValueError("max_bounces must be >= 0")
        if self.sky not in ("gradient", "black"):
            raise ValueError(f"unknown sky model: {self.sky!r}")
        if self.ray_sort not in ("static", "dynamic", "off"):
            raise ValueError(f"unknown ray_sort: {self.ray_sort!r}")
        if self.ray_block and (self.ray_block < 8
                               or self.ray_block & (self.ray_block - 1)):
            raise ValueError("ray_block must be 0 or a power of two >= 8")
        if self.cluster_kernel not in ("mt", "mxu"):
            raise ValueError(f"unknown cluster_kernel: {self.cluster_kernel!r}")
        if self.row_chunks < 0:
            raise ValueError("row_chunks must be >= 0")
        if self.row_chunks > 1 and self.height % self.row_chunks:
            raise ValueError(
                f"height {self.height} not divisible by row_chunks "
                f"{self.row_chunks}")
        if self.traversal not in ("stackless", "stack"):
            raise ValueError(f"unknown traversal: {self.traversal!r}")
        if self.compact_blocks <= 0:
            raise ValueError("compact_blocks must be positive")
        if self.edge_grads and self.pixel_jitter:
            raise ValueError(
                "edge_grads antialiases silhouettes analytically; combine "
                "with pixel_jitter is unsupported")

    @property
    def compact_from_resolved(self) -> int:
        if self.compact_from is not None:
            return self.compact_from
        return self.rr_start_bounce + 1 if self.use_rr else 1

    @property
    def num_rays(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
