"""The launch counters of the port's CUDA kernels, in one map.

Each kernel wrapper adds one to its ``launches`` attribute where it
launches its kernel on CUDA tensors, and nowhere else (on CPU tensors its
plain twin runs, for T1 ``golden._bounce``, for H1
``golden._brute_search``, and nothing is counted).  ``KERNELS`` keys each
wrapper by its tag in the kernel tables (B1-B3; T1, the transport's
shading; H1, the brute-force closest-hit search); ``NAMES`` gives each tag
the kernel's name.
"""

from __future__ import annotations

from wc_path_tracer_tpu_torch.kernels import brute, cluster, shade, traversal

KERNELS = {"B1": cluster.cluster_sweep_kernel,
           "B2": cluster.cluster_sweep_mxu_kernel,
           "B3": traversal.bvh_walk_kernel,
           "T1": shade.shade_segment_kernel,
           "H1": brute.brute_hit_kernel}
NAMES = {"B1": "cluster_sweep", "B2": "cluster_sweep_mxu", "B3": "bvh_walk",
         "T1": "shade_segment", "H1": "brute_hit"}


def reset_counts():
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0


def read_counts() -> dict:
    """{tag: launches so far} of every kernel."""
    return {tag: k.launches for tag, k in KERNELS.items()}
