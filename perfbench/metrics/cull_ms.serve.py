"""Device milliseconds per served frame of the cluster sweep's cull kernel
C1 (the kernels whose name contains ``cluster_cull``), over the traced
stretch: each sweep query's cull, per-block cluster order and packing,
ahead of the block sweep B1."""

KERNEL = "cluster_cull"


def read(view):
    s = view.stretch
    ns = sum(d for name, _, d in s.kernels if KERNEL in name)
    if ns <= 0 or not s.units:
        return None
    return ns / 1e6 / s.units
