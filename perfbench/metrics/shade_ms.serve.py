"""Device milliseconds per served frame of the fused shading kernel T1
(the kernels whose name contains ``shade_segment``), over the traced
stretch: where the transport's lobes and Russian roulette's kill run."""

KERNEL = "shade_segment"


def read(view):
    s = view.stretch
    ns = sum(d for name, _, d in s.kernels if KERNEL in name)
    if ns <= 0 or not s.units:
        return None
    return ns / 1e6 / s.units
