"""Device milliseconds per served frame of the brute-force closest-hit
search H1 (the kernels whose name contains ``brute_hit``), over the traced
stretch: the boxes' closest-hit queries, whose re-shade follows in
PyTorch."""

KERNEL = "brute_hit"


def read(view):
    s = view.stretch
    ns = sum(d for name, _, d in s.kernels if KERNEL in name)
    if ns <= 0 or not s.units:
        return None
    return ns / 1e6 / s.units
