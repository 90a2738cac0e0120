"""Kernels launched on the device per served frame: the CUDA kernel
events of the traced stretch over its frames (copies and fills left out)."""


def read(view):
    s = view.stretch
    if not s.kernels or not s.units:
        return None
    return len(s.kernels) / s.units
