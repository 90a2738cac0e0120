"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W power limit), and the least time of a piece of work."""

H100_FP32_FLOPS = 67e12      # FP32 outside the tensor cores
H100_HBM_BYTES = 3.35e12     # HBM3 bandwidth, bytes/s


def bound(ops: float, nbytes: float):
    """(least seconds, what bounds it) of ``ops`` FP32 operations and
    ``nbytes`` bytes moved."""
    ops_s = ops / H100_FP32_FLOPS
    bytes_s = nbytes / H100_HBM_BYTES
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"
