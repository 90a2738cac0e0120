"""The port's CUDA kernels: one registry, their launch counts and the one
path every wrapper launches through.

``KERNELS`` lists each kernel once under its tag in the kernel tables
(B1-B3, the closest-hit searches of the sweeps and the BVH walk; T1, the
transport's shading; H1, the brute-force closest-hit search; P1, the
serving post-processing; C1, the cluster sweep's cull and per-block
order): its library (``csrc/<library>.cu``, built by
``build.load``, and its name in the launch maps that bench.py, cli.py and
dp_check.py print), its C entry and that entry's ctypes arguments.  Every entry returns a CUDA error code (0 on
success) and every library exports ``wc_cuda_error_string``, which
``build.load`` binds.

A wrapper checks its inputs and launches through ``launch``, which counts
the launch under the kernel's tag.  On CPU tensors a wrapper runs its
plain twin (B1-B3) or refuses them (T1, H1: ``golden`` takes the twin; P1:
``Renderer.output`` takes ``_finalize``; C1: ``cluster_sweep`` takes
``cull_order_plain``), and nothing is counted.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from wc_path_tracer_tpu_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One CUDA kernel of the port, as the registry lists it."""

    tag: str
    library: str         # csrc/<library>.cu; its wrapper is <library>_kernel
    entry: str           # the C function that launches it
    argtypes: tuple      # the entry's ctypes arguments, the stream last


KERNELS = {k.tag: k for k in (
    # nact, clist, bt0, order, rays, prev, tris, out, visits, state, blocks,
    # ray_block, clusters, CTAs per ray block, threads per ray, passes per
    # visit, stream
    Kernel("B1", "cluster_sweep", "wc_cluster_sweep",
           (_P,) * 10 + (_I,) * 6 + (_P,)),
    # nact, clist, bt0, order, rays, prev, trisW, mat_tbl, out, visits,
    # state, counts, blocks, ray_block, clusters, CTAs per ray block,
    # threads per ray, passes per visit, stream
    Kernel("B2", "cluster_sweep_mxu", "wc_cluster_sweep_mxu",
           (_P,) * 12 + (_I,) * 6 + (_P,)),
    # origin, direction, t_init, node / triangle / draw records, alive
    # mask, lane counter, t_out, off_out, counts, rays, draws, stream
    Kernel("B3", "bvh_walk", "wc_bvh_walk", (_P,) * 11 + (_I,) * 2 + (_P,)),
    # o, d, total, trans, seed, alive, the hit record's t, p, normal, hit,
    # front, material, the material table and type ids, the six outputs
    # (o, d, total, trans, seed, alive), lanes, o's row stride, gradient
    # sky, Russian roulette, stream
    Kernel("T1", "shade_segment", "wc_shade_segment",
           (_P,) * 20 + (_I,) * 4 + (_P,)),
    # origin, direction, sphere positions, radii and live count, the
    # triangle slots' vertex rows a, b, c, their draws and the live draw
    # count, the four outputs (t_s, s_idx, t_tri, t_idx), lanes, origin's
    # row stride, sphere slots, triangle slots, near root only, stream
    Kernel("H1", "brute_hit", "wc_brute_hit",
           (_P,) * 14 + (_I,) * 5 + (_P,)),
    # one stage of the post chain: its input, its output (or in-out), the
    # uint8 image, the host array of float32 scalars, the stage, the input's
    # and the output's height and width, the tonemap id, the gamma's pow
    # mode, stream
    Kernel("P1", "post_frame", "wc_post_frame",
           (_P,) * 4 + (_I,) * 7 + (_P,)),
    # origin, direction, t_init, the cluster boxes' min and max corners, the
    # five outputs (nact, clist, sorted entry distances, rays, prev), the
    # sort keys' scratch or null, rays, origin's row stride, ray block,
    # clusters, stream
    Kernel("C1", "cluster_cull", "wc_cluster_cull",
           (_P,) * 11 + (_I,) * 4 + (_P,)),
)}

_counts = dict.fromkeys(KERNELS, 0)


def zeros(**counts) -> dict:
    """{tag: launches} of every kernel: 0, except the tags given (e.g.
    ``zeros(H1=5)``)."""
    unknown = set(counts) - set(KERNELS)
    if unknown:
        raise ValueError(f"no kernel tagged {sorted(unknown)}")
    return {tag: counts.get(tag, 0) for tag in KERNELS}


def named(counts: dict) -> dict:
    """A {tag: n} map keyed by the kernels' library names."""
    return {KERNELS[tag].library: n for tag, n in counts.items()}


def reset_counts():
    """Set every kernel's launch count to 0."""
    _counts.update(zeros())


def read_counts() -> dict:
    """{tag: launches so far} of every kernel."""
    return dict(_counts)


@functools.cache
def library(tag: str) -> ctypes.CDLL:
    """The loaded library of kernel ``tag``, built if needed."""
    k = KERNELS[tag]
    return build.load(k.library, signatures={k.entry: (list(k.argtypes),
                                                       _I)})


def launch(tag: str, device, ins, args, contiguous: bool = True):
    """Launch kernel ``tag`` on the current stream of ``device``, without
    synchronising, and count the launch.

    ``ins`` holds the wrapper's inputs as (name, tensor or None, dtype,
    shape) rows; each given tensor must have that dtype and shape, lie on
    ``device`` and, with ``contiguous``, be contiguous, or this raises
    ValueError naming the wrapper and the input.  ``args`` are the entry's
    arguments before the stream: a tensor passes its data pointer, None a
    null pointer.  A non-zero return code raises RuntimeError with the
    library's error string."""
    k = KERNELS[tag]
    who = f"{k.library}_kernel"
    for name, t, dtype, shape in ins:
        if t is None:
            continue
        shape = tuple(shape)
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
                or (contiguous and not t.is_contiguous()):
            raise ValueError(
                f"{who}: {name} must be a {'contiguous ' * contiguous}"
                f"{dtype} tensor of shape {shape} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
                + (f" contiguous={t.is_contiguous()}" if contiguous else ""))
    lib = library(tag)
    rc = getattr(lib, k.entry)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{k.library} kernel launch failed: "
                           + lib.wc_cuda_error_string(rc).decode())
    _counts[tag] += 1
