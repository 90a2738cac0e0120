"""P1: a served frame's post-processing in a few launches
(csrc/post_frame.cu).

``render/renderer.py::_finalize`` (bloom, tonemap, display gamma, uint8) is
about 850 small PyTorch launches a 1024^2 frame; on the card the host
cannot enqueue them as fast as they run.  Where the image lies on the card,
``Renderer.output`` hands it to ``post_frame_kernel`` instead: one launch
per bloom level down, one per level up and one composite, whose uint8
image is bit for bit ``_finalize``'s (its plain twin, and the CPU's path).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from wc_path_tracer_tpu_torch.kernels import launches
from wc_path_tracer_tpu_torch.ops import tonemap as tm
from wc_path_tracer_tpu_torch.utils import profiling

F32 = np.float32
N_CONSTS = 16            # post_frame.cu's kConsts
TM_AT = 6                # where the tonemap's constants start (kTm)
MAX_MIPS = 8             # ops/bloom.py::bloom's default
# the kernel's stages (post_frame.cu: kDown, kDownPrefilter, kUp,
# kComposite)
DOWN, DOWN_PREFILTER, UP, COMPOSITE = range(4)
# the kernel's tonemap ids: ops/tonemap.TONEMAPS, in its order
TONEMAP_IDS = {name: i for i, name in enumerate(tm.TONEMAPS)}
# how the display gamma's pow runs (post_frame.cu's PowMode)
POW_MODES = ("no_gamma", "fill1", "copy", "sqrt", "rsqrt", "recip", "square",
             "cube", "inv_square", "powf")


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a CUDA card, where the kernel runs."""
    return t.device.type == "cuda"


def pyramid(h: int, w: int, max_mips: int = MAX_MIPS) -> list:
    """The (h, w) of each level of ``ops/bloom.py::bloom_pyramid``'s chain
    for an (h, w) image: half size rounded up, while fewer than
    ``max_mips`` levels and the last one's least side is above 4."""
    sizes = [((h + 1) // 2, (w + 1) // 2)]
    while len(sizes) < max_mips and min(sizes[-1]) > 4:
        y, x = sizes[-1]
        sizes.append(((y + 1) // 2, (x + 1) // 2))
    return sizes


def _f(x) -> float:
    return float(F32(x))


def _tonemap_constants(name: str) -> list:
    """The float32 scalars the tonemap ``name`` of ``ops/tonemap.py``
    computes with, in the order post_frame.cu reads them; derived ones as
    that module derives them (numpy float32), and each division of a
    tensor by a Python scalar as PyTorch's CUDA kernel does it, a product
    with the float32 reciprocal."""
    if name == "aces":
        return [_f(v) for v in (2.51, 0.03, 2.43, 0.59, 0.14)]
    if name == "pbr_neutral":
        start, desaturation = F32(0.8 - 0.04), F32(0.15)
        d = F32(1.0) - start
        return [float(start), float(desaturation), float(d * d), float(d),
                _f(0.08), _f(6.25), _f(0.04)]
    if name == "unreal":
        return [_f(0.155), _f(1.019)]
    if name == "filmic":
        return [_f(v) for v in (0.004, 6.2, 1.7, 0.06, 2.2)]
    if name == "lottes":
        return [float(v) for v in (tm._L_A, tm._L_A * tm._L_D, tm._L_B,
                                   tm._L_C)]
    if name == "reinhard2":
        l_white = F32(4.0)
        return [float(F32(1.0) / F32(float(l_white * l_white)))]
    if name == "uchimura":
        P, a, m, l, c, b = map(F32, (1.0, 1.0, 0.22, 0.4, 1.33, 0.0))
        l0 = ((P - m) * l) / a
        S0 = m + l0
        S1 = m + a * l0
        C2 = (a * P) / (P - S1)
        CP = -C2 / P
        return [float(v) for v in (m, F32(1.0) / m, c, b, S0, P - S1, CP, P,
                                   a, m + l0)]
    if name == "uncharted2":
        A, B, C, D, E, F = tm._U2
        W = F32(11.2)
        white = ((W * (A * W + C * B) + D * E) / (W * (A * W + B) + D * F)) \
            - E / F
        return [float(v) for v in (A, C * B, D * E, B, D * F, E / F,
                                   F32(1.0) / white)]
    if name == "srgb":
        return [_f(v) for v in (0.0031308, 12.92, 1.0 / 2.4, 1.055, 0.055)]
    return []                       # none, reinhard


def pow_mode(gamma: float) -> tuple:
    """(mode, float32 exponent) of ``_finalize``'s display gamma: no_gamma
    for gamma 1 (no clamp, no pow), else ``torch.pow(x, 1 / gamma)``'s dispatch
    on its exponent (post_frame.cu's PowMode)."""
    if gamma == 1.0:
        return POW_MODES.index("no_gamma"), 1.0
    e = 1.0 / gamma
    f = float(F32(e))
    for mode, value in (("fill1", 0.0), ("copy", 1.0), ("sqrt", 0.5),
                        ("rsqrt", -0.5), ("recip", -1.0)):
        if e == value:
            return POW_MODES.index(mode), f
    for mode, value in (("square", 2.0), ("cube", 3.0), ("inv_square", -2.0)):
        if f == value:
            return POW_MODES.index(mode), f
    return POW_MODES.index("powf"), f


@functools.lru_cache(maxsize=64)
def constants(tonemap: str, gamma: float, threshold: float, knee: float,
              strength: float) -> tuple:
    """-> (the kernel's N_CONSTS float32 scalars as a ctypes array, the
    tonemap id, the gamma mode).  Raises ValueError for a tonemap that
    ``ops/tonemap.apply`` does not know, with its message."""
    if tonemap not in TONEMAP_IDS:
        raise ValueError(f"unknown tonemap {tonemap!r}; options: "
                         f"{sorted(tm.TONEMAPS)}")
    mode, exponent = pow_mode(gamma)
    v = [_f(strength), _f(threshold - knee), _f(2.0 * knee),
         _f(0.25 / max(knee, 1e-5)), _f(threshold), exponent]
    v += _tonemap_constants(tonemap)
    arr = (ctypes.c_float * N_CONSTS)(*v)
    return arr, TONEMAP_IDS[tonemap], mode


def _pyramid(img, consts: int, ins):
    """Launch the bloom pyramid of ``img`` down, then up -> u[0], the
    half-size bloom texture (a view of the levels' one scratch tensor)."""
    dev = img.device
    sizes = pyramid(img.shape[0], img.shape[1])
    offsets = np.cumsum([0] + [3 * y * x for y, x in sizes]).tolist()
    scratch = torch.empty(offsets[-1], dtype=torch.float32, device=dev)
    level = [scratch.data_ptr() + 4 * o for o in offsets[:-1]]
    launches.launch("P1", dev, ins, [img, level[0], None, consts,
                                     DOWN_PREFILTER, *img.shape[:2],
                                     *sizes[0], 0, 0])
    for k in range(1, len(sizes)):
        launches.launch("P1", dev, (), [level[k - 1], level[k], None, consts,
                                        DOWN, *sizes[k - 1], *sizes[k], 0,
                                        0])
    for k in range(len(sizes) - 2, -1, -1):
        launches.launch("P1", dev, (), [level[k + 1], level[k], None, consts,
                                        UP, *sizes[k + 1], *sizes[k], 0, 0])
    return scratch[:offsets[1]].view(*sizes[0], 3)


def post_frame_kernel(img, tonemap: str, gamma: float, bloom: bool,
                      threshold: float, knee: float, strength: float):
    """HDR (H, W, 3) float32 -> (H, W, 3) uint8 on the card, bit for bit
    ``_finalize(img, tonemap, gamma, bloom, threshold, knee, strength)``.

    With ``bloom``: one launch per level of the pyramid down (the first
    with the prefilter), one per level up, then the composite (bloom's
    full-size tap, the tonemap, the gamma, the cast); without, the
    composite alone.  The levels live in one scratch tensor.  CUDA tensors
    only: the CPU takes ``_finalize``.  Launches through
    ``launches.launch``: on the current stream without synchronising, each
    launch counted under P1; counts ``post.pixels`` (H * W)."""
    if not on_card(img):
        raise ValueError("post_frame_kernel: CUDA tensors only, got "
                         f"{img.device}")
    h, w = img.shape[0], img.shape[1]
    ins = (("img", img, torch.float32, (h, w, 3)),)
    arr, tm_id, mode = constants(tonemap, float(gamma), float(threshold),
                                 float(knee), float(strength))
    consts = ctypes.addressof(arr)
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=img.device)
    profiling.count("post.pixels", h * w)
    bloom_tex, hb, wb = None, 0, 0
    if bloom:
        bloom_tex = _pyramid(img, consts, ins)
        hb, wb = bloom_tex.shape[0], bloom_tex.shape[1]
        ins = ()
    launches.launch("P1", img.device, ins, [bloom_tex, img, out, consts,
                                            COMPOSITE, hb, wb, h, w, tm_id,
                                            mode])
    return out
