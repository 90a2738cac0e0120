"""Plain reference of the serving post-processing: bloom (the reference's
bloom.comp chain: quadratic-threshold prefilter, 13-tap box downsamples,
tent-9 upsamples, one bilinear tap at full resolution), the ACES fit, the
display gamma, clip and truncation to uint8.  Plain PyTorch; imports
nothing of the measured package.
"""

from __future__ import annotations

import numpy as np
import torch


def _f(x) -> float:
    """A Python float holding the float32 value of ``x``."""
    return float(np.float32(x))


def _pad_edge(img, top, bottom, left, right):
    """Clamp-to-edge padding of an (H, W, C) tensor."""
    h, w, _ = img.shape
    rows = torch.arange(-top, h + bottom, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=img.device).clamp(0, w - 1)
    return img.index_select(0, rows).index_select(1, cols)


def quadratic_threshold(color, threshold: float, knee: float):
    """Soft-knee brightness threshold (bloom.comp:68-79)."""
    curve_x = _f(threshold - knee)
    curve_y = _f(2.0 * knee)
    curve_z = _f(0.25 / max(knee, 1e-5))
    brightness = torch.amax(color, dim=-1, keepdim=True)
    rq = torch.clamp(brightness - curve_x, 0.0, curve_y)
    rq = rq * rq * curve_z
    scale = torch.maximum(rq, brightness - _f(threshold)) / torch.clamp_min(
        brightness, _f(1e-4))
    return color * scale


def prefilter(color, threshold: float = 1.0, knee: float = 0.1):
    """Clamp + quadratic threshold (bloom.comp:81-86; clampValue = 20)."""
    return quadratic_threshold(torch.clamp_max(color, 20.0), threshold, knee)


def downsample_box13(img):
    """13-tap box downsample by 2x (bloom.comp:26-66), as a 4x4/stride-2
    texel stencil.  Odd inputs are edge-padded to even first."""
    h, w, _ = img.shape
    if h % 2 or w % 2:
        img = _pad_edge(img, 0, h % 2, 0, w % 2)
        h, w = img.shape[0], img.shape[1]
    # padded so offsets -1..+2 around each 2x2 block origin are in range
    p = _pad_edge(img, 1, 2, 1, 2)

    def s(dy, dx):  # texel at block origin + (dy, dx), strided over blocks
        return p[1 + dy:1 + dy + h:2, 1 + dx:1 + dx + w:2]

    def corner(dy, dx):  # bilinear sample at a texel corner = 2x2 average
        return (s(dy - 1, dx - 1) + s(dy - 1, dx) +
                s(dy, dx - 1) + s(dy, dx)) * 0.25

    # center taps at +-0.5 land exactly on texel centers (direct reads)
    inner = s(0, 0) + s(0, 1) + s(1, 0) + s(1, 1)
    out = (0.5 * (corner(1, 1) + inner)          # A + (B,C,D,E)
           + 0.25 * corner(0, 0)                 # F + L (duplicated tap)
           + 0.25 * corner(1, 0)                 # G (x2)
           + 0.125 * corner(2, 1)                # H
           + 0.375 * corner(2, 2)                # I + J (duplicated tap)
           + 0.25 * corner(1, 2)                 # K (x2)
           + 0.25 * corner(0, 1))                # M (x2)
    return out * 0.25


def _tent3_ext(img):
    """3x3 tent convolution [1,2,1]x[1,2,1]/16 of the clamp-extension of
    ``img`` on the extended grid rows/cols -1..h (one texel beyond each
    edge), so bilinear taps that land outside the image read the true
    convolved extension."""
    h, w, _ = img.shape
    p = _pad_edge(img, 2, 2, 2, 2)
    H, W = h + 2, w + 2

    def s(dy, dx):  # conv tap over the extended output grid
        return p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    row = s(-1, -1) + 2.0 * s(-1, 0) + s(-1, 1)
    mid = s(0, -1) + 2.0 * s(0, 0) + s(0, 1)
    bot = s(1, -1) + 2.0 * s(1, 0) + s(1, 1)
    return (row + 2.0 * mid + bot) * (1.0 / 16.0)


def _axis_up2(a, n_src, axis):
    """One axis of exact 2x bilinear upsampling.  ``a`` carries one extra
    sample on each side along ``axis``: output pixel centers land at source
    coordinates k +- 0.25, fixed (0.75, 0.25) tap weights (bloom.comp:
    118-140)."""
    lo, mid, hi = (a.narrow(axis, start, n_src) for start in (0, 1, 2))
    even = 0.25 * lo + 0.75 * mid   # out 2k   -> src k - 0.25
    odd = 0.75 * mid + 0.25 * hi    # out 2k+1 -> src k + 0.25
    out = torch.stack([even, odd], dim=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample2x_from_ext(ext, h: int, w: int, out_h: int, out_w: int):
    """2x bilinear upsample given the (h+2, w+2) extended source: row pass
    first, then the column extension rebuilt by row-upsampling ext's edge
    columns (row upsampling is per-column linear, so this is exact)."""
    up = _axis_up2(ext[:, 1:1 + w], h, 0)
    left = _axis_up2(ext[:, 0:1], h, 0)
    right = _axis_up2(ext[:, -1:], h, 0)
    up = _axis_up2(torch.cat([left, up, right], dim=1), w, 1)
    return up[:out_h, :out_w]


def _upsample2x_bilinear(img, out_h: int, out_w: int):
    """Exact 2x bilinear upsample with clamp-to-edge (composite.comp:46's
    single ``texture(bloomTexture, uv)`` tap at full res)."""
    h, w, _ = img.shape
    return _upsample2x_from_ext(_pad_edge(img, 1, 1, 1, 1), h, w,
                                out_h, out_w)


def upsample_tent9(img, out_h: int, out_w: int):
    """UpsampleTent9 (bloom.comp:91-109): tent-filtered 2x bilinear upsample
    to (out_h, out_w) (which may be the pre-pad odd size)."""
    h, w, _ = img.shape
    return _upsample2x_from_ext(_tent3_ext(img), h, w, out_h, out_w)


def bloom_pyramid(image, threshold: float = 1.0, knee: float = 0.1,
                  max_mips: int = 8):
    """Full bloom chain; returns the half-resolution bloom texture:
    chain[0] = Prefilter(Down13(screen)); chain[k] = Down13(chain[k-1])
    while min dim > 4; then upward u[k] = chain[k] + UpsampleTent9(u[k+1])
    (bloom.comp:112-146)."""
    chain = [prefilter(downsample_box13(image), threshold, knee)]
    while len(chain) < max_mips and min(chain[-1].shape[:2]) > 4:
        chain.append(downsample_box13(chain[-1]))
    up = chain[-1]
    for k in range(len(chain) - 2, -1, -1):
        h, w, _ = chain[k].shape
        up = chain[k] + upsample_tent9(up, h, w)
    return up


def bloom(image, threshold: float = 1.0, knee: float = 0.1,
          max_mips: int = 8):
    """Full-resolution bloom: half-res pyramid + the single bilinear
    ``texture(bloomTexture, uv)`` tap of composite.comp:46."""
    h, w, _ = image.shape
    half = bloom_pyramid(image, threshold, knee, max_mips)
    return _upsample2x_bilinear(half, h, w)


def aces(x):
    """Narkowicz ACES fit."""
    a, b, c, d, e = map(_f, (2.51, 0.03, 2.43, 0.59, 0.14))
    return (x * (a * x + b)) / (x * (c * x + d) + e)


TONEMAPS = {"none": lambda x: x, "aces": aces}


def finalize(img, tonemap: str, gamma: float, bloom_on: bool = False,
             threshold: float = 1.0, knee: float = 0.1,
             strength: float = 1.0):
    """HDR (H, W, 3) -> uint8 (H, W, 3): bloom, tonemap, gamma, clip,
    truncate."""
    if bloom_on:
        img = img + strength * bloom(img, threshold, knee)
    img = TONEMAPS[tonemap](img)
    if gamma != 1.0:
        img = torch.pow(torch.clamp_min(img, 0.0), 1.0 / gamma)
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
