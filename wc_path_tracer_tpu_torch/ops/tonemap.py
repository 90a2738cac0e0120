"""Tonemap operator library (port of the JAX package's ops/tonemap.py).

The reference ships these as include/TonemapFunctions.glsl, compiled in but
never dispatched (quirk §2.4(9): the display shows raw linear HDR).  Here
they are post ops selectable by ``RenderConfig.tonemap``.

Every function is elementwise over the trailing RGB axis, differentiable
under autograd, and transcribed from src/shaders/include/
TonemapFunctions.glsl.  Constants are float32 values (``_f``), as the JAX
package's ``np.float32`` scalars are.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32


def _f(x) -> float:
    """A Python float holding the float32 value of ``x``."""
    return float(F32(x))


def none(x):
    return x


def aces(x):
    """Narkowicz ACES fit (TonemapFunctions.glsl:5-14)."""
    a, b, c, d, e = map(_f, (2.51, 0.03, 2.43, 0.59, 0.14))
    return (x * (a * x + b)) / (x * (c * x + d) + e)


def pbr_neutral(color):
    """Khronos PBR-neutral (TonemapFunctions.glsl:16-36), over the trailing
    RGB axis."""
    start_compression = F32(0.8 - 0.04)
    desaturation = F32(0.15)
    x = torch.amin(color, dim=-1, keepdim=True)
    offset = torch.where(x < _f(0.08), x - _f(6.25) * x * x,
                         torch.full_like(x, _f(0.04)))
    color = color - offset
    peak = torch.amax(color, dim=-1, keepdim=True)
    d = F32(1.0) - start_compression
    new_peak = 1.0 - float(d * d) / (peak + float(d)
                                     - float(start_compression))
    scaled = color * new_peak / peak
    g = 1.0 - 1.0 / (float(desaturation) * (peak - new_peak) + 1.0)
    out = scaled * (1.0 - g) + new_peak * g
    return torch.where(peak < float(start_compression), color, out)


def unreal(x):
    return x / (x + _f(0.155)) * _f(1.019)


def filmic(x):
    X = torch.clamp_min(x - _f(0.004), 0.0)
    r = (X * (_f(6.2) * X + 0.5)) / (X * (_f(6.2) * X + _f(1.7)) + _f(0.06))
    return torch.pow(r, _f(2.2))


# Lottes 2016 curve constants, computed in float32 as the JAX package does
_L_A, _L_D, _L_HDR, _L_MID_IN, _L_MID_OUT = map(
    F32, (1.6, 0.977, 8.0, 0.18, 0.267))
_L_B = (-(_L_MID_IN ** _L_A) + (_L_HDR ** _L_A) * _L_MID_OUT) / (
    ((_L_HDR ** (_L_A * _L_D)) - (_L_MID_IN ** (_L_A * _L_D))) * _L_MID_OUT)
_L_C = ((_L_HDR ** (_L_A * _L_D)) * (_L_MID_IN ** _L_A)
        - (_L_HDR ** _L_A) * (_L_MID_IN ** (_L_A * _L_D)) * _L_MID_OUT) / (
    ((_L_HDR ** (_L_A * _L_D)) - (_L_MID_IN ** (_L_A * _L_D))) * _L_MID_OUT)


def lottes(x):
    xs = torch.clamp_min(x, 0.0)
    return torch.pow(xs, float(_L_A)) / (
        torch.pow(xs, float(_L_A * _L_D)) * float(_L_B) + float(_L_C))


def reinhard(x):
    return x / (1.0 + x)


def reinhard2(x):
    l_white = F32(4.0)
    return (x * (1.0 + x / float(l_white * l_white))) / (1.0 + x)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def uchimura(x, P=1.0, a=1.0, m=0.22, l=0.4, c=1.33, b=0.0):
    """Uchimura 2017 (TonemapFunctions.glsl:77-110)."""
    P, a, m, l, c, b = map(F32, (P, a, m, l, c, b))
    l0 = ((P - m) * l) / a
    S0 = m + l0
    S1 = m + a * l0
    C2 = (a * P) / (P - S1)
    CP = -C2 / P
    w0 = 1.0 - _smoothstep(0.0, float(m), x)
    w2 = (x >= float(m + l0)).to(x.dtype)
    w1 = 1.0 - w0 - w2
    T = float(m) * torch.pow(torch.clamp_min(x, 0.0) / float(m), float(c)) \
        + float(b)
    S = float(P) - float(P - S1) * torch.exp(float(CP) * (x - float(S0)))
    L = float(m) + float(a) * (x - float(m))
    return T * w0 + L * w1 + S * w2


_U2 = tuple(map(F32, (0.15, 0.50, 0.10, 0.20, 0.02, 0.30)))   # A-F


def _uncharted2_curve(x):
    A, B, C, D, E, F = _U2
    return ((x * (float(A) * x + float(C * B)) + float(D * E))
            / (x * (float(A) * x + float(B)) + float(D * F))) - float(E / F)


def uncharted2(color):
    A, B, C, D, E, F = _U2
    W = F32(11.2)
    white = ((W * (A * W + C * B) + D * E) / (W * (A * W + B) + D * F)) \
        - E / F
    return _uncharted2_curve(2.0 * color) * float(F32(1.0) / white)


def srgb_oecf(linear):
    """Fast sRGB OECF: pow(x, 1/2.2)."""
    return torch.pow(torch.clamp_min(linear, 0.0), _f(1.0 / 2.2))


def srgb_from_linear(x):
    """Exact sRGB transfer (TonemapFunctions.glsl:137)."""
    x = torch.clamp_min(x, 0.0)
    return torch.where(x <= _f(0.0031308), x * _f(12.92),
                       torch.pow(x, _f(1.0 / 2.4)) * _f(1.055) - _f(0.055))


def srgb_to_linear(x):
    return torch.where(x <= _f(0.04045), x / _f(12.92),
                       torch.pow((x + _f(0.055)) / _f(1.055), _f(2.4)))


def luminance(rgb):
    """Rec.709 luma (Math.glsl:7)."""
    w = torch.tensor(np.array([0.2126, 0.7152, 0.0722], F32),
                     device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


TONEMAPS = {
    "none": none,
    "aces": aces,
    "pbr_neutral": pbr_neutral,
    "unreal": unreal,
    "filmic": filmic,
    "lottes": lottes,
    "reinhard": reinhard,
    "reinhard2": reinhard2,
    "uchimura": uchimura,
    "uncharted2": uncharted2,
    "srgb": srgb_from_linear,
}


def apply(img, name: str):
    try:
        fn = TONEMAPS[name]
    except KeyError:
        raise ValueError(
            f"unknown tonemap {name!r}; options: {sorted(TONEMAPS)}") from None
    return fn(img)
