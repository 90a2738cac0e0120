"""Bit-exact PCG PRNG matching the reference shader's RNG
(src/shaders/include/Random.glsl); port of the JAX package's ops/rng.py.

The state is a uint32 per lane, carried here as int64 holding a value in
[0, 2^32): PyTorch has no CPU uint32 shift, add or compare.  Every product
stays below 2^62 and is masked back to 32 bits, so the streams are the
reference's bit for bit, including its two quirks:

1. ``rand`` overwrites the state with the *output* word of the PCG permute
   (Random.glsl:27-32), so the state update is ``state <- permute(state)``.
2. uint32 -> float is ``float(x) * 2^-32`` with round-to-nearest on the
   int -> float conversion, which can return exactly 0.0 and 1.0.

Masked variants advance a lane's state only where ``mask`` is True, which
reproduces the reference's per-thread control flow drawing different counts
per bounce (pathTracer.comp:256-275).
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PCG_MULT = 747796405        # Random.glsl:12-14
_PCG_INC = 2891336453
_PCG_XSH_MULT = 277803737
_INV_2_32 = 2.0 ** -32       # uintBitsToFloat(0x2f800000u), Random.glsl:31
_TWO_PI = float(np.float32(2.0) * np.float32(np.pi))   # f32 2*pi, as the JAX package


def _permute(state):
    """PCG output function (RXS-M-XS):
    word = ((state >> ((state >> 28) + 4)) ^ state) * 277803737;
    return (word >> 22) ^ word."""
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * _PCG_XSH_MULT) & MASK32
    return (word >> 22) ^ word


def pcg_hash(seed):
    """Initial seeding hash: permute(seed * MULT + INC)."""
    return _permute((seed.to(torch.int64) * _PCG_MULT + _PCG_INC) & MASK32)


def u32_to_float(x):
    """float(x) * 2^-32, round-to-nearest: a float32 in [0.0, 1.0]."""
    return x.to(torch.float32) * _INV_2_32


def rand_u32(state):
    """One draw of the reference's ``rand`` chain as the raw uint32 ->
    (value, new_state); ``rand`` stores its output back into the state
    (Random.glsl:30), so value == new_state."""
    x = _permute(state)
    return x, x


def rand(state):
    """Draw a float in [0, 1] and advance the state -> (value, new_state)."""
    x, state = rand_u32(state)
    return u32_to_float(x), state


def rand_masked(state, mask):
    """``rand`` that only advances lanes where ``mask`` is True; the value on
    other lanes is the would-be draw, which callers must not use."""
    x = _permute(state)
    return u32_to_float(x), torch.where(mask, x, state)


def random_normal(state, mask=None):
    """Box-Muller normal from 2 draws (Random.glsl:43-48); log(0) is not
    guarded, as in the reference."""
    if mask is None:
        u1, state = rand(state)
        u2, state = rand(state)
    else:
        u1, state = rand_masked(state, mask)
        u2, state = rand_masked(state, mask)
    theta = _TWO_PI * u1
    rho = torch.sqrt(-2.0 * torch.log(u2))
    return rho * torch.cos(theta), state


def random_direction(state, mask=None):
    """Uniform direction as a normalized 3D Gaussian, 6 draws
    (Random.glsl:50-56) -> (dir (..., 3), new_state)."""
    x, state = random_normal(state, mask)
    y, state = random_normal(state, mask)
    z, state = random_normal(state, mask)
    norm = torch.sqrt(x * x + y * y + z * z)
    return torch.stack([x / norm, y / norm, z / norm], dim=-1), state


def random_hemisphere_direction(normal, state, mask=None):
    """``random_direction`` flipped into the hemisphere of ``normal`` (...,
    3) by sign(normal . d), which is 0 on the plane (Random.glsl:58-62)."""
    d, state = random_direction(state, mask)
    s = torch.sign(torch.sum(normal * d, dim=-1, keepdim=True))
    return d * s, state


def pixel_seed(pixel_index, frame_count):
    """Per-pixel per-frame seed: pcg_hash(pixel + frame*719393) mod 2^32
    (pathTracer.comp:304-305).  ``frame_count`` is an int or an integer
    tensor that broadcasts against ``pixel_index`` (one frame count per
    lane); either is taken mod 2^32, as the JAX package's uint32."""
    if isinstance(frame_count, torch.Tensor):
        frame = (frame_count.to(torch.int64) & MASK32) * 719393
    else:
        frame = (int(frame_count) & MASK32) * 719393
    return pcg_hash((pixel_index.to(torch.int64) + frame) & MASK32)
