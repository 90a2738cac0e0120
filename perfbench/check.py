"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference (perfbench/reference) on the same raw inputs.

Training (per sampled step):

- ``loss_rel``: |loss - reference loss| / |reference loss|;
- ``grad_rel``: over the trainable leaves, the largest norm of (grad -
  reference grad), over the larger of that leaf's reference norm and the
  median leaf's; a leaf's rows beyond the live materials count, against
  zero.

Serving (per sampled frame):

- ``hdr_px_share``: the share of pixels whose accumulated HDR value
  differs from the reference's in some channel by more than HDR_ATOL +
  HDR_RTOL * |reference| (a NaN agrees only with a NaN: the shader's
  unguarded log(0) makes one where both sides draw the same zero);
- ``u8_px_share``: the share of pixels whose displayed uint8 value differs
  in some channel by more than U8_TOL.

A run's number is the largest over its samples; each has the limit that
perfbench/limits/<cell>.json gives it.
"""

from __future__ import annotations

import math
import statistics

import torch

HDR_ATOL = 1e-4
HDR_RTOL = 1e-4
U8_TOL = 1


def train_numbers(loss, grads: dict, ref_loss, ref_grads: dict) -> dict:
    ref_loss = float(ref_loss)
    loss_rel = abs(float(loss) - ref_loss) / max(abs(ref_loss), 1e-30)
    norms, gaps = {}, {}
    for k, r in ref_grads.items():
        p = grads[k].detach().double().cpu()
        full = torch.zeros_like(p)
        full[:r.shape[0]] = r.detach().double().cpu()
        norms[k] = float(torch.linalg.vector_norm(full))
        gaps[k] = float(torch.linalg.vector_norm(p - full))
    median = statistics.median(norms.values())
    grad_rel = max(gaps[k] / max(norms[k], median, 1e-30) for k in gaps)
    return dict(loss_rel=_nan_high(loss_rel), grad_rel=_nan_high(grad_rel))


def serve_numbers(hdr, u8, ref_hdr, ref_u8) -> dict:
    hdr = hdr.detach().float().cpu()
    ref = ref_hdr.detach().float().cpu()
    near = (hdr - ref).abs() <= HDR_ATOL + HDR_RTOL * ref.abs()
    good = (hdr == ref) | near | (torch.isnan(hdr) & torch.isnan(ref))
    bad = ~good
    u8 = torch.as_tensor(u8).int()
    ru8 = torch.as_tensor(ref_u8).int().cpu()
    bad8 = (u8 - ru8).abs() > U8_TOL
    return dict(hdr_px_share=float(bad.any(-1).float().mean()),
                u8_px_share=float(bad8.any(-1).float().mean()))


def _nan_high(x: float) -> float:
    return math.inf if math.isnan(x) else x


def verdict(samples: list, limits: dict, failed: int):
    """(correct, {name: {"value": largest over the samples, "limit": l}})."""
    checks = {}
    for name, limit in limits.items():
        vals = [s[name] for s in samples]
        checks[name] = {"value": max(vals) if vals else math.inf,
                        "limit": limit}
    ok = bool(samples) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
