"""T1: the transport's shading of one bounce segment in one launch
(csrc/shade_segment.cu).

``render/golden.py::_bounce`` shades a segment after its closest-hit query
with about 470 small PyTorch ops; on the card the host cannot launch them
as fast as they run.  Where grad mode is off and NEE is off,
``golden`` hands the segment's lanes and hit record to
``shade_segment_kernel`` instead: one launch that writes the next
``PathState``'s fields, bit for bit those of ``_bounce`` (its plain twin).
The material table is packed once per trace (``pack_materials``).
"""

from __future__ import annotations

import torch

from wc_path_tracer_tpu_torch.kernels import launches

# pack_materials' float columns: the material table of T1 and of
# golden._gather_material
COLUMNS = (("albedo", 3), ("emission", 3), ("emission_strength", 1),
           ("roughness", 1), ("metallic", 1), ("absorption", 3),
           ("absorption_strength", 1), ("ior", 1))


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a CUDA card, where the kernel runs."""
    return t.device.type == "cuda"


def pack_materials(materials):
    """-> ((M, 14) float32 table, (M,) int32 type ids): the columns of
    ``COLUMNS`` side by side."""
    return (torch.cat([getattr(materials, name).reshape(-1, width)
                       for name, width in COLUMNS], 1), materials.mtype)


def shade_segment_kernel(o, d, total, trans, seed, alive, rec, materials,
                         sky_gradient: bool, rr: bool):
    """Shade one segment's lanes -> (o, d, total, trans, seed, alive) of the
    next ``PathState`` (``pdf_prev`` is left as it is: NEE is off).

    ``o``, ``d``, ``total``, ``trans`` (R, 3) float32, ``seed`` (R,) int64,
    ``alive`` (R,) bool; ``rec`` the query's ``HitRecord``; ``materials``
    the pair of ``pack_materials``; ``sky_gradient`` the gradient sky (else
    black); ``rr`` Russian roulette in this segment (``cfg.use_rr`` and the
    segment at or past ``cfg.rr_start_bounce``).  CUDA tensors only: the
    transport takes ``_bounce`` everywhere else.  Launches through
    ``launches.launch``: on the current stream without synchronising,
    counted under T1.
    """
    if not on_card(d):
        raise ValueError("shade_segment_kernel: CUDA tensors only, got "
                         f"{d.device}")
    lanes = d.shape[0]
    table, mtype = materials
    ins = (("o", o, torch.float32, (lanes, 3)),
           ("d", d, torch.float32, (lanes, 3)),
           ("total", total, torch.float32, (lanes, 3)),
           ("trans", trans, torch.float32, (lanes, 3)),
           ("seed", seed, torch.int64, (lanes,)),
           ("alive", alive, torch.bool, (lanes,)),
           ("t", rec.t, torch.float32, (lanes,)),
           ("p", rec.p, torch.float32, (lanes, 3)),
           ("normal", rec.normal, torch.float32, (lanes, 3)),
           ("hit", rec.hit, torch.bool, (lanes,)),
           ("front", rec.front, torch.bool, (lanes,)),
           ("material", rec.material, torch.int32, (lanes,)),
           ("table", table, torch.float32, (table.shape[0], 14)),
           ("mtype", mtype, torch.int32, (table.shape[0],)))
    # one origin for every lane (the camera's, expanded) is read as one row
    shared = o.stride() == (0, 1)
    args = [o if shared else o.contiguous()]
    args += [t.contiguous() for _, t, _, _ in ins[1:]]
    outs = [torch.empty((lanes, 3), dtype=torch.float32, device=d.device)
            for _ in range(4)]
    outs += [torch.empty(lanes, dtype=torch.int64, device=d.device),
             torch.empty(lanes, dtype=torch.bool, device=d.device)]
    launches.launch("T1", d.device, ins,
                    args + outs + [lanes, 0 if shared else 3,
                                   int(sky_gradient), int(rr)],
                    contiguous=False)
    return tuple(outs)
