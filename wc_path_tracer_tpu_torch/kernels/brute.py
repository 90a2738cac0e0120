"""H1: the brute-force closest-hit search in one launch (csrc/brute_hit.cu).

``render/golden.py::intersect_scene_brute`` searches every sphere and
triangle slot for each lane; its plain twin ``golden._brute_search`` does it
with ~126 PyTorch ops over (rays x slots) tensors.  Where the lanes lie on
the card, ``golden`` hands the search to ``brute_hit_kernel`` instead (in
grad mode too: the search is detached, and the re-shade of the winners
stays in PyTorch).
"""

from __future__ import annotations

import torch

from wc_path_tracer_tpu_torch.kernels import launches


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a CUDA card, where the kernel runs."""
    return t.device.type == "cuda"


def brute_hit_kernel(origin, direction, position, radius, sphere_count,
                     a, b, c, tri_draw, draw_count, near_root_only: bool):
    """The closest live sphere and triangle of every lane -> (t_s, s_idx,
    t_tri, t_idx), bit for bit ``golden._brute_search``'s: float32 t with
    ``golden.KINF`` where nothing counts, int64 slot (0 where nothing
    counts).

    ``origin``, ``direction`` (R, 3) float32 (an origin expanded from one
    row is read in place); the spheres' ``position`` (S, 3), ``radius``
    (S,) float32 and live ``sphere_count`` () int32; the triangle slots'
    vertex rows ``a``, ``b``, ``c`` (T, 3) float32, ``tri_draw`` (T,) int32
    and the live ``draw_count`` () int32; ``near_root_only`` the config's
    sphere quirk.  Detached inputs, CUDA tensors only: the CPU runs the
    twin.  Launches through ``launches.launch``: on the current stream
    without synchronising, counted under H1.
    """
    if not on_card(direction):
        raise ValueError("brute_hit_kernel: CUDA tensors only, got "
                         f"{direction.device}")
    lanes, S, T = direction.shape[0], radius.shape[0], a.shape[0]
    ins = (("origin", origin, torch.float32, (lanes, 3)),
           ("direction", direction, torch.float32, (lanes, 3)),
           ("position", position, torch.float32, (S, 3)),
           ("radius", radius, torch.float32, (S,)),
           ("sphere_count", sphere_count, torch.int32, ()),
           ("a", a, torch.float32, (T, 3)),
           ("b", b, torch.float32, (T, 3)),
           ("c", c, torch.float32, (T, 3)),
           ("tri_draw", tri_draw, torch.int32, (T,)),
           ("draw_count", draw_count, torch.int32, ()))
    origin = origin.detach()
    shared = origin.stride() == (0, 1)
    args = [origin if shared else origin.contiguous()]
    args += [t.detach().contiguous() for _, t, _, _ in ins[1:]]
    dev = direction.device
    outs = [torch.empty(lanes, dtype=dtype, device=dev)
            for dtype in (torch.float32, torch.int64) * 2]
    launches.launch("H1", dev, ins,
                    args + outs + [lanes, 0 if shared else 3, S, T,
                                   int(near_root_only)],
                    contiguous=False)
    return tuple(outs)
