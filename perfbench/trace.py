"""What a traced run reads from the device: a ``torch.profiler`` trace of
a steady stretch of the window with CUDA activity only (the host is not
slowed by CPU-side recording), and one more step or frame with CPU
activity too, whose only use is to name what the host was doing in the
device's idle gaps.  No trace is written to disk."""

from __future__ import annotations

import dataclasses
import heapq
import time

import torch

# device operations that are not kernels: copies and fills
_NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class Stretch:
    """Device operations of a traced stretch: (name, start ns, duration
    ns) each, kernels apart from all operations."""

    ops: list
    kernels: list
    units: int            # steps or frames in the stretch
    wall_s: float         # host clock over the stretch, synchronised

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the operations' intervals)."""
        return sum(e - s for s, e in _merged(self.ops)) / 1e9


def _merged(ops):
    spans = sorted((s, s + d) for _, s, d in ops)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device_ops(prof):
    from torch.autograd import DeviceType

    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ops.append((e.name(), e.start_ns(), e.duration_ns()))
    return ops


def _profiler(cpu: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    return profile(activities=acts)


def warm_up(device):
    """Start and stop the profiler once in set-up, so that the traced
    stretch does not pay the tracer's own start."""
    with _profiler(False):
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def stretch(run_units, units: int, device) -> Stretch:
    """Trace ``run_units(units)``, which runs that many steps or frames."""
    torch.cuda.synchronize(device)
    with _profiler(False) as prof:
        t0 = time.perf_counter()
        run_units(units)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    ops = _device_ops(prof)
    kernels = [op for op in ops if not op[0].startswith(_NOT_KERNELS)]
    return Stretch(ops=ops, kernels=kernels, units=units, wall_s=wall)


def idle_gaps(run_units, device, top: int = 10) -> list:
    """Trace one step or frame with CPU activity too -> [[what the host was
    doing, idle seconds of the device], ...]: each gap between device
    operations is charged to the innermost host operation running at its
    middle, summed by name, largest first."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize(device)
    with _profiler(True) as prof:
        run_units(1)
        torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    # host operations, CUDA runtime calls left out (a launch names no work)
    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events if e.device_type() == DeviceType.CPU
                  and e.duration_ns() > 0 and not e.name().startswith("cu"))
    spans = _merged(_device_ops(prof))
    gaps = sorted(((end + nxt) / 2, (nxt - end) / 1e9)
                  for (_, end), (nxt, _) in zip(spans, spans[1:]))
    by_name: dict = {}
    active: list = []        # (-start, end, name): the latest start on top
    i = 0
    for mid, seconds in gaps:
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else "(no host operation)"
        by_name[name] = by_name.get(name, 0.0) + seconds
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]


def device_ops_top(s: Stretch, top: int = 10) -> list:
    """[[kernel name, device seconds], ...] over the stretch, largest
    first."""
    total: dict = {}
    for name, _, dur in s.ops:
        total[name[:120]] = total.get(name[:120], 0.0) + dur / 1e9
    return [[k, v] for k, v in sorted(total.items(),
                                      key=lambda kv: -kv[1])[:top]]
