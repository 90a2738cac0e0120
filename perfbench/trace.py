"""What a traced run reads from the device: a ``torch.profiler`` trace of
a steady stretch of the window with CUDA activity only (the host is not
slowed by CPU-side recording), one more step or frame with CPU activity
too, whose only use is to name what the host was doing in the device's
idle gaps, and, in a serving run, a span pass: frames with CPU and CUDA
activity whose device and idle time is split by the program's spans, then
as many frames inside the program's counters.  No trace is written to disk.

Times of the span arithmetic are in ns in and ms out: a device operation
is (name, start, duration, host launch time or None), a host span
(start, end, span name)."""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import time

import torch

from perfbench import program

# device operations that are not kernels: copies and fills
_NOT_KERNELS = ("Memcpy", "Memset")
# where a span pass finds the host outside every span
NO_SPAN = "(no span)"


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
        return sum(e - s for s, e in merged(
            (s, s + d) for _, s, d in self.ops)) / 1e9


def merged(intervals):
    """Union of (start, end) intervals -> sorted disjoint [start, end]."""
    out = []
    for s, e in sorted(intervals):
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
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events if e.device_type() == DeviceType.CPU
            and e.duration_ns() > 0 and not e.name().startswith("cu")]
    return gaps_by_host(_device_ops(prof), host, top)


def gaps_by_host(ops, host, top: int = 10) -> list:
    """Device operations (name, start, duration) and host operations
    (start, end, name), in ns -> [[host operation, idle seconds], ...]:
    idle_gaps' reading of a profile, largest first."""
    by_name = _by_innermost(host, _gaps(ops, 1e9), "(no host operation)")
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


def _inside(t, union) -> bool:
    """Whether time ``t`` lies in one of ``union``'s disjoint intervals."""
    i = bisect.bisect_right(union, [t, float("inf")]) - 1
    return i >= 0 and union[i][0] <= t <= union[i][1]


def innermost(host, times, none: str = NO_SPAN) -> list:
    """Host spans and ascending times -> for each time the innermost span
    holding it (the latest-starting; of equal starts the shortest, then the
    first name), or ``none``."""
    host = sorted(host)
    out, active, i = [], [], 0      # active: (-start, end, name)
    for t in times:
        while i < len(host) and host[i][0] <= t:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        out.append(active[0][2] if active else none)
    return out


def _by_innermost(host, timed, none: str = NO_SPAN) -> dict:
    """[(time, value)] -> {innermost span at the time: summed value}."""
    timed = sorted(timed)
    out: dict = {}
    for (_, v), name in zip(timed, innermost(host, [t for t, _ in timed],
                                             none)):
        out[name] = out.get(name, 0.0) + v
    return out


def _gaps(ops, per_ns: float = 1e6) -> list:
    """[(middle, idle ms)] of each gap between the merged operations (idle
    seconds with ``per_ns`` 1e9)."""
    busy = merged((op[1], op[1] + op[2]) for op in ops)
    return [((end + nxt) / 2, (nxt - end) / per_ns)
            for (_, end), (nxt, _) in zip(busy, busy[1:])]


def device_ms(ops, host) -> dict:
    """{span: device ms of the operations launched inside it}: a nested
    span's operations count for its parents too."""
    out = {}
    for span in {h[2] for h in host}:
        union = merged((s, e) for s, e, n in host if n == span)
        out[span] = sum(d for _, _, d, t in ops
                        if t is not None and _inside(t, union)) / 1e6
    return out


def self_ms(ops, host) -> dict:
    """The same, each operation charged to the innermost span around its
    launch alone; one with no launch on record to NO_SPAN."""
    out = _by_innermost(host, [(t, d / 1e6) for _, _, d, t in ops
                               if t is not None])
    lost = sum(d for _, _, d, t in ops if t is None) / 1e6
    if lost:
        out[NO_SPAN] = out.get(NO_SPAN, 0.0) + lost
    return out


def idle_ms(ops, host) -> dict:
    """Each gap between the merged device operations -> the innermost host
    span at its middle: {span: idle ms}."""
    return _by_innermost(host, _gaps(ops))


def within(ops, host, outer) -> dict:
    """The operations launched inside span ``outer``, by innermost span
    (device ms), and the gaps whose middle falls inside it, by innermost
    span (idle ms): {"device_ms": {...}, "idle_ms": {...}}."""
    union = merged((s, e) for s, e, n in host if n == outer)
    mine = [op for op in ops if op[3] is not None and _inside(op[3], union)]
    return {"device_ms": self_ms(mine, host),
            "idle_ms": _by_innermost(host, [g for g in _gaps(ops)
                                            if _inside(g[0], union)])}


def kineto(prof, span_names):
    """(device operations, host spans) of a profile with CPU and CUDA
    activity.  A device operation's launch is the CUDA API call (runtime
    ``cuda*`` or driver ``cu*``) of its correlation id; only ranges named
    in ``span_names`` are spans."""
    from torch.autograd import DeviceType

    dev, host, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, s, d = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((name, s, d, e.correlation_id()))
        elif name in span_names:
            host.append((s, s + d, name))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = s
    return [(n, s, d, launches.get(c)) for n, s, d, c in dev], host


def span_split(ops, host, counts: dict, frames: int) -> dict:
    """A span pass's readings, each per frame: ``device`` (device_ms),
    ``self`` (self_ms), ``idle`` (idle_ms) and ``counters`` (the program's
    totals)."""
    def per(d):
        return {k: v / frames for k, v in d.items()}

    return {"device": per(device_ms(ops, host)),
            "self": per(self_ms(ops, host)),
            "idle": per(idle_ms(ops, host)), "counters": per(counts)}


def span_pass(run_units, device, frames: int) -> dict:
    """Profile ``run_units(frames)`` with CPU and CUDA activity, then run
    as many frames more, unprofiled, inside the program's counters ->
    span_split's readings.  The counters sum tensors on the device, so
    they stay out of the profiled frames.  One profiled frame before them,
    not kept, pays the profiler's own start."""
    torch.cuda.synchronize(device)
    with _profiler(True):
        run_units(1)
        torch.cuda.synchronize(device)
    with _profiler(True) as prof:
        run_units(frames)
        torch.cuda.synchronize(device)
    with program.counting() as counts:
        run_units(frames)
    ops, host = kineto(prof, program.span_names())
    return span_split(ops, host, counts, frames)


def own_ms(span_ms, spans) -> float | None:
    """Device ms a frame launched with one of ``spans`` as the innermost
    span (None where no pass ran or none of them launched anything).  The
    idle ms in them are host time under the profiler, which spreads far
    more from run to run than the device's, so they are not added."""
    if span_ms is None:
        return None
    parts = [span_ms["self"][s] for s in spans if s in span_ms["self"]]
    return sum(parts) if parts else None
