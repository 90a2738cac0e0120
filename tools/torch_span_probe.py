#!/usr/bin/env python3
"""What the program's spans and counters (utils/profiling.py) show of a
served frame, on one CUDA card.

    python3 tools/torch_span_probe.py [--cells bunny-serve cornell-serve
        bsdf-serve bunny-box-nee-serve] [--out span_probe.json]

For each serving cell of BENCHMARK.json it builds the cell's scene and
``Renderer`` as the benchmark does, serves a few frames (``step(1)`` then
``output()``), then profiles one more frame with CPU and CUDA activity,
inside ``profiling.counting()``, and charges

- each device operation to the spans around its launch (by correlation
  id): to every enclosing span (``device_ms``) and to the innermost alone
  (``self_ms``).  A CUDA-only profile holds no device range of a span, so
  the launch is what ties an operation to a span;
- each gap between device operations to the innermost span the host was
  in at the gap's middle (``idle_ms``);

and reads the counters: the lanes handed to the closest-hit queries and
the live ones among them, and under compaction the live lanes and the
block-rounded prefix of each partition.  From these it prints
``intersect_ms`` (device ms inside ``intersect``), ``sweep_glue_ms``
(inside ``sweep.sort`` and ``sweep.cull``), ``transport_idle_ms`` (idle ms
whose innermost span is ``bounce``), ``live_lane_share`` (100 · alive ÷
lanes), ``compact_ms`` (device and idle ms whose innermost span is
``compact``), ``padding_share`` (1 − ``compact.alive`` ÷ ``compact.kept``:
the share of the compacted bounces' lanes that were dead padding) and
``shade_ms`` (device ms of the fused shading kernel T1, ``shade_segment``)
and ``brute_hit_ms`` (of the brute-force search H1, ``brute_hit``) and
``cull_ms`` (of the sweep's cull kernel C1, ``cluster_cull``; the lanes
handed to it are the counter ``cull.lanes``),
beside the profiled frame's live lanes entering each bounce
(``golden.alive_per_bounce``, every lane marched, outside the profile).
Under NEE it adds ``nee_ms`` and ``shadow_ms`` (device ms inside the
``nee`` and ``shadow`` spans), ``nee_lane_share`` (100 · ``nee.lanes`` ÷
``shadow.lanes``: the share of the shadow query's lanes that sample a
light) and ``by_query``: the device and idle ms of each query's own spans
(the sweep's sort, cull and kernel) under ``intersect`` and under
``shadow``.
The last line is one JSON object with every number beside the card's
name and power limit.  ``--device cpu --size 32`` rehearses it on a CPU
(there are no device operations, so the device numbers are empty).
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness, program  # noqa: E402
from wc_path_tracer_tpu_torch.render import dispatch, golden  # noqa: E402
from wc_path_tracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from wc_path_tracer_tpu_torch.scene import camera  # noqa: E402
from wc_path_tracer_tpu_torch.utils import profiling  # noqa: E402

SPAN_NAMES = tuple(name for name, _ in profiling.SPANS)
NO_SPAN = "(no span)"


def merged(intervals):
    """Union of (start, end) intervals -> sorted disjoint [start, end]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def inside(t, union) -> bool:
    """Whether time ``t`` lies in one of ``union``'s disjoint intervals."""
    i = bisect.bisect_right(union, [t, float("inf")]) - 1
    return i >= 0 and union[i][0] <= t <= union[i][1]


def innermost(host, t):
    """host [(start, end, span)], sorted -> the latest-starting span
    holding time t."""
    best = None
    for s, e, name in host:
        if s > t:
            break
        if e >= t:
            best = name
    return best or NO_SPAN


def device_ms(ops, host) -> dict:
    """ops [(name, start, dur, launch)] and host spans [(start, end,
    span)] (ns) -> {span: device ms of the operations launched inside it},
    a nested span's operations counting for its parents too."""
    out = {}
    for span in {h[2] for h in host}:
        union = merged((s, e) for s, e, n in host if n == span)
        out[span] = sum(d for _, _, d, t in ops
                        if t is not None and inside(t, union)) / 1e6
    return out


def self_ms(ops, host) -> dict:
    """The same, each operation charged to the innermost span alone."""
    host = sorted(host)
    out: dict = {}
    for _, _, d, t in ops:
        name = NO_SPAN if t is None else innermost(host, t)
        out[name] = out.get(name, 0.0) + d / 1e6
    return out


def idle_ms(ops, host) -> dict:
    """Each gap between the merged device operations -> the innermost host
    span at its middle: {span: idle ms}."""
    busy = merged((s, s + d) for _, s, d, _ in ops)
    host = sorted(host)
    out: dict = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        name = innermost(host, (end + nxt) / 2)
        out[name] = out.get(name, 0.0) + (nxt - end) / 1e6
    return out


def within(ops, host, outer) -> dict:
    """The operations launched inside span ``outer``, by innermost span
    (device ms), and the gaps whose middle falls inside it, by innermost
    span (idle ms): {"device_ms": {...}, "idle_ms": {...}}."""
    union = merged((s, e) for s, e, n in host if n == outer)
    mine = [op for op in ops if op[3] is not None and inside(op[3], union)]
    busy = merged((s, s + d) for _, s, d, _ in ops)
    host = sorted(host)
    idle: dict = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = (end + nxt) / 2
        if inside(mid, union):
            name = innermost(host, mid)
            idle[name] = idle.get(name, 0.0) + (nxt - end) / 1e6
    return {"device_ms": self_ms(mine, host), "idle_ms": idle}


def kineto(prof):
    """(device operations [(name, start, dur, host launch time or None)],
    host spans [(start, end, span)]) of a profile, in ns."""
    from torch.autograd import DeviceType

    dev, host, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, s, d = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((name, s, d, e.correlation_id()))
        elif name in SPAN_NAMES:
            host.append((s, s + d, name))
        elif name.startswith("cuda") and e.correlation_id():
            launches[e.correlation_id()] = s
    return [(n, s, d, launches.get(c)) for n, s, d, c in dev], host


def serve_cell(name: str, device, size) -> dict:
    from torch.profiler import ProfilerActivity, profile

    _, config, traffic, _ = harness.cell_parts(harness.spec(), name)
    render = dict(config["render"])
    if size:
        render.update(width=size, height=size)
    scene, cam = program.build_scene(harness.load_scene(config), device)
    rdr = Renderer(scene, cam, program.render_config(render,
                                                     **traffic["post"]),
                   renderer=config["renderer"], device=device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def frame():
        rdr.step(1)
        rdr.output()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(4):
        frame()
    with profile(activities=acts):     # the profiler's own start
        frame()
    with profile(activities=acts) as prof:
        with profiling.counting() as counts:
            frame()
    ops, host = kineto(prof)
    total = device_ms(ops, host)
    own = self_ms(ops, host)
    idle = idle_ms(ops, host)
    lanes, alive = counts.get("intersect.lanes"), counts.get("intersect.alive")
    kept = counts.get("compact.kept")
    glue = [total[s] for s in ("sweep.sort", "sweep.cull") if s in total]
    cfg = rdr.cfg
    with torch.no_grad():
        per_bounce = golden.alive_per_bounce(
            rdr.scene, camera.camera_matrices(rdr.camera,
                                             cfg.width / cfg.height),
            cfg, rdr.frame_count - 1,
            dispatch.get_intersect_fn(config["renderer"], rdr.scene, cfg))
    return dict(
        cell=name, width=render["width"], height=render["height"],
        busy_ms=sum(e - s for s, e in merged(
            (s, s + d) for _, s, d, _ in ops)) / 1e6,
        device_ms=total, self_ms=own, idle_ms=idle,
        counters=counts, intersect_ms=total.get("intersect"),
        sweep_glue_ms=sum(glue) if glue else None,
        transport_idle_ms=idle.get("bounce"),
        live_lane_share=100.0 * alive / lanes if lanes else None,
        compact_ms=own.get("compact", 0.0) + idle.get("compact", 0.0)
        if ops else None,
        padding_share=1.0 - counts["compact.alive"] / kept if kept else None,
        shade_ms=sum(d for n, _, d, _ in ops if "shade_segment" in n) / 1e6
        if ops else None,
        brute_hit_ms=sum(d for n, _, d, _ in ops if "brute_hit" in n) / 1e6
        if ops else None,
        cull_ms=sum(d for n, _, d, _ in ops if "cluster_cull" in n) / 1e6
        if ops else None,
        nee_ms=total.get("nee"), shadow_ms=total.get("shadow"),
        nee_lane_share=100.0 * counts["nee.lanes"] / counts["shadow.lanes"]
        if counts.get("shadow.lanes") else None,
        by_query={q: within(ops, host, q) for q in ("intersect", "shadow")}
        if ops and "shadow" in total else None,
        alive_per_bounce=[int(a) for a in per_bounce])


def card(device) -> dict:
    if device.type != "cuda":
        return dict(name="cpu", power_limit="not measured")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return dict(name=torch.cuda.get_device_name(device),
                power_limit=out.stdout.strip().split(", ")[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+",
                    default=["bunny-serve", "cornell-serve", "bsdf-serve",
                             "bunny-box-nee-serve"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=0,
                    help="square frame size in place of the cell's "
                    "(a CPU rehearsal)")
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_span_probe: no CUDA device", file=sys.stderr)
        return 2
    line = dict(card=card(device), torch=torch.__version__, cells=[])
    for name in a.cells:
        r = serve_cell(name, device, a.size)
        line["cells"].append(r)
        print(f"[{name}] busy {r['busy_ms']:.2f} ms; intersect_ms "
              f"{r['intersect_ms']}, sweep_glue_ms {r['sweep_glue_ms']}, "
              f"transport_idle_ms {r['transport_idle_ms']}, "
              f"live_lane_share {r['live_lane_share']}, compact_ms "
              f"{r['compact_ms']}, padding_share {r['padding_share']}, "
              f"shade_ms {r['shade_ms']}, brute_hit_ms {r['brute_hit_ms']}, "
              f"cull_ms {r['cull_ms']}, "
              f"nee_ms {r['nee_ms']}, shadow_ms {r['shadow_ms']}, "
              f"nee_lane_share {r['nee_lane_share']}; alive per bounce "
              f"{r['alive_per_bounce']}", flush=True)
        parts = [(key, r[key]) for key in ("device_ms", "self_ms", "idle_ms",
                                           "counters")]
        for q, split in (r["by_query"] or {}).items():
            parts += [(f"{q} {key}", v) for key, v in split.items()]
        for key, values in parts:
            print(f"  {key}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in sorted(values.items(), key=lambda kv: -kv[1])),
                flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
