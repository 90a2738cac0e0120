"""The benchmark's runner: find a cell of BENCHMARK.json and everything
that belongs to it by name, run its loop, read its metrics, decide
``correct`` and print the result line.

By name: a cell's configuration is the file its ``configs`` entry names,
whose ``scene.loader`` is a module of perfbench/scenes; its traffic mix is
perfbench/traffic/<traffic>.json, whose ``kind`` is a module of
perfbench/loops; its limits are perfbench/limits/<cell>.json; each
per-layer metric is read by perfbench/metrics/<metric>.py.  Adding a
configuration, a mix, a cell or a metric adds files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from perfbench import check

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level module names the measured process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "wc_path_tracer_tpu")


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    raw: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float          # time.monotonic() at process start
    rank: int = 0
    init_method: str | None = None
    fault: str | None = None
    overrides: dict | None = None
    bench: dict | None = None

    @property
    def world(self) -> int:
        return int(self.traffic.get("world", 1))

    @property
    def render(self) -> dict:
        return self.config["render"]

    def setup_s(self) -> float:
        return time.monotonic() - self.started


@dataclasses.dataclass
class Outcome:
    """What a loop measured and kept for the check."""

    e2e: dict                   # end-to-end metric name -> value
    attempted: int
    failed: int
    samples: list               # per sampled step/frame: {number: value}
    memory_peak: int
    stretch: object = None      # trace.Stretch of the traced run
    spans: dict = dataclasses.field(default_factory=dict)
    breakdown: dict | None = None
    busy_s: float | None = None  # averaged over the ranks
    window_s: float | None = None


@dataclasses.dataclass
class MetricView:
    """What a per-layer metric reader sees of a traced run."""

    stretch: object
    render: dict
    world: int
    scene_sizes: dict
    spans: dict


def process_started() -> float:
    """time.monotonic() of this process's start (Linux: /proc), so that
    set-up counts the interpreter's own start."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.monotonic() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_parts(bench: dict, name: str, root: Path = ROOT,
               here: Path = HERE):
    """(cell, configuration, traffic, limits) of workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    limits = here / "limits" / f"{name}.json"
    return (cell, load_json(root / cfg_entry["file"]),
            load_json(here / "traffic" / f"{cell['traffic']}.json"),
            load_json(limits) if limits.exists() else None)


def load_scene(config: dict, root: Path = ROOT) -> dict:
    loader = importlib.import_module(
        f"perfbench.scenes.{config['scene']['loader']}")
    return loader.load(config["scene"], str(root))


def loop_module(traffic: dict):
    return importlib.import_module(f"perfbench.loops.{traffic['kind']}")


def metric_reader(name: str, here: Path = HERE):
    path = here / "metrics" / f"{name}.py"
    spec_ = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries that cell ``cell`` reports in such a run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def power_limit(device_index: int = 0) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device_index)], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def make_ctx(name: str, seed: int, seconds: float, trace: bool, device,
             started: float, rank: int = 0, init_method=None, fault=None,
             overrides: dict | None = None, bench: dict | None = None) -> Ctx:
    """A run's context; ``overrides`` replaces render fields, traffic
    entries and limits (the CPU tests' small sizes), ``bench`` the
    contents of BENCHMARK.json."""
    bench = bench or spec()
    cell, config, traffic, limits = cell_parts(bench, name)
    overrides = overrides or {}
    limits = overrides.get("limits", limits)
    if limits is None:
        raise SystemExit(f"no limits for {name}: perfbench/limits/{name}.json")
    config = dict(config, render={**config["render"],
                                  **overrides.get("render", {})})
    traffic = {**traffic, **overrides.get("traffic", {})}
    return Ctx(name=name, cell=cell, config=config, traffic=traffic,
               limits=limits, raw=load_scene(config), seed=seed,
               seconds=seconds, trace=trace, device=device, started=started,
               rank=rank, init_method=init_method, fault=fault,
               overrides=overrides, bench=bench)


def run_cell(ctx: Ctx) -> dict | None:
    """Run the cell -> the result line's object (None on a rank > 0)."""
    restore = None
    if ctx.fault:
        from perfbench import faults
        restore = faults.apply(ctx.fault)
    try:
        out = loop_module(ctx.traffic).run(ctx)
    finally:
        if restore:
            restore()
    if out is None:
        return None
    return result(ctx, out)


def result(ctx: Ctx, out: Outcome) -> dict:
    import torch

    bench = ctx.bench
    correct, checks = check.verdict(out.samples, ctx.limits, out.failed)
    metrics = {}
    if ctx.trace:
        view = MetricView(stretch=out.stretch, render=ctx.render,
                          world=ctx.world,
                          scene_sizes=dict(
                              triangles=len(ctx.raw["indices"]) // 3,
                              spheres=len(ctx.raw["spheres"])),
                          spans=out.spans)
        for m in cell_metrics(bench, ctx.name, True):
            v = metric_reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, ctx.name, False):
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]),
                                  "unit": m["unit"]}
    dev = torch.device(ctx.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu",
              "count": ctx.world, "memory_peak_bytes": int(out.memory_peak),
              "power_limit": power_limit() if dev.type == "cuda"
              else "not measured"}
    if ctx.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if ctx.trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = checks
    return line


def frame_base(seed: int) -> int:
    """The first frame index of a run, drawn from the seed."""
    return int(np.random.default_rng(seed).integers(0, 2 ** 32))


def sample(seed: int, n: int, k: int, must=None) -> list:
    """k distinct indices of range(n) drawn from the seed; ``must`` (if
    given) is among them."""
    rng = np.random.default_rng([seed, 1])
    pool = [i for i in range(n) if i != must]
    picks = list(rng.choice(pool, size=min(k - (must is not None), len(pool)),
                            replace=False)) if pool else []
    return sorted(([must] if must is not None else [])
                  + [int(i) for i in picks])


def percentile(values, q: float) -> float:
    """The q-th percentile by nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def main(args, started: float) -> int:
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device is available; nothing measured",
              file=sys.stderr)
        return 2
    bench = spec()
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"perfbench: unknown workload {args.workload!r}",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"devices, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = make_ctx(args.workload, args.seed, args.seconds, bool(args.trace),
                   device, started)
    line = run_cell(ctx)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the measured process holds {found}; no result",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"perfbench check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
