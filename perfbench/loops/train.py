"""The closed training loop (traffic ``kind`` "train").

Set-up builds the program's scene and its loss-and-grad function once
(``scene_loss_grad``, or over ``world`` > 1 ranks
``sharded_scene_loss_grad``), runs the warm-up steps through that same
function, and hands it to the window.  Step i of the window renders frame
index (base + i) mod 2^32, base drawn from the seed, and ends in a host
read of its loss; the window closes after the step that crosses
``seconds``.  ``train_mrays`` counts every step's path segments, W x H x
samples x (max_bounces + 1), over the window's seconds.

Over several ranks, rank 0 starts the others (perfbench/rank.py) and
decides after each step whether the window goes on; every rank keeps
what each of its steps returned, and rank 0 holds every rank's values
against the reference.  The reference runs once the window has closed
and the program's state is freed, on a sample of the window's steps drawn
from the seed.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time

import torch

from perfbench import check, harness, program, trace

MASK32 = 0xFFFFFFFF


def _spawn(ctx, init: str) -> list:
    import json
    procs = []
    for r in range(1, ctx.world):
        dev = f"cuda:{r}" if torch.device(ctx.device).type == "cuda" \
            else "cpu"
        spec = dict(name=ctx.name, seed=ctx.seed, seconds=ctx.seconds,
                    trace=ctx.trace, device=dev, rank=r, init_method=init,
                    fault=ctx.fault, overrides=ctx.overrides,
                    bench=ctx.bench)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "perfbench.rank", json.dumps(spec)],
            cwd=str(harness.ROOT)))
    return procs


def _reap(procs, timeout: float = 120.0):
    bad = []
    for p in procs:
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        if rc:
            bad.append(rc)
    return bad


@contextlib.contextmanager
def _group(ctx):
    """The process group of a multi-rank cell (None for one rank), its
    further ranks started and, at the end, waited for."""
    if ctx.world == 1:
        yield None
        return
    import torch.distributed as dist

    procs = []
    init = ctx.init_method
    if ctx.rank == 0:
        init = f"tcp://localhost:{harness.free_port()}"
        procs = _spawn(ctx, init)
    backend = ctx.traffic["backend"] \
        if torch.device(ctx.device).type == "cuda" else "gloo"
    try:
        dist.init_process_group(backend, init_method=init,
                                world_size=ctx.world, rank=ctx.rank)
        yield dist.group.WORLD
        dist.destroy_process_group()
    finally:
        bad = _reap(procs)
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx):
    with _group(ctx) as group:
        return _run(ctx, group)


def _run(ctx, group):
    import torch.distributed as dist
    from wc_path_tracer_tpu_torch.parallel import render as prender

    dev = torch.device(ctx.device)
    r, tr = ctx.render, ctx.traffic
    scene, cam = program.build_scene(ctx.raw, dev)
    cfg = program.render_config(r)
    trainable = tuple(tr["trainable"])
    if group is None:
        fn = prender.scene_loss_grad(cfg, trainable, ctx.config["renderer"])
    else:
        fn = prender.sharded_scene_loss_grad(cfg, trainable,
                                             ctx.config["renderer"], group)
    target = torch.zeros((r["height"], r["width"], 3), device=dev)
    base = harness.frame_base(ctx.seed)
    kept = []            # per window step: (loss, grads) as returned

    for k in range(tr["warmup_steps"]):
        loss, _ = fn(scene, cam, (base - 1 - k) & MASK32, target)
        loss.item()
    if ctx.trace and dev.type == "cuda":
        trace.warm_up(dev)
    if group is not None:
        dist.barrier()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = ctx.setup_s()

    def steps(n):
        for _ in range(n):
            loss, grads = fn(scene, cam, (base + len(kept)) & MASK32, target)
            loss.item()
            kept.append((loss, grads))

    stretch = gaps = None
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while True:
        if ctx.trace and stretch is None and len(kept) >= tr["trace_skip"] \
                and dev.type == "cuda":
            stretch = trace.stretch(steps, tr["trace_steps"], dev)
            gaps = trace.idle_gaps(steps, dev)
        else:
            steps(1)
        go = time.perf_counter() < deadline or (
            ctx.trace and stretch is None and dev.type == "cuda")
        if group is not None:
            flag = torch.tensor([float(go)], device=dev)
            dist.broadcast(flag, 0)
            go = bool(flag.item())
        if not go:
            break
    window_s = time.perf_counter() - t0
    n = len(kept)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    names = list(kept[0][1])
    shapes = [kept[0][1][k].shape for k in names]
    flat = torch.stack([torch.cat([loss.reshape(1).double()]
                                  + [g[k].reshape(-1).double() for k in names])
                        for loss, g in kept])
    stats = torch.tensor([stretch.busy_s if stretch else 0.0,
                          stretch.wall_s if stretch else 0.0, float(peak)],
                         dtype=torch.float64, device=dev)
    if group is not None:
        flats = [torch.empty_like(flat) for _ in range(ctx.world)]
        dist.all_gather(flats, flat)
        all_stats = [torch.empty_like(stats) for _ in range(ctx.world)]
        dist.all_gather(all_stats, stats)
        if ctx.rank:
            return None
    else:
        flats, all_stats = [flat], [stats]
    flats = [f.cpu() for f in flats]
    all_stats = torch.stack(all_stats).cpu()
    failed = int((~torch.isfinite(flats[0])).any(1).sum())
    del fn, scene, cam, kept, flat, target
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    segments = r["width"] * r["height"] * r["samples"] * (r["max_bounces"] + 1)
    out = harness.Outcome(
        e2e={"train_mrays": n * segments / window_s / 1e6,
             "setup_s": setup_s},
        attempted=n, failed=failed, samples=[],
        memory_peak=int(all_stats[:, 2].max()), stretch=stretch)
    if stretch is not None:
        out.busy_s = float(all_stats[:, 0].mean())
        out.window_s = float(all_stats[:, 1].mean())
        out.breakdown = {"device_ops": trace.device_ops_top(stretch),
                         "idle_gaps": gaps}

    sizes = [int(torch.Size(s).numel()) for s in shapes]
    reference = ctx.reference
    sc = reference.prepare(ctx.raw, dev)
    with reference.exact_matmuls():
        for i in harness.sample(ctx.seed, n, tr["check_steps"]):
            ref_loss, ref_grads = reference.loss_grad(
                sc, r, (base + i) & MASK32, trainable)
            for f in flats:
                parts = f[i, 1:].split(sizes)
                grads = {k: p.view(s) for k, p, s in zip(names, parts,
                                                         shapes)}
                out.samples.append(check.train_numbers(
                    f[i, 0], grads, ref_loss, ref_grads))
    return out
