"""Benchmark of the port: Mrays/s/chip forward+backward on the 1024^2 Cornell
config, with the command line, scenes, loss, rows and JSON line of the JAX
package's ``bench.py``.

    python -m wc_path_tracer_tpu_torch.bench                # on the card
    python -m wc_path_tracer_tpu_torch.bench --device cpu --small --size 16

Prints ONE JSON line, the last line of standard output:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}

Rays counted = path segments launched = W*H*samples*(max_bounces+1).
fwd+bwd = the mean squared error of the frame against a zero target,
differentiated with respect to the material parameters
(``parallel/render.py::scene_loss_grad`` over ``BENCH_TRAINABLE``); each
step's scalar is the loss plus the sum of every grad, so nothing goes
unused.  Steps render frames 1..K.

Timing: one warm-up step (the kernels build at first use), then the K steps
between two CUDA events, ending in ``torch.cuda.synchronize()`` and one host
read of the accumulated scalar, which must be finite; the best of 2 repeats,
divided by K.  The host clock of the same window, the part of it spent
waiting for the card after the last enqueue, and the kernel launches per
step go to standard error.  On the CPU (``--device cpu``) the host clock is
the time.

``vs_baseline`` compares with the port's first recorded measurement of the
same (mode, size, scene), a ``torch-bench-baseline`` marker line in the
repository's PERF.md (found from this package's location); until one exists
it is 1.0.

Under ``--scene cornell``, neither ``--small`` nor another renderer than
"auto", the record carries three rows: ``bvh_row`` (the 512^2 glTF bunny
through the cluster sweep), ``bsdf_row`` (the full-BSDF box, 1024^2, 8
bounces, Russian roulette) and ``scaling_efficiency_8`` (one frame against
a batch of 8 band frames of 1/8 of its rows).  A row that raises ends the
run with the traceback and a non-zero exit, and no JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

BASELINE_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "PERF.md")
BASELINE_MARKER = "<!-- torch-bench-baseline"
COMPACT_CONFIG_D = False     # the JAX bench's recorded choice for bsdf_row
REPEATS = 2                  # timed repeats of K steps; the best is kept
ROW_ITERS = 3                # K of bvh_row and bsdf_row, as in bench.py
SCALING_ITERS = 5            # scaling_efficiency_8: K, and its repeats


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="wc_path_tracer_tpu_torch.bench")
    ap.add_argument("--small", action="store_true",
                    help="small CPU-friendly smoke config")
    ap.add_argument("--size", type=int, default=None, help="image size override")
    ap.add_argument("--samples", type=int, default=1)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--forward-only", action="store_true")
    ap.add_argument("--renderer", default="auto",
                    choices=["auto", "golden", "wavefront", "pallas", "sweep"],
                    help="render path to benchmark")
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "bunny", "default", "triangle", "bsdf"],
                    help="benchmark scene (BASELINE config ladder)")
    ap.add_argument("--nee", action="store_true",
                    help="next-event estimation (config b)")
    ap.add_argument("--rr", action="store_true",
                    help="Russian roulette termination (config d)")
    ap.add_argument("--compact", action="store_true",
                    help="alive-ray stream compaction between bounces")
    ap.add_argument("--compact-blocks", type=int, default=16)
    ap.add_argument("--subdiv", type=int, default=5,
                    help="bunny mesh subdivision level (20*4^n tris)")
    ap.add_argument("--row-chunks", type=int, default=0,
                    help="frame row-banding of the JAX package (0 = auto); "
                         "kept in the config, the port renders one band")
    ap.add_argument("--ray-sort", default="dynamic",
                    choices=["static", "dynamic", "off"],
                    help="ray regrouping before the cluster sweep")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs every kernel's plain twin)")
    return ap, ap.parse_args(argv)


def build_scene(name: str, renderer: str, subdiv: int, device):
    """The bench's scene ladder -> (scene, camera, sky).  Under "pallas" the
    bunny is split into draws of at most ``dispatch.PALLAS_MAX_TRIS``
    triangles, the JAX bench's draw layout."""
    from wc_path_tracer_tpu_torch.models import builtin
    if name == "cornell":
        return (*builtin.cornell_box_scene(device=device), "black")
    if name == "bunny":
        from wc_path_tracer_tpu_torch.models.procedural import (
            bunny_gltf_scene, bunny_like_scene)
        from wc_path_tracer_tpu_torch.render.dispatch import PALLAS_MAX_TRIS
        blas = PALLAS_MAX_TRIS if renderer == "pallas" else None
        if subdiv == 5:
            scene, cam = bunny_gltf_scene(max_blas_tris=blas, device=device)
        else:
            scene, cam = bunny_like_scene(subdiv, max_blas_tris=blas,
                                          device=device)
        return scene, cam, "gradient"
    if name == "triangle":
        return (*builtin.single_triangle_scene(device=device), "black")
    if name == "bsdf":
        return (*builtin.full_bsdf_scene(device=device), "black")
    return (builtin.default_scene(device=device),
            builtin.default_camera(device=device), "gradient")


def make_config(args, size: int, sky: str):
    from wc_path_tracer_tpu_torch.utils.config import RenderConfig
    return RenderConfig(width=size, height=size, samples=args.samples,
                        max_bounces=args.bounces, sky=sky,
                        use_nee=args.nee, use_rr=args.rr,
                        compact=args.compact,
                        compact_blocks=args.compact_blocks,
                        ray_sort=args.ray_sort, row_chunks=args.row_chunks)


def fold(loss, grads) -> torch.Tensor:
    """The step's scalar: the loss plus the sum of every grad."""
    return loss + sum(torch.sum(g) for g in grads.values())


def make_step(cfg, renderer: str, forward_only: bool = False):
    """(scene, mats, frame, target) -> the step's 0-d scalar tensor: the sum
    of the frame (``forward_only``), else ``fold`` of ``scene_loss_grad``'s
    loss and grads over ``BENCH_TRAINABLE``."""
    from wc_path_tracer_tpu_torch.parallel import render as prender
    from wc_path_tracer_tpu_torch.render import dispatch
    if forward_only:
        @torch.no_grad()
        def frame_sum(scene, mats, frame, target):
            render_frame = dispatch.get_render_frame(renderer, scene, cfg)
            return torch.sum(render_frame(scene, mats, cfg, frame))
        return frame_sum
    loss_grad = prender.scene_loss_grad(cfg, prender.BENCH_TRAINABLE,
                                        renderer)

    def fwd_bwd(scene, mats, frame, target):
        return fold(*loss_grad(scene, mats, frame, target))
    return fwd_bwd


def run_steps(step, frames):
    """The sum of ``step(frame)`` over ``frames``, as one tensor."""
    acc = None
    for f in frames:
        s = step(f)
        acc = s if acc is None else acc + s
    return acc


def _launches() -> dict:
    from wc_path_tracer_tpu_torch.kernels import launches
    return launches.named(launches.read_counts())


def time_steps(label: str, step, frames, device, repeats: int = REPEATS):
    """Best seconds of ``repeats`` runs of ``step`` over ``frames``, each
    between two CUDA events (the host clock on the CPU), ending in a
    synchronize and one host read of the accumulated scalar, which must be
    finite.  To standard error go the kernel launches per step and, for
    each window, its host clock and the part of it spent waiting for the
    card after the last launch was enqueued: a wait near 0 means the card
    kept up with the host, a wait near the whole window that the host kept
    up with the card."""
    from wc_path_tracer_tpu_torch.kernels import launches
    cuda = device.type == "cuda"
    best = math.inf
    host, wait = [], []
    launches.reset_counts()
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        acc = run_steps(step, frames)
        if cuda:
            end.record()
        t_enqueued = time.perf_counter()
        if cuda:
            torch.cuda.synchronize(device)
        v = float(acc)
        t1 = time.perf_counter()
        host.append(t1 - t0)
        wait.append(t1 - t_enqueued)
        if not math.isfinite(v):
            raise FloatingPointError(f"{label}: non-finite value {v} in the "
                                     "benched computation")
        best = min(best, start.elapsed_time(end) / 1e3 if cuda else host[-1])
    steps = repeats * len(frames)
    counts = _launches()
    print(f"bench: {label}: {len(frames)} steps, best of {repeats}: "
          f"{best:.4f} s ({'CUDA events' if cuda else 'host clock'}); host "
          f"clock {', '.join(f'{h:.4f}' for h in host)} s, of which the "
          f"wait after the last enqueue {', '.join(f'{w:.4f}' for w in wait)}"
          " s", file=sys.stderr)
    print("bench: launches " + json.dumps(dict(
        row=label, steps=steps, counts=counts,
        per_step={k: n / steps for k, n in counts.items()})),
        file=sys.stderr)
    return best


def warm_up(label: str, step):
    t0 = time.perf_counter()
    float(step(1))
    print(f"bench: {label}: warm-up step (kernel build at first use) "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)


def alive_segments(scene, mats, cfg, renderer: str) -> int:
    """Alive lane-segments of frame 1, counted through the active
    backend."""
    from wc_path_tracer_tpu_torch.render import dispatch, golden
    return golden.count_alive_segments(
        scene, mats, cfg, 1, dispatch.get_intersect_fn(renderer, scene, cfg))


def headline_metric(mode: str, size: int, scene: str, bounces: int) -> str:
    return f"Mrays/s/chip {mode} ({size}^2 {scene}, {bounces} bounces)"


def bvh_metric(size: int = 512, bounces: int = 4) -> str:
    return (f"Mrays/s/chip fwd+bwd ({size}^2 bunny-21.8k-tris, {bounces} "
            "bounces, cluster-sweep)")


def bsdf_metric(size: int = 1024, bounces: int = 8) -> str:
    return (f"Mrays/s/chip fwd+bwd ({size}^2 full-BSDF, {bounces} bounces, "
            f"RR, compact={'on' if COMPACT_CONFIG_D else 'off'})")


def _fwd_bwd_rate(label, scene, cam, cfg, device):
    """(Mrays/s of ``ROW_ITERS`` fwd+bwd steps through "auto", mats)."""
    from wc_path_tracer_tpu_torch.scene.camera import camera_matrices
    mats = camera_matrices(cam, 1.0)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    fwd_bwd = make_step(cfg, "auto")

    def step(f):
        return fwd_bwd(scene, mats, f, target)
    warm_up(label, step)
    best = time_steps(label, step, range(1, ROW_ITERS + 1), device)
    segments = cfg.width * cfg.height * (cfg.max_bounces + 1)
    return segments / (best / ROW_ITERS) / 1e6, mats


def bvh_row(device, size: int = 512, bounces: int = 4):
    """The 512^2 glTF bunny (20,480 triangles), fwd+bwd through "auto" (the
    cluster sweep)."""
    from wc_path_tracer_tpu_torch.models.procedural import bunny_gltf_scene
    from wc_path_tracer_tpu_torch.utils.config import RenderConfig
    scene, cam = bunny_gltf_scene(device=device)
    cfg = RenderConfig(width=size, height=size, samples=1,
                       max_bounces=bounces, sky="gradient")
    mrays, _ = _fwd_bwd_rate("bvh_row", scene, cam, cfg, device)
    return {"metric": bvh_metric(size, bounces), "value": round(mrays, 3),
            "unit": "Mrays/s"}


def bsdf_row(device, size: int = 1024, bounces: int = 8):
    """The full-BSDF box, 8 bounces, Russian roulette, fwd+bwd (config d),
    with its alive counts."""
    from wc_path_tracer_tpu_torch.models import builtin
    from wc_path_tracer_tpu_torch.utils.config import RenderConfig
    scene, cam = builtin.full_bsdf_scene(device=device)
    cfg = RenderConfig(width=size, height=size, samples=1,
                       max_bounces=bounces, sky="black", use_rr=True,
                       compact=COMPACT_CONFIG_D)
    mrays, mats = _fwd_bwd_rate("bsdf_row", scene, cam, cfg, device)
    row = {"metric": bsdf_metric(size, bounces), "value": round(mrays, 3),
           "unit": "Mrays/s"}
    segments = cfg.width * cfg.height * (cfg.max_bounces + 1)
    alive = alive_segments(scene, mats, cfg, "auto")
    row["alive_fraction"] = round(alive / segments, 4)
    row["alive_mrays"] = round(row["value"] * alive / segments, 3)
    return row


def scaling_loss_grad(n: int, scene, mats, cfg):
    """The scaling row's step: step -> (images (n, H/n, W, 3), loss, grads).
    It renders ``n`` frames, ``step * n + i`` for i < n, of the first H/n
    rows (the band one of n ranks renders, ``parallel/render.py``) through
    brute force as one batch (``golden.render_rows_frames``, the JAX
    bench's ``jax.vmap`` over frames), and takes the grads over
    ``BENCH_TRAINABLE`` of the mean over the frames of each frame's mean
    squared error against a zero target."""
    from wc_path_tracer_tpu_torch.optim import params as reg
    from wc_path_tracer_tpu_torch.parallel import render as prender
    from wc_path_tracer_tpu_torch.render import golden
    band = cfg.height // n

    def loss_grad(step):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in reg.get_params(scene, None,
                                             prender.BENCH_TRAINABLE).items()}
        s, _ = reg.apply_params(scene, None, params)
        img = golden.render_rows_frames(
            s, mats, cfg, [step * n + i for i in range(n)], 0, band)
        loss = torch.mean(torch.mean(img ** 2, dim=(1, 2, 3)))
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return img.detach(), loss.detach(), {
            k: g for k, g in zip(params, grads) if g is not None}
    return loss_grad


def scaling_efficiency(n: int, scene, mats, cfg, dt_full: float,
                       device) -> float:
    """Per-device efficiency of n-way row sharding, T(full) / (n * T(band)),
    T(band) the time per band frame of ``scaling_loss_grad``'s steps, whose
    n band frames are one batch with as many lanes as a full frame."""
    loss_grad = scaling_loss_grad(n, scene, mats, cfg)

    def step(frame):
        return fold(*loss_grad(frame)[1:])
    label = f"scaling_efficiency_{n}"
    warm_up(label, step)
    best = time_steps(label, step, range(1, SCALING_ITERS + 1), device,
                      SCALING_ITERS)
    return round(dt_full / (n * best / (SCALING_ITERS * n)), 4)


def read_baseline(mode: str, size: int, scene: str, path=BASELINE_FILE):
    """The first ``torch-bench-baseline`` marker of (mode, size, scene) in
    ``path``, or None."""
    try:
        with open(path) as f:
            for line in f:
                if not line.startswith(BASELINE_MARKER):
                    continue
                parts = dict(p.split("=", 1) for p in line.split()
                             if "=" in p)
                if (parts.get("mode") == mode
                        and int(parts.get("size", 0)) == size
                        and parts.get("scene") == scene):
                    return float(parts["value"])
    except FileNotFoundError:
        pass
    return None


def main(argv=None) -> dict:
    ap, args = parse_args(argv)
    from wc_path_tracer_tpu_torch.scene.camera import camera_matrices
    from wc_path_tracer_tpu_torch.utils.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)

    size = args.size or (128 if args.small else 1024)
    scene, cam, sky = build_scene(args.scene, args.renderer, args.subdiv,
                                  device)
    cfg = make_config(args, size, sky)
    mats = camera_matrices(cam, 1.0)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    bench_step = make_step(cfg, args.renderer, args.forward_only)

    def step(f):
        return bench_step(scene, mats, f, target)

    K = max(args.iters, 1)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"bench: {size}x{size}, samples={cfg.samples}, "
          f"bounces={cfg.max_bounces}, renderer={args.renderer}, "
          f"fwd_only={args.forward_only}, iters={K}, device={device} "
          f"({name})", file=sys.stderr)
    warm_up("headline", step)
    dt = time_steps("headline", step, range(1, K + 1), device) / K

    segments = cfg.width * cfg.height * cfg.samples * (cfg.max_bounces + 1)
    mrays = segments / dt / 1e6
    mode = "fwd" if args.forward_only else "fwd+bwd"
    baseline = read_baseline(mode, size, args.scene)
    vs = mrays / baseline if baseline else 1.0

    record = {
        "metric": headline_metric(mode, size, args.scene, cfg.max_bounces),
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(vs, 3),
    }
    # the share of dispatched segments that are alive (after misses and RR)
    alive = alive_segments(scene, mats, cfg, args.renderer)
    record["alive_fraction"] = round(alive / segments, 4)
    record["alive_mrays"] = round(mrays * alive / segments, 3)

    if args.scene == "cornell" and not args.small and args.renderer == "auto":
        record["bvh_row"] = bvh_row(device)
        record["bsdf_row"] = bsdf_row(device)
        if not args.forward_only:
            record["scaling_efficiency_8"] = scaling_efficiency(
                8, scene, mats, cfg, dt, device)

    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
