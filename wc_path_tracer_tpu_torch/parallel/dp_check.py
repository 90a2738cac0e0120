"""Data-parallel check: run the same tasks on every rank of a process group
and in one process, and compare.

One rank:

    python -m wc_path_tracer_tpu_torch.parallel.dp_check --backend gloo \\
        --init-method tcp://localhost:29500 --world-size 2 --rank 0 \\
        --device cpu --spec spec.json --out results/

runs each task of ``spec.json`` over the group and writes what it computed
(images, losses, grads, parameters, kernel launches, ms per step) to
``results/rank0.pt``.  ``run_ranks`` starts every rank as a subprocess and
returns their results; ``run_task(task, device, None)`` computes the same
task in this process alone, the reference the ranks are held against.

A task is a dict: ``name``; ``kind`` ("render", "render_image" (the
brute-force ``render_image_sharded``), "loss_grad", "train" or
"replicate", or a kind of the caller's ``extra``); ``scene`` ("cornell",
"bunny_like2" or "bunny_gltf"); ``cfg`` (RenderConfig fields);
``renderer``; ``frame``; and per kind ``trainable``, ``lr``, ``timed`` (steps timed on the host
clock after the first).  Targets are zero images (the bench loss).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from wc_path_tracer_tpu_torch.kernels import launches
from wc_path_tracer_tpu_torch.models import builtin, procedural
from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.parallel import mesh as pmesh
from wc_path_tracer_tpu_torch.parallel import render as prender
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices
from wc_path_tracer_tpu_torch.utils.config import RenderConfig

MODULE = "wc_path_tracer_tpu_torch.parallel.dp_check"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


@functools.lru_cache(maxsize=None)
def _scene(name: str, device: str):
    """(Scene, Camera) of a task's scene, built once per process."""
    build = {"cornell": builtin.cornell_box_scene,
             "bunny_like2": functools.partial(procedural.bunny_like_scene, 2),
             "bunny_gltf": procedural.bunny_gltf_scene}[name]
    return build(device=device)


def run_task(task: dict, device, group=None, extra=None) -> dict:
    """One task over ``group`` (None: this process alone) -> its results,
    tensors on the host.  ``extra`` maps further kinds to functions
    (task, cfg, scene, camera, target, group) -> results."""
    device = torch.device(device)
    cfg = RenderConfig(**task["cfg"])
    scene, cam = _scene(task["scene"], str(device))
    renderer = task.get("renderer", "golden")
    frame = task.get("frame", 0)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    launches.reset_counts()
    out = {}
    kind = task["kind"]
    mats = camera_matrices(cam, cfg.width / cfg.height)
    if kind == "render":
        fn = prender.sharded_render_frame(cfg, renderer, group)
        out["image"] = fn(scene, mats, frame)
    elif kind == "render_image":
        out["image"] = prender.render_image_sharded(scene, mats, cfg, frame,
                                                    group)
    elif kind == "loss_grad":
        fn = prender.sharded_scene_loss_grad(cfg, task["trainable"],
                                             renderer, group)
        out["loss"], out["grads"] = fn(scene, cam, frame, target)
        times = []
        for i in range(task.get("timed", 0)):
            _sync(device)
            t0 = time.perf_counter()
            fn(scene, cam, frame + 1 + i, target)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out["step_ms"] = times
    elif kind == "train":
        step = prender.make_train_step(
            cfg, functools.partial(torch.optim.Adam, lr=task["lr"]),
            task["trainable"], renderer, group)
        s1, c1, state, loss0 = step(scene, cam, None, frame, target)
        loss1, _ = prender.sharded_scene_loss_grad(
            cfg, task["trainable"], renderer, group)(s1, c1, frame, target)
        out.update(loss_before=loss0, loss_after=loss1, grads=state.grads,
                   params=reg.get_params(s1, c1, task["trainable"]))
    elif kind == "replicate":
        # each rank scales its albedo by (1 + rank); replicate_scene must
        # hand every rank rank 0's
        mats = scene.materials
        mine = dataclasses.replace(scene, materials=dataclasses.replace(
            mats, albedo=mats.albedo * (1 + pmesh.rank(group))))
        out["before_differs"] = not torch.equal(mine.materials.albedo,
                                                mats.albedo)
        out["albedo"] = pmesh.replicate_scene(mine, group).materials.albedo
    elif extra and kind in extra:
        out.update(extra[kind](task, cfg, scene, cam, target, group))
    else:
        raise ValueError(f"unknown task kind {kind!r}")
    _sync(device)
    out["launches"] = launches.read_counts()
    return _host(out)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(tasks: list, world_size: int, backend: str, device: str,
              out_dir: str, timeout: float = 600.0, worker=None) -> list:
    """Start ``world_size`` ranks (subprocesses of this interpreter, one
    gloo or NCCL group over localhost), run ``tasks`` on each, and return
    each rank's results.  ``worker`` is the script each rank runs, one
    whose ``main`` calls this module's ``main`` (default: this module).
    Raises with a rank's output if one fails."""
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "spec.json")
    with open(spec, "w") as f:
        json.dump(tasks, f)
    init = f"tcp://localhost:{free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    run = [worker] if worker else ["-m", MODULE]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for r in range(world_size):
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, *run, "--backend", backend, "--init-method", init,
             "--world-size", str(world_size), "--rank", str(r),
             "--device", device, "--spec", spec, "--out", out_dir],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    failed = []
    try:
        for r, (p, _) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                rc = f"timed out after {timeout} s"
            if rc != 0:
                failed.append((r, rc))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "\n".join(
            f"--- rank {r} ({rc}):\n" + open(os.path.join(
                out_dir, f"rank{r}.log")).read()[-4000:] for r, rc in failed)
        raise RuntimeError(f"dp_check ranks failed:\n{logs}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(world_size)]


def main(argv=None, extra=None):
    """One rank: run the spec's tasks over the group (``extra`` as in
    ``run_task``) and save the results."""
    ap = argparse.ArgumentParser(prog="dp_check")
    ap.add_argument("--backend", required=True, choices=pmesh.BACKENDS)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)     # ranks share the host's cores
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if args.world_size > 1:
        group = pmesh.initialize_distributed(
            args.backend, args.init_method, args.world_size, args.rank)
    else:   # a group of one: the collectives still run
        dist.init_process_group(args.backend, init_method=args.init_method,
                                world_size=1, rank=0)
        group = dist.group.WORLD
    with open(args.spec) as f:
        tasks = json.load(f)
    results = {"backend": dist.get_backend(group),
               "world_size": pmesh.world_size(group),
               "rank": pmesh.rank(group), "device": str(device),
               "device_name": torch.cuda.get_device_name(device)
               if device.type == "cuda" else "cpu"}
    for task in tasks:
        results[task["name"]] = run_task(task, device, group, extra)
    dist.barrier(group=group)
    torch.save(results, os.path.join(args.out, f"rank{args.rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
