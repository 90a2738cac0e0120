#!/usr/bin/env python3
"""The cluster cull against a parent checkout's, on one CUDA card, in one
process.

    python3 tools/torch_cull_ab.py PARENT_DIR [--reps 20] [--rounds 2]

PARENT_DIR is a checkout of an earlier commit (e.g. ``git archive`` of it
unpacked into a git-ignored directory); its
``wc_path_tracer_tpu_torch/kernels/cluster.py`` is loaded beside this
tree's and only its ``_cull`` is used.  Both trees' kernels are this
tree's: the cull decides which clusters each 512-ray block visits
(``nact``, the list, the entry distances) and each ray's farthest exit
(``t_lim``, read by the kernels' early exit).

The script renders one frame of the 512 x 512 bunny (NEE off) and of the
lit 512 x 512 bunny (NEE+MIS, ``chip_smoke.lit_bunny_scene``) through B1
and through B2 (``cluster_kernel="mxu"``), 4 bounces, and captures every
sweep query: the closest-hit queries and, under NEE, the bounded shadow
queries.  On each query it builds the kernel's inputs with either cull,
checks that the payloads are equal bit for bit, and prints the visits, the
clusters visited by blocks whose every lane is disabled (bound <= 0), and
the device ms of the whole query (cull, sort and kernel) and of the kernel
alone, CUDA events over ``reps`` calls, in rounds of parent, change,
change, parent.  Then it times each frame (host clock, synchronized) the
same way.  The last line is one JSON object with every number beside the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from chip_smoke import event_ms  # noqa: E402
from wc_path_tracer_tpu_torch import RenderConfig  # noqa: E402
from wc_path_tracer_tpu_torch.kernels import build, cluster  # noqa: E402
from wc_path_tracer_tpu_torch.models.procedural import \
    bunny_gltf_scene  # noqa: E402
from wc_path_tracer_tpu_torch.render import golden, sweep  # noqa: E402
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices  # noqa: E402


def load_parent_cull(parent: Path):
    path = parent / "wc_path_tracer_tpu_torch/kernels/cluster.py"
    spec = importlib.util.spec_from_file_location("parent_cluster", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._cull


def capture_queries(scene, mats, cfg):
    """Every cluster_sweep call of one frame -> [(args, kwargs)]."""
    calls = []
    real = cluster.cluster_sweep

    def rec(*args, **kw):
        calls.append(([a.clone() if torch.is_tensor(a) else a
                       for a in args], dict(kw)))
        return real(*args, **kw)

    cluster.cluster_sweep = rec
    try:
        with torch.no_grad():
            golden.render_frame(scene, mats, cfg, 0,
                                intersect_fn=sweep.make_intersect_fn(
                                    scene, cfg))
    finally:
        cluster.cluster_sweep = real
    return calls


def with_cull(cull, fn):
    real = cluster._cull
    cluster._cull = cull
    try:
        return fn()
    finally:
        cluster._cull = real


def block_inputs(args, kw):
    """The kernel's inputs for one query, with the cull now installed."""
    seen = {}

    def keep(*block_args):
        seen["args"] = block_args
        return kernel_of(kw)(*block_args)

    with torch.no_grad():
        cluster.cluster_sweep(*args, **dict(kw, block_fn=keep))
    return seen["args"]


def kernel_of(kw):
    return (cluster.cluster_sweep_mxu_kernel if kw.get("variant") == "mxu"
            else cluster.cluster_sweep_kernel)


def query_record(args, kw, culls, reps, rounds):
    out = {}
    for label, cull in culls.items():
        blk = with_cull(cull, lambda: block_inputs(args, kw))
        nact, rays = blk[0], blk[3]
        visits = torch.zeros_like(nact)
        pay = kernel_of(kw)(*blk, visits=visits)
        dead = ~(rays[..., 6] > 0.0).any(dim=1)
        out[label] = dict(blk=blk, pay=pay, nact=int(nact.sum()),
                          visits=int(visits.sum()),
                          dead_blocks=int(dead.sum()),
                          dead_nact=int(nact[dead].sum()),
                          dead_visits=int(visits[dead].sum()),
                          active_share=float((rays[..., 6] > 0.0)
                                             .float().mean()),
                          query_ms=[], kernel_ms=[])
    a, b = out["parent"], out["change"]
    same = torch.equal(a["pay"], b["pay"])
    if not same:
        raise RuntimeError("the two culls give different payloads")
    order = ["parent", "change", "change", "parent"] * rounds
    for label in order:
        rec = out[label]
        rec["query_ms"].append(with_cull(culls[label], lambda: event_ms(
            lambda: cluster.cluster_sweep(*args, **kw), reps)))
        rec["kernel_ms"].append(event_ms(
            lambda: kernel_of(kw)(*rec["blk"]), reps))
    for rec in out.values():
        del rec["blk"], rec["pay"]
    return out


def frame_ms(scene, mats, cfg, culls, reps, rounds):
    times = {k: [] for k in culls}

    def one():
        with torch.no_grad():
            golden.render_frame(scene, mats, cfg, 0,
                                intersect_fn=sweep.make_intersect_fn(
                                    scene, cfg))

    for label in ["parent", "change", "change", "parent"] * rounds:
        def run():
            one()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                one()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3
        times[label].append(with_cull(culls[label], run))
    return times


def mean(xs):
    return sum(xs) / len(xs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cull_ab: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all()
    culls = {"parent": load_parent_cull(a.parent), "change": cluster._cull}

    bunny, cam = bunny_gltf_scene(device="cuda")
    lit = chip_smoke.lit_bunny_scene()
    mats = camera_matrices(cam, 1.0)
    base = RenderConfig(**chip_smoke.BUNNY)
    cells = [("bunny", bunny, base),
             ("lit bunny nee+mis", lit, base.replace(**chip_smoke.NEE))]
    result = dict(device=smi, reps=a.reps, rounds=a.rounds, cells=[])
    for label, scene, cfg0 in cells:
        for kernel, cfg in (("B1", cfg0),
                            ("B2", cfg0.replace(cluster_kernel="mxu"))):
            calls = capture_queries(scene, mats, cfg)
            nee = cfg.use_nee
            queries = []
            for q, (args, kw) in enumerate(calls):
                kind = ("shadow" if nee and q % 2 else "closest")
                rec = query_record(args, kw, culls, a.reps, a.rounds)
                rec["query"], rec["kind"] = q // (2 if nee else 1), kind
                queries.append(rec)
                p, c = rec["parent"], rec["change"]
                print(f"[cull] {label} {kernel} {kind} {rec['query']}: "
                      f"active {c['active_share']:.4f}; visits "
                      f"{p['visits']} -> {c['visits']} (nact {p['nact']} -> "
                      f"{c['nact']}); all-disabled blocks "
                      f"{c['dead_blocks']} visit {p['dead_visits']} -> "
                      f"{c['dead_visits']}; query "
                      f"{mean(p['query_ms']):.4f} -> "
                      f"{mean(c['query_ms']):.4f} ms, kernel "
                      f"{mean(p['kernel_ms']):.4f} -> "
                      f"{mean(c['kernel_ms']):.4f} ms; payload equal; on "
                      f"{smi}", flush=True)
            frames = frame_ms(scene, mats, cfg, culls, max(1, a.reps // 4),
                              a.rounds)
            print(f"[cull] {label} {kernel} frame: "
                  f"{mean(frames['parent']):.2f} -> "
                  f"{mean(frames['change']):.2f} ms (host clock; parent "
                  f"{frames['parent']}, change {frames['change']}); on {smi}",
                  flush=True)
            result["cells"].append(dict(cell=label, kernel=kernel,
                                        queries=queries, frame_ms=frames))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
