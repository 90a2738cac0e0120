#!/usr/bin/env python3
"""Time the port's two cluster-sweep kernels against a parent checkout's on
one CUDA card, in one process.

    python3 tools/torch_sweep_ab.py PARENT_DIR [--reps 20] [--rounds 2]

PARENT_DIR is a checkout of an earlier commit (e.g. ``git archive`` of it
unpacked into a git-ignored directory) whose
``wc_path_tracer_tpu_torch/kernels/csrc/cluster_sweep{,_mxu}.cu`` export
the C interface they had before the shared sweep skeleton:
``wc_cluster_sweep(nact, clist, bt0, order, rays, prev, tris, out, visits,
blocks, ray_block, clusters, ctas, groups, stream)`` and
``wc_cluster_sweep_mxu(nact, clist, bt0, rays, prev, trisW, mat_tbl, out,
visits, blocks, ray_block, clusters, stream)``.  Both are compiled with this
tree's nvcc flags into this tree's (git-ignored) kernels/_build/parent/.

The script captures one 512 x 512 bunny frame's five sweep queries for each
kernel (as chip_smoke.py does), checks that this tree's kernel and the
parent's give the same payload and visits on each, then times them with CUDA
events, ``reps`` launches each, in rounds of parent, change, change, parent.
It prints one line per query and kernel, the means, and, last, one JSON
object with every number beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from wc_path_tracer_tpu_torch import RenderConfig  # noqa: E402
from wc_path_tracer_tpu_torch.kernels import build, cluster  # noqa: E402
from wc_path_tracer_tpu_torch.models.procedural import \
    bunny_gltf_scene  # noqa: E402
from wc_path_tracer_tpu_torch.render import golden, sweep  # noqa: E402
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {
    "cluster_sweep": ("wc_cluster_sweep", [_P] * 9 + [_I] * 5 + [_P]),
    "cluster_sweep_mxu": ("wc_cluster_sweep_mxu", [_P] * 9 + [_I] * 3 + [_P]),
}


def build_parent(parent: Path):
    """{name: loaded parent library}, built with this tree's flags."""
    out_dir = build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for name in PARENT_SIGNATURES:
        src = parent / "wc_path_tracer_tpu_torch/kernels/csrc" / f"{name}.cu"
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  parent {name}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        fn, argtypes = PARENT_SIGNATURES[name]
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
        libs[name] = lib
    return libs


def parent_mt(lib):
    def run(nact, clist, bt0, rays, prev, tris, visits=None):
        RB, B, _ = rays.shape
        out = torch.empty_like(prev)
        order = torch.argsort(nact, descending=True, stable=True) \
            .to(torch.int32)
        rc = lib.wc_cluster_sweep(
            nact.data_ptr(), clist.data_ptr(), bt0.data_ptr(),
            order.data_ptr(), rays.data_ptr(), prev.data_ptr(),
            tris.data_ptr(), out.data_ptr(),
            visits.data_ptr() if visits is not None else None, RB, B,
            tris.shape[0] // cluster.CLUSTER_ROWS, cluster.SWEEP_CTAS,
            cluster.SWEEP_GROUPS, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent cluster_sweep launch failed ({rc})")
        return out
    return run


def parent_mxu(lib):
    def run(nact, clist, bt0, rays, prev, trisW, mat_tbl, visits=None):
        RB, B, _ = rays.shape
        out = torch.empty_like(prev)
        rc = lib.wc_cluster_sweep_mxu(
            nact.data_ptr(), clist.data_ptr(), bt0.data_ptr(),
            rays.data_ptr(), prev.data_ptr(), trisW.data_ptr(),
            mat_tbl.data_ptr(), out.data_ptr(),
            visits.data_ptr() if visits is not None else None, RB, B,
            trisW.shape[0] // cluster.MXU_ROWS,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent cluster_sweep_mxu launch failed ({rc})")
        return out
    return run


def event_ms(fn, reps):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture(scene, mats, cfg, kernel):
    queries = []

    def fn(*args):
        queries.append([x.clone() for x in args])
        return kernel(*args)

    with torch.no_grad():
        golden.render_frame(scene, mats, cfg, 0, intersect_fn=sweep
                            .make_intersect_fn(scene, cfg, block_fn=fn))
    return queries


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sweep_ab: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name, log in build.build_all().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  change {name}: {line.strip()}")
    parent = build_parent(a.parent.resolve())

    scene, cam = bunny_gltf_scene(device="cuda")
    mats = camera_matrices(cam, 1.0)
    cfg = RenderConfig(width=512, height=512, samples=1, max_bounces=4,
                       sky="gradient")
    kernels = {
        "cluster_sweep": (cfg, cluster.cluster_sweep_kernel,
                          parent_mt(parent["cluster_sweep"])),
        "cluster_sweep_mxu": (cfg.replace(cluster_kernel="mxu"),
                              cluster.cluster_sweep_mxu_kernel,
                              parent_mxu(parent["cluster_sweep_mxu"])),
    }
    result = dict(card=smi, reps=a.reps, rounds=a.rounds, kernels={})
    for name, (kcfg, change, par) in kernels.items():
        queries = capture(scene, mats, kcfg, change)
        rows = []
        for q, args in enumerate(queries):
            RB = args[0].shape[0]
            vc = torch.zeros(RB, dtype=torch.int32, device="cuda")
            vp = torch.zeros_like(vc)
            same = torch.equal(change(*args, vc), par(*args, vp))
            torch.cuda.synchronize()
            if not (same and torch.equal(vc, vp)):
                raise RuntimeError(f"{name} query {q}: this tree's kernel and "
                                   "the parent's disagree")
            times = dict(parent=[], change=[])
            for _ in range(a.rounds):
                for who in ("parent", "change", "change", "parent"):
                    fn = par if who == "parent" else change
                    times[who].append(event_ms(lambda: fn(*args), a.reps))
            rows.append(dict(query=q, **times))
            print(f"[ab] {name} query {q}: parent "
                  + " / ".join(f"{t:.3f}" for t in times["parent"])
                  + " ms, change "
                  + " / ".join(f"{t:.3f}" for t in times["change"])
                  + f" ms (payload and visits equal), on {smi}", flush=True)
        mean = {who: sum(sum(r[who]) / len(r[who]) for r in rows) / len(rows)
                for who in ("parent", "change")}
        print(f"[ab] {name} mean over {len(rows)} queries: parent "
              f"{mean['parent']:.3f} ms, change {mean['change']:.3f} ms "
              f"({mean['change'] / mean['parent']:.1%}), on {smi}", flush=True)
        result["kernels"][name] = dict(per_query=rows, mean_ms=mean)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
