#!/usr/bin/env python3
"""What binds the BVH-walk kernel: coherence probes on one CUDA card.

    python3 tools/torch_walk_probe.py [--reps 20]

Captures the five BVH-walk queries of one 512 x 512 frame of the bunny split
into draws of at most 8,192 triangles (dispatch "pallas", as chip_smoke.py
does) and times the shipped kernel's device time (torch.profiler, the
kernel alone) on each query in three orders of the same work:

- "pixel": the rays as the frame gives them (the shipped path);
- "one ray per warp": every 32nd ray copied into 32 lanes, so each warp
  walks one ray (no divergence of control or addresses inside a warp; the
  same number of lanes and the same distribution of walks);
- "work-sorted": the rays sorted by the twin's counters (inner nodes
  entered plus triangles tested), so a warp's lanes take similar work but
  come from all over the image.

It also prints, from the twin's counters, each query's warp efficiency of
inner steps in pixel order (mean over 32-lane batches of the lanes' inner
nodes entered over 32 times the batch's most) and the most inner nodes any
ray enters.  The last line is one JSON object with every number beside the
card's name and power limit.  Every order gives each ray the twin's result;
the script checks that before it times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from wc_path_tracer_tpu_torch import RenderConfig  # noqa: E402
from wc_path_tracer_tpu_torch.kernels import build, traversal  # noqa: E402
from wc_path_tracer_tpu_torch.models.procedural import \
    bunny_gltf_scene  # noqa: E402
from wc_path_tracer_tpu_torch.render import golden, wavefront  # noqa: E402
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices  # noqa: E402


def device_ms(fn, reps):
    """Mean device time of the BVH-walk kernel per call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "bvh_walk_kernel" in e.key) / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_walk_probe: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all(["bvh_walk"])
    scene, cam = bunny_gltf_scene(max_blas_tris=8192, device="cuda")
    mesh = scene.mesh
    cfg = RenderConfig(width=512, height=512, samples=1, max_bounces=4,
                       sky="gradient")
    queries = []

    def capture(o, d, t0, mesh, alive=None):
        queries.append([x.clone() for x in (o, d, t0)])
        return traversal.bvh_walk_kernel(o, d, t0, mesh, alive=alive)

    with torch.no_grad():
        golden.render_frame(scene, camera_matrices(cam, 1.0), cfg, 0,
                            intersect_fn=wavefront.make_intersect_fn_pallas(
                                scene, capture))
    result = dict(card=smi, reps=a.reps, per_query=[])
    for q, (o, d, t0) in enumerate(queries):
        R = o.shape[0]
        counts = torch.zeros((R, traversal.COUNT_COLS), dtype=torch.int32,
                             device="cuda")
        t_p, off_p = traversal.bvh_walk_plain(o, d, t0, mesh, counts)
        inner = counts[:, 1].double().view(-1, 32)
        eff = float(inner.sum() / (32 * inner.amax(1).sum()))
        orders = {
            "pixel": torch.arange(R, device="cuda"),
            "one ray per warp": torch.arange(0, R, 32, device="cuda")
            .repeat_interleave(32),
            "work-sorted": torch.argsort(counts[:, 1] + counts[:, 2],
                                         stable=True)}
        ms = {}
        for name, idx in orders.items():
            oi, di, ti = (x[idx].contiguous() for x in (o, d, t0))
            t_k, off_k = traversal.bvh_walk_kernel(oi, di, ti, mesh)
            torch.cuda.synchronize()
            if not (torch.equal(t_k, t_p[idx]) and torch.equal(off_k,
                                                               off_p[idx])):
                raise RuntimeError(f"query {q}, {name}: the kernel's result "
                                   "differs from the twin's")
            ms[name] = device_ms(lambda: traversal.bvh_walk_kernel(
                oi, di, ti, mesh), a.reps)
        rec = dict(query=q, device_ms=ms, warp_efficiency_inner=eff,
                   inner_mean=float(counts[:, 1].double().mean()),
                   inner_max=int(counts[:, 1].max()))
        result["per_query"].append(rec)
        print(f"[probe] bvh_walk query {q}: device ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f"; warp efficiency of inner steps {eff:.3f}; inner nodes "
              f"entered mean {rec['inner_mean']:.2f}, max {rec['inner_max']}"
              f", on {smi}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
