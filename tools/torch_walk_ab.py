#!/usr/bin/env python3
"""Time the port's BVH-walk kernel against a parent checkout's on one CUDA
card, in one process.

    python3 tools/torch_walk_ab.py PARENT_DIR [--reps 20] [--rounds 2]

PARENT_DIR is a checkout of an earlier commit (e.g. ``git archive`` of it
unpacked into a git-ignored directory) whose
``wc_path_tracer_tpu_torch/kernels/csrc/bvh_walk.cu`` exports the C
interface it had before the walk tables: ``wc_bvh_walk(origin, direction,
t_init, bvh_min, bvh_max, bvh_left, bvh_count, indices, vertices,
draw_node_offset, draw_index_offset, draw_vertex_offset, draw_count, t_out,
off_out, counts, rays, draw capacity, max_leaf_tris, stream)``.  It is
compiled with this tree's nvcc flags into this tree's (git-ignored)
kernels/_build/parent/.

The script captures the five BVH-walk queries of one 512 x 512 frame of the
bunny split into draws of at most 8,192 triangles (dispatch "pallas", as
chip_smoke.py does), checks that this tree's kernel and the parent's give
the same (t, off) and per-ray counters on every lane of each, then times
both with CUDA events, ``reps`` launches each, in rounds of parent, change,
change, parent, every lane walked; this tree's kernel also on the live
lanes only.  It prints one line per query, the means, and, last, one JSON
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
from wc_path_tracer_tpu_torch.kernels import build, traversal  # noqa: E402
from wc_path_tracer_tpu_torch.models.procedural import \
    bunny_gltf_scene  # noqa: E402
from wc_path_tracer_tpu_torch.render import golden, wavefront  # noqa: E402
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_ARGTYPES = [_P] * 16 + [_I] * 3 + [_P]


def build_parent(parent: Path):
    """The parent's loaded bvh_walk library, built with this tree's flags."""
    out_dir = build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = parent / "wc_path_tracer_tpu_torch/kernels/csrc/bvh_walk.cu"
    so = out_dir / "libbvh_walk.so"
    proc = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's bvh_walk:\n"
                           f"{proc.stdout}")
    for line in proc.stdout.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  parent bvh_walk: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    lib.wc_bvh_walk.argtypes = PARENT_ARGTYPES
    lib.wc_bvh_walk.restype = _I
    return lib


def parent_walk(lib, mesh):
    def run(o, d, t0, counts=None):
        R = o.shape[0]
        t_out = torch.empty_like(t0)
        off = torch.empty(R, dtype=torch.int32, device=o.device)
        rc = lib.wc_bvh_walk(
            o.data_ptr(), d.data_ptr(), t0.data_ptr(),
            mesh.bvh_min.data_ptr(), mesh.bvh_max.data_ptr(),
            mesh.bvh_left.data_ptr(), mesh.bvh_count.data_ptr(),
            mesh.indices.data_ptr(), mesh.vertices.data_ptr(),
            mesh.draw_node_offset.data_ptr(),
            mesh.draw_index_offset.data_ptr(),
            mesh.draw_vertex_offset.data_ptr(), mesh.draw_count.data_ptr(),
            t_out.data_ptr(), off.data_ptr(),
            counts.data_ptr() if counts is not None else None, R,
            mesh.draw_node_offset.shape[0], mesh.max_leaf_tris,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent bvh_walk launch failed ({rc})")
        return t_out, off
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_walk_ab: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for line in build.build_all(["bvh_walk"]).get("bvh_walk", "") \
            .splitlines():
        if "registers" in line or "spill" in line:
            print(f"  change bvh_walk: {line.strip()}")
    lib = build_parent(a.parent.resolve())

    scene, cam = bunny_gltf_scene(max_blas_tris=8192, device="cuda")
    mesh = scene.mesh
    cfg = RenderConfig(width=512, height=512, samples=1, max_bounces=4,
                       sky="gradient")
    queries = []

    def capture(o, d, t0, mesh, alive=None):
        queries.append([x.clone() for x in (o, d, t0, alive)])
        return traversal.bvh_walk_kernel(o, d, t0, mesh, alive=alive)

    with torch.no_grad():
        golden.render_frame(scene, camera_matrices(cam, 1.0), cfg, 0,
                            intersect_fn=wavefront.make_intersect_fn_pallas(
                                scene, capture))
    parent = parent_walk(lib, mesh)

    def change(o, d, t0, counts=None, alive=None):
        return traversal.bvh_walk_kernel(o, d, t0, mesh, counts, alive=alive)

    result = dict(card=smi, reps=a.reps, rounds=a.rounds,
                  layout=str(traversal.walk_layout()), per_query=[])
    for q, (o, d, t0, alive) in enumerate(queries):
        cc = torch.zeros((o.shape[0], traversal.COUNT_COLS),
                         dtype=torch.int32, device="cuda")
        cp = torch.zeros_like(cc)
        got, want = change(o, d, t0, cc), parent(o, d, t0, cp)
        torch.cuda.synchronize()
        if not (all(torch.equal(x, y) for x, y in zip(got, want))
                and torch.equal(cc, cp)):
            raise RuntimeError(f"bvh_walk query {q}: this tree's kernel and "
                               "the parent's disagree")
        times = dict(parent=[], change=[], change_live=[])
        for _ in range(a.rounds):
            for who in ("parent", "change", "change", "parent"):
                fn = parent if who == "parent" else change
                times[who].append(event_ms(lambda: fn(o, d, t0), a.reps))
            times["change_live"].append(event_ms(
                lambda: change(o, d, t0, alive=alive), a.reps))
        live = float(alive.float().mean())
        result["per_query"].append(dict(query=q, live_share=live, **times))
        print(f"[ab] bvh_walk query {q}: parent "
              + " / ".join(f"{t:.4f}" for t in times["parent"])
              + " ms, change "
              + " / ".join(f"{t:.4f}" for t in times["change"])
              + " ms, change live lanes only "
              + " / ".join(f"{t:.4f}" for t in times["change_live"])
              + f" ms ({live:.4f} live; t, off and counters equal), on {smi}",
              flush=True)
    rows = result["per_query"]
    mean = {who: sum(sum(r[who]) / len(r[who]) for r in rows) / len(rows)
            for who in ("parent", "change", "change_live")}
    result["mean_ms"] = mean
    print(f"[ab] bvh_walk mean over {len(rows)} queries: parent "
          f"{mean['parent']:.4f} ms, change {mean['change']:.4f} ms "
          f"({mean['change'] / mean['parent']:.1%}), change live lanes only "
          f"{mean['change_live']:.4f} ms, on {smi}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
