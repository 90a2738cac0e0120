#!/usr/bin/env python3
"""Time a 3xTF32 tensor-core form of the plane-form sweep (B2) against the
port's CUDA-core kernel on one CUDA card.

    python3 tools/mxu_tf32_probe.py [--reps 20]

A measurement probe, not part of the port (tools/mxu_tf32_probe.cu says
how it computes).  It captures the five sweep queries of one 512 x 512
bunny frame under ``cluster_kernel="mxu"`` (as chip_smoke.py does), splits
the plane-form slabs into TF32 hi/lo fragments, and per query runs the
probe, the port's B2 (``cluster_sweep_mxu_kernel``) and the MT kernel
(B1).  It holds the probe to B2's gate against MT -- hits equal MT's on
every ray, |dt| <= 5e-5 t on primary rays and <= 5e-5 max(t, 1) on bounce
rays -- and times probe and B2 with CUDA events in rounds of probe, B2,
B2, probe.  The last line is one JSON object with every number beside the
card's name and power limit.
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

from torch_sweep_ab import capture, event_ms  # noqa: E402

from wc_path_tracer_tpu_torch import RenderConfig  # noqa: E402
from wc_path_tracer_tpu_torch.kernels import build, cluster  # noqa: E402
from wc_path_tracer_tpu_torch.models.procedural import \
    bunny_gltf_scene  # noqa: E402
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices  # noqa: E402

PLANE_T_RTOL = 5e-5
SOURCE = Path(__file__).resolve().parent / "mxu_tf32_probe.cu"


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero (cvt.rna.tf32.f32), kept in float32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def probe_fragments(trisW):
    """(C, 32, 3, 32, 4) f32: for cluster c, slot quad s, n-tile j and lane
    (g, q) = (lane // 4, lane % 4) the B fragment (rows q and q + 4, column
    g: slot 4s + g // 2, field 2j + g % 2) as (hi0, hi1, lo0, lo1)."""
    W = trisW.view(-1, cluster.MXU_ROWS, cluster.MXU_FIELDS,
                   cluster.CLUSTER_TRIS)
    dev = trisW.device
    lane = torch.arange(32, device=dev)
    g, q = lane // 4, lane % 4
    s = torch.arange(32, device=dev)[:, None, None]
    j = torch.arange(3, device=dev)[None, :, None]
    slot = 4 * s + (g // 2)[None, None, :]
    field = 2 * j + (g % 2)[None, None, :]
    k = q[None, None, :]
    b0, b1 = W[:, k, field, slot], W[:, k + 4, field, slot]
    h0, h1 = tf32(b0), tf32(b1)
    return torch.stack([h0, h1, tf32(b0 - h0), tf32(b1 - h1)], -1) \
        .contiguous()


def gate(got, mt, primary):
    """B2's gate against the MT kernel -> (passed, hits that differ, max
    |dt| / t, max |dt| / max(t, 1))."""
    hk, hm = got[..., 11] >= 0, mt[..., 11] >= 0
    both = hk & hm
    dt = (got[..., 0] - mt[..., 0]).abs()[both]
    t_mt = mt[..., 0][both]
    rel = float((dt / t_mt).max()) if dt.numel() else 0.0
    rel1 = float((dt / t_mt.clamp_min(1.0)).max()) if dt.numel() else 0.0
    differ = int((hk != hm).sum())
    return (differ == 0 and (rel if primary else rel1) <= PLANE_T_RTOL,
            differ, rel, rel1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("mxu_tf32_probe: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all(["cluster_sweep", "cluster_sweep_mxu"])
    so = build.BUILD_DIR / "probe" / "libmxu_tf32_probe.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
                          str(SOURCE)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for the probe:\n{res.stdout}"
                           f"{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  probe: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    lib.wc_mxu_tf32_probe.argtypes = [ctypes.c_void_p] * 9 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.wc_mxu_tf32_probe.restype = ctypes.c_int

    scene, cam = bunny_gltf_scene(device="cuda")
    mats = camera_matrices(cam, 1.0)
    cfg = RenderConfig(width=512, height=512, samples=1, max_bounces=4,
                       sky="gradient", cluster_kernel="mxu")
    b2 = cluster.cluster_sweep_mxu_kernel
    queries = capture(scene, mats, cfg, b2)
    tris_mt = cluster.build_cluster_tables(scene.mesh)[0]
    frags = probe_fragments(queries[0][5])

    rows = []
    for q, args in enumerate(queries):
        nact, clist, bt0, rays, prev, trisW, mat_tbl = args
        RB, B, _ = rays.shape
        order = torch.argsort(nact, descending=True, stable=True) \
            .to(torch.int32)

        def probe():
            out = torch.empty_like(prev)
            rc = lib.wc_mxu_tf32_probe(
                nact.data_ptr(), clist.data_ptr(), bt0.data_ptr(),
                order.data_ptr(), rays.data_ptr(), prev.data_ptr(),
                frags.data_ptr(), mat_tbl.data_ptr(), out.data_ptr(), RB, B,
                trisW.shape[0] // cluster.MXU_ROWS,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"probe launch failed ({rc})")
            return out

        got, want = probe(), b2(*args)
        mt = cluster.cluster_sweep_kernel(*args[:5], tris_mt)
        torch.cuda.synchronize()
        ok, differ, rel, rel1 = gate(got, mt, q == 0)
        b2_ok = gate(want, mt, q == 0)[0]
        times = dict(probe=[], b2=[])
        for who in ("probe", "b2", "b2", "probe"):
            fn = probe if who == "probe" else (lambda: b2(*args))
            times[who].append(event_ms(fn, a.reps))
        row = dict(query=q, probe_ms=times["probe"], b2_ms=times["b2"],
                   gate_passed=ok, b2_gate_passed=b2_ok,
                   hits_differ_from_mt=differ, max_rel_dt_vs_mt=rel,
                   max_dt_over_max_t_1=rel1,
                   slots_equal_b2=float((got[..., 11] == want[..., 11])
                                        .float().mean()))
        rows.append(row)
        print(f"[tf32] query {q}: probe "
              + " / ".join(f"{t:.3f}" for t in times["probe"])
              + " ms, B2 " + " / ".join(f"{t:.3f}" for t in times["b2"])
              + f" ms; MT gate {'passed' if ok else 'FAILED'} (hits differ "
              f"on {differ} rays, max |dt|/t {rel:.3g}, max |dt|/max(t, 1) "
              f"{rel1:.3g}); slot ids equal B2's on "
              f"{row['slots_equal_b2']:.6f} of rays, on {smi}", flush=True)
    mean = {k: sum(sum(r[k]) / len(r[k]) for r in rows) / len(rows)
            for k in ("probe_ms", "b2_ms")}
    print(f"[tf32] mean over {len(rows)} queries: probe "
          f"{mean['probe_ms']:.3f} ms, B2 {mean['b2_ms']:.3f} ms; MT gate "
          f"passed on {sum(r['gate_passed'] for r in rows)} of {len(rows)} "
          f"queries, on {smi}", flush=True)
    print(json.dumps(dict(card=smi, reps=a.reps, per_query=rows,
                          mean_ms=mean)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
