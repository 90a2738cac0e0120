"""The readings that the limits of ``correct`` are set from, on the card,
at the cell's own size (perfbench/limits/<cell>.json records the limits;
PERF.md the readings).

    python3 -m perfbench.calibrate --workload bunny-train \\
        --seeds 11,12,...  --control-seeds 21,22,23 --faults stale,half \\
        --seconds 4

In one process: the program's numbers on each seed (a short window of
the cell's own loop and its check: the lower reading is their largest);
the control's on each control seed, which is the configuration's
reference computed in bfloat16 put in the program's place (its smallest is
the upper reading);
and each fault of perfbench/faults.py planted under the program.  One
JSON line per reading.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench import check, harness
from perfbench.loops import serve as serve_loop

MASK32 = 0xFFFFFFFF


def program_reading(name, seed, seconds, device, fault=None) -> dict:
    ctx = harness.make_ctx(name, seed, seconds, False, device,
                           harness.process_started(), fault=fault)
    line = harness.run_cell(ctx)
    return {k: c["value"] for k, c in line["checks"].items()} | {
        "attempted": line["attempted"], "failed": line["failed"]}


def control_reading(name, seed, device, overrides=None, bench=None) -> dict:
    """The bfloat16 reference against the float32 one on the samples a run
    of ``seed`` would check (training: its first steps' frames; serving:
    the frames after 1 and after the most accumulated frames)."""
    ctx = harness.make_ctx(name, seed, 0, False, device, 0.0,
                           overrides=overrides, bench=bench)
    r, tr = ctx.render, ctx.traffic
    reference = ctx.reference
    ref = reference.prepare(ctx.raw, device)
    low = reference.prepare(ctx.raw, device, torch.bfloat16)
    numbers = []
    with reference.exact_matmuls():
        if tr["kind"] == "train":
            base = harness.frame_base(seed)
            for i in range(tr["check_steps"]):
                f = (base + i) & MASK32
                rl, rg = reference.loss_grad(ref, r, f)
                cl, cg = reference.loss_grad(low, r, f)
                numbers.append(check.train_numbers(
                    cl, {k: g.float() for k, g in cg.items()}, rl, rg))
        else:
            edits = serve_loop.schedule(tr, seed, ctx.raw["camera"])
            mi, post = tr["edit_material"], tr["post"]
            albedo, _ = edits(0)
            _, camera = edits(tr["orbit_frames"])
            for count in (1, tr["cycle"] - tr["orbit_frames"]):
                hdr, u8 = serve_loop.replay(reference, ref, r, post, mi,
                                            albedo, camera, count)
                c_hdr, c_u8 = serve_loop.replay(reference, low, r, post, mi,
                                                albedo, camera, count)
                numbers.append(check.serve_numbers(c_hdr.float(), c_u8.cpu(),
                                                   hdr, u8))
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        print(json.dumps({"reading": "program", "seed": seed}
                         | program_reading(args.workload, seed, args.seconds,
                                           device)), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        print(json.dumps({"reading": "control", "seed": seed}
                         | control_reading(args.workload, seed, device)),
              flush=True)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
            print(json.dumps({"reading": f"fault:{fault}", "seed": seed}
                             | program_reading(args.workload, seed,
                                               args.seconds, device, fault)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
