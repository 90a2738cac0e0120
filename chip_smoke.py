#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch twin at the main path's shapes, and drives three render paths
of the 512 x 512 glTF bunny, 4 progressive frames each, every one of which
must go through its kernel 5 times per frame:

- dispatch "auto" -> the cluster sweep (kernels/csrc/cluster_sweep.cu);
- dispatch "pallas" on the bunny split into draws of at most 8,192
  triangles -> the BVH walk (kernels/csrc/bvh_walk.cu);
- the cluster sweep with cluster_kernel="mxu" -> the plane-form sweep
  (kernels/csrc/cluster_sweep_mxu.cu).

Both cluster sweeps must equal their twins bit for bit (payload and
visits) on their frame's five queries, on a seeded tie-heavy query, on a
seeded signed-zero query (exact zeros in the plane form's fields), on the
primary query re-culled at ray_block 2048 (and, for the plane form, 8192 and
16384) and on its first 65,536 rays as one ray block of 65,536, under the
wrapper's thread layout and under every layout each is timed in; per query
they print the active clusters and visits per ray block and the long pole
(the heaviest block launched alone), and the plane form the share of
(warp, slot step) pairs that pass each of its two warp votes.
The BVH walk must equal its twin bit for bit (t, offset and the per-ray
counters) on its frame's five queries, on the unsplit bunny and on seeded
tie-heavy and signed-zero banks, under every build it is timed in, walking
every lane and only the transport's live lanes; its frame walking live
lanes only must equal the frame walking every lane.  Per query it prints
the time walking every lane and the live lanes only, the bound, the nodes
and triangles each ray visits, and the time of each build.
It also renders the 1024 x 1024 Cornell box through the brute-force path
and the plain "wavefront" BVH walks at 64 x 64, checks the images, and
prints times beside the card's name and power limit.  The last two lines of
standard output are a JSON line describing every ported kernel and
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero and prints no result.  It fails without a CUDA card and
outside the repository (the port's package must be importable).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from wc_path_tracer_tpu_torch import RenderConfig
from wc_path_tracer_tpu_torch.kernels import build, cluster, traversal
from wc_path_tracer_tpu_torch.models.builtin import cornell_box_scene
from wc_path_tracer_tpu_torch.models.procedural import (bunny_gltf_scene,
                                                         signed_zero_query,
                                                         tie_heavy_query)
from wc_path_tracer_tpu_torch.render import dispatch, golden, sweep, wavefront
from wc_path_tracer_tpu_torch.scene.camera import camera_matrices

H100_FP32_FLOPS = 67e12      # FP32 non-tensor peak, H100 SXM at 700 W
H100_HBM_BYTES = 3.35e12     # HBM3 bytes/s, H100 SXM
OPS_PER_TEST = 54            # FP32 ops per ray x triangle test (cluster_sweep.cu)
# The bounds count the operations each function needs, not those its kernel
# happens to issue.  Plane form, per ray x slot: Q, Bu, Bv read d only (3
# multiplies + 2 adds each), P, Au, Av read o and the constant 1 (3 + 3
# each), t = -P (1 / Q) 3, u and v 2 each, u + v 1, 5 compares.
OPS_PER_PLANE_TEST = 46
# BVH walk: one slab test per node reached (6 subtractions, 6 multiplies,
# 10 min/max), computed with its siblings at the parent's entry (the roots,
# once per ray and draw); at each pop only the 3 enter compares are new.
OPS_PER_SLAB = 22
OPS_PER_POP = 3
OPS_PER_INNER = 2 * OPS_PER_SLAB + 3   # the children's slabs + the choice
PLANE_T_RTOL = 5e-5          # B2 vs MT t: see mxu_phase
# sweep layouts timed against each other: (CTAs per ray block, threads per
# ray), for B1 and for B2
LAYOUTS = [(1, 1), (2, 2), (2, 4), (4, 2), (4, 4), (8, 4)]
BUNNY = dict(width=512, height=512, samples=1, max_bounces=4, sky="gradient")
CORNELL = dict(width=1024, height=1024, samples=1, max_bounces=4,
               sky="gradient")


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")
    print(f"  ok: {what}", flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps):
    """Mean device ms of ``fn`` over ``reps`` runs (CUDA events), after one
    warm-up run."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(smi, label, fn, top=12):
    """Profile one call: wall ms (host clock, profiler on), the summed device
    time of its CUDA kernels, and the kernels taking the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if not rows:
        print(f"[profile] {label}: the profiler recorded no device events "
              "(device busy share not measured)", flush=True)
    print(f"[profile] {label}: wall {wall * 1e3:.2f} ms (profiler on), kernels "
          f"{device_ms:.2f} ms = {device_ms / (wall * 1e3):.1%} busy, "
          f"{sum(r[2] for r in rows)} launches, on {smi}", flush=True)
    for key, ms, n in rows[:top]:
        print(f"  {ms:9.3f} ms {n:5d}x  {key[:100]}")
    return dict(wall_ms=wall * 1e3, device_ms=device_ms,
                launches=sum(r[2] for r in rows),
                top=[dict(kernel=k[:100], ms=ms, count=n)
                     for k, ms, n in rows[:top]])


def image_agreement(a, b, tol):
    """Fraction of pixels whose largest channel difference is <= tol."""
    return float(((a - b).abs().amax(dim=-1) <= tol).float().mean())


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def bound(ops, nb):
    """(bound ms, what bounds it) for ``ops`` FP32 operations and ``nb``
    bytes moved, at the H100's published peaks."""
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    bytes_ms = nb / H100_HBM_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms \
        else "bytes"


def serve(scene, mats, cfg, frame_fn):
    """4 progressive frames through ``frame_fn`` (None: dispatch "auto") ->
    (image, ms per frame, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        img = None
        with torch.no_grad():
            for f in range(4):
                img = golden.render_step(scene, mats, cfg, f, img,
                                         frame_fn=frame_fn)
        return img

    image, s = sync_time(run)
    return image, s / 4 * 1e3, torch.cuda.max_memory_allocated() / 2**30


def check_image(image, what):
    mean = float(image.mean())
    check(bool(torch.isfinite(image).all()) and image.shape == (512, 512, 3),
          f"{what} image is finite, 512 x 512 x 3")
    check(0.05 < mean < 3.0, f"{what} image mean {mean:.4f} is plausible")


def spread(x):
    """mean, p90 and max of a per-block count."""
    xf = x.float()
    return dict(mean=float(xf.mean()), p90=float(torch.quantile(xf, 0.9)),
                max=int(x.max()))


def primary_rays(query):
    """(origin, direction, t_init) of a captured sweep query's rays."""
    rays, prev = query[3].view(-1, 16), query[4].view(-1, 16)
    return (rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous(),
            prev[:, 0].contiguous())


def sweep_fns(mxu):
    """(kernel wrapper, plain twin) of B2 (``mxu``) or B1."""
    if mxu:
        return cluster.cluster_sweep_mxu_kernel, cluster.cluster_sweep_mxu_plain
    return cluster.cluster_sweep_kernel, cluster.cluster_sweep_plain


def sweep_both(query, ray_block):
    """One cluster_sweep of ``query`` (origin, direction, t_init, then the
    tables: tris, cmin, cmax for B1; trisW, cmin, cmax, mat_tbl for B2)
    whose block sweep runs the kernel and its plain twin on the same inputs
    -> (kernel payload, twin payload, kernel visits, twin visits, nact)."""
    mxu = len(query) == 7
    kernel, plain = sweep_fns(mxu)
    seen = {}

    def both(*args):
        vk = torch.zeros_like(args[0])
        vp = torch.zeros_like(args[0])
        seen.update(k=kernel(*args, vk), p=plain(*args, vp), vk=vk, vp=vp,
                    nact=args[0])
        return seen["k"]

    kw = dict(variant="mxu", mat_tbl=query[6]) if mxu else {}
    with torch.no_grad():
        cluster.cluster_sweep(*query[:6], ray_block=ray_block, block_fn=both,
                              **kw)
    torch.cuda.synchronize()
    return seen["k"], seen["p"], seen["vk"], seen["vp"], seen["nact"]


def sweep_parity(q, k, p, vk, vp, nact, kind=""):
    """A kernel's payload and visits against its twin's, printed as one
    record (``kind`` "mxu " for B2)."""
    rec = dict(query=q, bitwise=bool(torch.equal(k, p)),
               max_abs_err=float((k - p).abs().max()),
               visits_equal=bool(torch.equal(vk, vp)),
               visits=int(vk.sum()), nact=int(nact.sum()),
               hits=int((p[..., 11] >= 0).sum()))
    print(f"[parity] {kind}query {q}: {json.dumps(rec)}", flush=True)
    return rec


def extra_parity(cases, kind=""):
    """Kernel vs twin, bitwise in payload and visits, on each (label, query,
    ray_block) -> {label: record}."""
    extra = {}
    for label, query, rb in cases:
        k, p, vk, vp, nact = sweep_both(query, rb)
        rec = sweep_parity(label, k, p, vk, vp, nact, kind)
        rec.update(ray_block=rb, layout=cluster.sweep_layout(rb))
        extra[label] = rec
        check(rec["bitwise"] and rec["visits_equal"],
              f"{kind}{label} query (ray_block {rb}): payload and visits "
              "equal the plain twin's bit for bit")
    return extra


def layout_ms(args, want, want_visits, mxu=False):
    """A sweep kernel's ms per launch on one query under each layout of
    LAYOUTS (CTAs per ray block, threads per ray), the wrapper's choice
    replaced for the call -> ({layout: ms}, whether every layout's payload
    and visits equal ``want`` and ``want_visits``)."""
    kernel = sweep_fns(mxu)[0]
    chosen, out, same = cluster.sweep_layout, {}, True
    try:
        for lay in LAYOUTS:
            cluster.sweep_layout = lambda B, lay=lay: lay + (1,)
            visits = torch.zeros_like(args[0])
            got = kernel(*args, visits)
            torch.cuda.synchronize()
            same = same and bool(torch.equal(got, want)
                                 and torch.equal(visits, want_visits))
            out[f"{lay[0]}x{lay[1]}"] = event_ms(lambda: kernel(*args), 20)
    finally:
        cluster.sweep_layout = chosen
    return out, same


def long_pole(args, visits, mxu=False):
    """(ms per visit, ms) of the heaviest ray block launched alone: its ms
    per visit times the most visits of the query is what the launch would
    take if that block alone bound it."""
    kernel = sweep_fns(mxu)[0]
    b = int(torch.argmax(visits))
    alone = event_ms(lambda: kernel(*(x[b:b + 1] for x in args[:5]),
                                    *args[5:]), 20)
    per_visit = alone / int(visits[b])
    return per_visit, int(visits.max()) * per_visit


def print_visits(kind, q, rec, RB, C, ms, smi, default):
    na, vi = rec["nact_per_block"], rec["visits_per_block"]
    print(f"[visits] {kind}query {q}: nact per block mean {na['mean']:.1f} "
          f"p90 {na['p90']:.0f} max {na['max']}; visits per block mean "
          f"{vi['mean']:.1f} p90 {vi['p90']:.0f} max {vi['max']}; "
          f"{rec['blocks_visiting_half']} of {RB} blocks visit >= half "
          f"of {C} clusters; long pole {rec['long_pole_ms']:.3f} ms = "
          f"{vi['max']} visits x {rec['ms_per_visit_alone'] * 1e3:.2f} us "
          f"per visit (heaviest block alone), launch {ms:.3f} ms", flush=True)
    print(f"[layouts] {kind}query {q}: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in rec["layouts_ms"].items())
        + f" (CTAs x threads per ray; default {default}), on {smi}",
        flush=True)


def sm_clock(fn, reps=500):
    """nvidia-smi's SM clock, its maximum and the power draw, read while
    ``fn`` runs ``reps`` times back to back."""
    for _ in range(reps):
        fn()
    read = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.cuda.synchronize()
    return read


def mean_entry(per_query):
    """ms, plain_ms and bound_ms averaged over one frame's queries."""
    n = len(per_query)
    ms_b = sum(r["bound_ms"] for r in per_query) / n
    by = [r["bound_by"] for r in per_query]
    return dict(ms=sum(r["ms"] for r in per_query) / n,
                plain_ms=sum(r["plain_ms"] for r in per_query) / n,
                bound_ms=ms_b, bound_by=max(set(by), key=by.count))


def walk_layouts():
    """The B3 builds timed against each other: {name: traversal.WalkLayout};
    "grid local" (one thread per ray in blockIdx order, the stack in local
    memory) is the baseline, the shipped layout one of the others."""
    base = traversal.walk_layout()
    out = {f"{sched} {'smem' if shared else 'local'}": traversal.WalkLayout(
        schedule=sched, shared_stack=shared)
        for sched in traversal.SCHEDULES for shared in (False, True)}
    out.update({"top 6": dataclasses.replace(base, top_levels=6),
                "top 8": dataclasses.replace(base, top_levels=8),
                "reorder": dataclasses.replace(base, reorder=True)})
    return out


def walk_expected(twin, t0, alive):
    """The twin's (t, off, counts) over every lane, as a walk of only the
    lanes of ``alive`` must give them (dead lanes: t_init, -1, 0)."""
    tp, op, cp = twin
    if alive is None:
        return tp, op, cp
    return (torch.where(alive, tp, t0), torch.where(alive, op, -1),
            torch.where(alive[:, None], cp, 0))


def walk_same(query, mesh, twin, layouts):
    """B3 against its twin, bitwise in t, off and the counters, on every
    lane and on the live lanes only, under each layout of ``layouts``
    ({name: WalkLayout}) -> {name: bool}."""
    o, d, t0, alive = query
    chosen, out = traversal.walk_layout, {}
    try:
        for name, lay in layouts.items():
            traversal.walk_layout = lambda lay=lay: lay
            same = True
            for mask in (None, alive):
                ck = torch.full_like(twin[2], 7)
                tk, ok = traversal.bvh_walk_kernel(o, d, t0, mesh, ck,
                                                   alive=mask)
                torch.cuda.synchronize()
                want = walk_expected(twin, t0, mask)
                same = same and all(torch.equal(a, b) for a, b in
                                    zip((tk, ok, ck), want))
            out[name] = same
    finally:
        traversal.walk_layout = chosen
    return out


def walk_twin(query, mesh):
    """The twin over every lane -> ((t, off, counts), device ms of the one
    run, CUDA events)."""
    o, d, t0, _ = query
    counts = torch.zeros((o.shape[0], traversal.COUNT_COLS),
                         dtype=torch.int32, device="cuda")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    tp, op = traversal.bvh_walk_plain(o, d, t0, mesh, counts)
    end.record()
    torch.cuda.synchronize()
    return (tp, op, counts), start.elapsed_time(end)


def pallas_phase(smi, cfg, unsplit, ptxas):
    """The "pallas" path: the kernel's tables, capture (with the transport's
    alive masks), parity under every layout with and without the masks (the
    five queries, the unsplit bunny ``unsplit``, seeded tie-heavy and
    signed-zero banks), times per layout, serving, frames.  Returns the
    kernel's JSON entry and the split scene."""
    scene, cam = bunny_gltf_scene(max_blas_tris=8192, device="cuda")
    mats = camera_matrices(cam, 1.0)
    m = scene.mesh
    nd = int(m.draw_count)
    check(nd >= 3, f"the split bunny has {nd} draws (>= 3)")
    tables, tables_s = sync_time(lambda: traversal.walk_tables(m))
    print(f"[pallas] walk tables: {tables.nodes.shape[0]} node records, "
          f"{tables.tris.shape[0]} triangle records, {nd} draw records, "
          f"built in {tables.build_s * 1e3:.1f} ms (first walk of the bank), "
          f"on {smi}", flush=True)
    frame_fn = dispatch.get_render_frame("pallas", scene, cfg)
    check(frame_fn is wavefront.render_frame_pallas,
          "dispatch 'pallas' picks the BVH-walk kernel path")
    queries = []

    def capture(o, d, t_init, mesh, alive=None):
        queries.append([x.clone() for x in (o, d, t_init, alive)])
        return traversal.bvh_walk_kernel(o, d, t_init, mesh, alive=alive)

    with torch.no_grad():
        golden.render_frame(scene, mats, cfg, 0, intersect_fn=wavefront
                            .make_intersect_fn_pallas(scene, capture))
    check(len(queries) == cfg.max_bounces + 1,
          f"one frame makes {cfg.max_bounces + 1} BVH-walk queries, each "
          "with the transport's alive mask")
    R = queries[0][0].shape[0]
    layouts = walk_layouts()
    print(f"[pallas] {nd} draws, {m.bvh_left.shape[0]} node slots, tree "
          f"depth {tables.depth}, {R} rays per query; layout "
          f"{traversal.walk_layout()}", flush=True)

    parity, per_query, layouts_same = [], [], True
    for q, query in enumerate(queries):
        o, d, t0, alive = query
        twin, plain = walk_twin(query, m)
        tp, op, cp = twin
        ck = torch.zeros_like(cp)
        tk, ok = traversal.bvh_walk_kernel(o, d, t0, m, ck)
        torch.cuda.synchronize()
        same = walk_same(query, m, twin, layouts)
        layouts_same = layouts_same and all(same.values())
        live = int(alive.sum())
        rec = dict(query=q, bitwise=bool(torch.equal(tk, tp)
                                         and torch.equal(ok, op)),
                   counts_equal=bool(torch.equal(ck, cp)),
                   max_abs_err=float((tk - tp).abs().max()),
                   bitwise_every_layout_with_and_without_mask=same,
                   hits=int((op >= 0).sum()), live=live)
        parity.append(rec)
        print(f"[parity] pallas query {q}: {json.dumps(rec)}", flush=True)
        check(rec["bitwise"] and rec["counts_equal"] and all(same.values()),
              f"pallas query {q}: t, off and counters equal the twin's bit "
              "for bit under every layout, on every lane and on the "
              f"{live} live lanes")
        pops, inner, tests = (int(x) for x in cp.long().sum(0))
        ops = (R * nd * OPS_PER_SLAB + pops * OPS_PER_POP
               + inner * OPS_PER_INNER + tests * OPS_PER_TEST)
        nb = nbytes(o, d, t0, tk, ok, m.bvh_min, m.bvh_max, m.bvh_left,
                    m.bvh_count, m.indices, m.vertices)
        bound_ms, bound_by = bound(ops, nb)
        ms = event_ms(lambda: traversal.bvh_walk_kernel(o, d, t0, m), 20)
        ms_live = event_ms(lambda: traversal.bvh_walk_kernel(
            o, d, t0, m, alive=alive), 20)
        chosen, lay_ms = traversal.walk_layout, {}
        try:
            for name, lay in layouts.items():
                traversal.walk_layout = lambda lay=lay: lay
                lay_ms[name] = event_ms(
                    lambda: traversal.bvh_walk_kernel(o, d, t0, m), 20)
        finally:
            traversal.walk_layout = chosen
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        for _ in range(20):
            traversal.bvh_walk_kernel(o, d, t0, m)
        host_ms = (time.perf_counter() - t_host) / 20 * 1e3
        torch.cuda.synchronize()
        per_query.append(dict(query=q, ms=ms, ms_live=ms_live, plain_ms=plain,
                              bound_ms=bound_ms, bound_by=bound_by,
                              nodes_popped=pops, inner_entered=inner,
                              tris_tested=tests, bytes=nb, live_share=live / R,
                              layouts_ms=lay_ms, host_enqueue_ms=host_ms))
        print(f"[kernel] bvh_walk query {q}: {ms:.4f} ms all lanes, "
              f"{ms_live:.4f} ms live lanes only ({live / R:.4f} live), "
              f"plain {plain:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{ms / bound_ms:.1f}x; {pops / R:.2f} nodes popped, "
              f"{inner / R:.2f} inner entered, {tests / R:.2f} triangles "
              f"tested per ray; host enqueue {host_ms:.4f} ms per call, on "
              f"{smi}", flush=True)
        print(f"[layouts] bvh_walk query {q}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in lay_ms.items()) + f", on {smi}",
            flush=True)
    check(layouts_same, "every B3 layout gives the twin's t, off and "
          "counters on every query, with and without the alive mask")
    means = {k: sum(r["layouts_ms"][k] for r in per_query) / len(per_query)
             for k in layouts}
    print("[layouts] bvh_walk mean: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in means.items()) + f", on {smi}",
        flush=True)

    # the same gate on the unsplit bunny (one draw) and on seeded banks
    # built to tie and to pass exact zeros through the slab test
    extra = {}
    gen = torch.Generator().manual_seed(9)
    cases = [(f"unsplit bunny query {q}", queries[q], unsplit.mesh)
             for q in (0, 1)]
    for label, make, seed in (("tie-heavy", tie_heavy_query, 7),
                              ("signed-zero", signed_zero_query, 11)):
        o, d, t0, mesh = make(65536, 32, seed=seed, device="cuda",
                              variant="bank")
        alive = (torch.rand(65536, generator=gen) < 0.7).cuda()
        cases.append((label, (o, d, t0, alive), mesh))
    for label, query, mesh in cases:
        twin, _ = walk_twin(query, mesh)
        same = walk_same(query, mesh, twin, layouts)
        extra[label] = dict(bitwise_every_layout_with_and_without_mask=same,
                            hits=int((twin[1] >= 0).sum()),
                            rays=query[0].shape[0],
                            live=int(query[3].sum()),
                            tree_depth=traversal.walk_tables(mesh).depth)
        print(f"[parity] pallas {label}: {json.dumps(extra[label])}",
              flush=True)
        check(all(same.values()), f"pallas {label}: t, off and counters "
              "equal the twin's bit for bit under every layout, with and "
              "without the alive mask")

    traversal.bvh_walk_kernel.launches = 0
    image, frame_ms, peak = serve(scene, mats, cfg, frame_fn)
    launches = traversal.bvh_walk_kernel.launches
    check(launches == 4 * (cfg.max_bounces + 1),
          f"4 'pallas' frames launched the BVH-walk kernel {launches} times")
    check_image(image, "pallas bunny")
    segments = 512 * 512 * (cfg.max_bounces + 1)
    print(f"[pallas] {frame_ms:.2f} ms/frame, "
          f"{segments / (frame_ms / 1e3) / 1e6:.2f} Mrays/s, peak "
          f"{peak:.2f} GiB, on {smi}", flush=True)

    def every_lane(scene, origin, direction, cfg):
        return wavefront.intersect_scene_pallas(scene, origin, direction, cfg)

    with torch.no_grad():
        a = wavefront.render_frame_pallas(scene, mats, cfg, 5)
        full = golden.render_frame(scene, mats, cfg, 5,
                                   intersect_fn=every_lane)
        b = sweep.render_frame(scene, mats, cfg, 5)
    check(torch.equal(a, full), "the 'pallas' frame walking live lanes only "
          "equals the frame walking every lane, bit for bit")
    agree = image_agreement(a, b, 1e-3)
    check(agree >= 0.99, f"the 'pallas' frame matches the sweep frame to "
          f"1e-3 on {agree:.4f} of pixels (>= 0.99)")

    small = cfg.replace(width=64, height=64)
    with torch.no_grad():
        ref = wavefront.render_frame_pallas(scene, mats, small, 1)
        walks = {w: sync_time(lambda: wavefront.render_frame(
            scene, mats, small.replace(traversal=w), 1)) for w in
            ("stack", "stackless")}
    check(torch.equal(walks["stack"][0], ref),
          "64 x 64 'wavefront' stack frame equals the 'pallas' frame")
    agree = image_agreement(walks["stackless"][0], ref, 1e-3)
    check(agree >= 0.99, "64 x 64 'wavefront' stackless frame matches the "
          f"'pallas' frame to 1e-3 on {agree:.4f} of pixels (>= 0.99)")
    print("[wavefront] 64 x 64 frames: stack "
          f"{walks['stack'][1] * 1e3:.1f} ms, stackless "
          f"{walks['stackless'][1] * 1e3:.1f} ms (plain PyTorch), on {smi}",
          flush=True)

    return dict(
        name="bvh_walk", route="cuda",
        source="wc_path_tracer_tpu_torch/kernels/csrc/bvh_walk.cu",
        replaces="wc_path_tracer_tpu/kernels/traversal.py:108",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in parity),
        **mean_entry(per_query),
        library_ms=None,
        ms_note="mean per launch over one 512^2 'pallas' frame's 5 queries, "
                "every lane walked",
        ms_live=sum(r["ms_live"] for r in per_query) / len(per_query),
        layout=dataclasses.asdict(traversal.walk_layout()),
        layouts_mean_ms=means, tables_build_s=tables.build_s,
        tables_first_walk_s=tables_s, ptxas=ptxas,
        parity=parity, parity_extra=extra, per_query=per_query, card=smi,
        frame_ms=frame_ms,
        mrays_s=segments / (frame_ms / 1e3) / 1e6, peak_gib=peak,
        wavefront_64_ms={w: t * 1e3 for w, (_, t) in walks.items()},
        draws=nd), scene


def mxu_phase(smi, scene, mats, cfg):
    """The cluster_kernel="mxu" path: capture, parity (against its twin under
    every timed layout, on the extra queries and ray blocks, and against
    the MT kernel), visits, long pole, vote shares, serving, times.
    Returns the kernel's JSON entry."""
    cfg = cfg.replace(cluster_kernel="mxu")
    kernel, plain_fn = sweep_fns(True)
    queries = []

    def capture(*args):
        queries.append([x.clone() for x in args])
        return kernel(*args)

    with torch.no_grad():
        golden.render_frame(scene, mats, cfg, 0, intersect_fn=sweep
                            .make_intersect_fn(scene, cfg, block_fn=capture))
    check(len(queries) == cfg.max_bounces + 1,
          f"one mxu frame makes {cfg.max_bounces + 1} sweep queries")
    RB, B = queries[0][3].shape[:2]
    C = queries[0][6].shape[0]
    tris_mt = cluster.build_cluster_tables(scene.mesh)[0]

    parity, per_query, layouts_same = [], [], True
    for q, args in enumerate(queries):
        vk = torch.zeros(RB, dtype=torch.int32, device="cuda")
        vp = torch.zeros_like(vk)
        counts = torch.zeros(3, dtype=torch.int64, device="cuda")
        k = kernel(*args, vk)
        p = plain_fn(*args, vp)
        kc = kernel(*args, None, counts)
        mt = cluster.cluster_sweep_kernel(*args[:5], tris_mt)
        torch.cuda.synchronize()
        hk, hm = k[..., 11] >= 0, mt[..., 11] >= 0
        both = hk & hm
        dt = (k[..., 0] - mt[..., 0]).abs()[both]
        t_mt = mt[..., 0][both]
        rel = float((dt / t_mt).max()) if dt.numel() else 0.0
        rel1 = float((dt / t_mt.clamp_min(1.0)).max()) if dt.numel() else 0.0
        rec = sweep_parity(q, k, p, vk, vp, args[0], "mxu ")
        rec.update(hits_differ_from_mt=int((hk != hm).sum()),
                   max_rel_dt_vs_mt=rel, max_dt_over_max_t_1=rel1,
                   slots_equal_mt=float((k[..., 11] == mt[..., 11])
                                        .float().mean()))
        parity.append(rec)
        print(f"[parity] mxu query {q} vs MT: hits differ on "
              f"{rec['hits_differ_from_mt']} rays, max |dt|/t {rel:.3g}, "
              f"max |dt|/max(t, 1) {rel1:.3g}", flush=True)
        check(rec["bitwise"] and rec["visits_equal"],
              f"mxu query {q}: kernel equals its plain twin bit for bit")
        check(torch.equal(kc, k), f"mxu query {q}: the vote-counting build "
              "gives the same payload")
        # the plane form's t = -P / Q loses digits where the ray grazes the
        # plane (Q = n.d cancels): primary rays are held to |dt| <= 5e-5 t.
        # Bounce rays start on a surface, where t is tiny and P cancels too,
        # so they are held to |dt| <= 5e-5 max(t, 1)
        check(rec["hits_differ_from_mt"] == 0
              and (rel if q == 0 else rel1) <= PLANE_T_RTOL,
              f"mxu query {q}: hits equal the MT kernel's on every ray; "
              f"|dt| <= {PLANE_T_RTOL:g} {'t' if q == 0 else 'max(t, 1)'} "
              "where both hit")
        visits = int(vk.sum())
        ops = visits * B * cluster.CLUSTER_TRIS * OPS_PER_PLANE_TEST
        bound_ms, bound_by = bound(ops, nbytes(*args) + nbytes(args[4]))
        ms = event_ms(lambda: kernel(*args), 20)
        plain = event_ms(lambda: plain_fn(*args), 1)
        per_visit, pole = long_pole(args, vk, mxu=True)
        layouts, same = layout_ms(args, p, vp, mxu=True)
        layouts_same = layouts_same and same
        tested, vote1, vote2 = counts.tolist()
        rec = dict(query=q, ms=ms, plain_ms=plain, bound_ms=bound_ms,
                   bound_by=bound_by, visits=visits,
                   nact_per_block=spread(args[0]),
                   visits_per_block=spread(vk),
                   blocks_visiting_half=int((vk >= (C + 1) // 2).sum()),
                   ms_per_visit_alone=per_visit, long_pole_ms=pole,
                   layouts_ms=layouts, warp_slot_steps=tested,
                   t_vote_pass_share=vote1 / max(tested, 1),
                   u_vote_pass_share=vote2 / max(tested, 1))
        per_query.append(rec)
        print(f"[kernel] cluster_sweep_mxu query {q}: {ms:.3f} ms (plain "
              f"{plain:.1f} ms), bound {bound_ms:.3f} ms ({bound_by}), "
              f"{visits} block-cluster visits, on {smi}", flush=True)
        print_visits("mxu ", q, rec, RB, C, ms, smi, "x".join(
            map(str, cluster.sweep_layout(B)[:2])))
        print(f"[votes] mxu query {q}: {tested} (warp, slot step) pairs; "
              f"{rec['t_vote_pass_share']:.4f} pass the t vote, "
              f"{rec['u_vote_pass_share']:.4f} also the u vote", flush=True)
    check(layouts_same, "every B2 layout gives the twin's payload and visits "
          "on every query")

    cluster.cluster_sweep_mxu_kernel.launches = 0
    cluster.cluster_sweep_kernel.launches = 0
    image, frame_ms, peak = serve(scene, mats, cfg, sweep.render_frame)
    launches = cluster.cluster_sweep_mxu_kernel.launches
    check(launches == 4 * (cfg.max_bounces + 1)
          and cluster.cluster_sweep_kernel.launches == 0,
          f"4 mxu frames launched the plane-form kernel {launches} times "
          "and the MT kernel none")
    check_image(image, "mxu bunny")
    segments = 512 * 512 * (cfg.max_bounces + 1)
    print(f"[mxu] {frame_ms:.2f} ms/frame, "
          f"{segments / (frame_ms / 1e3) / 1e6:.2f} Mrays/s, peak "
          f"{peak:.2f} GiB, on {smi}", flush=True)
    with torch.no_grad():
        a = sweep.render_frame(scene, mats, cfg, 5)
        b = sweep.render_frame(scene, mats, cfg.replace(cluster_kernel="mt"),
                               5)
    agree = image_agreement(a, b, 1e-3)
    exact = image_agreement(a, b, 2e-5)
    print(f"[mxu] frame vs MT frame: {exact:.6f} of pixels within 2e-5, "
          f"{agree:.6f} within 1e-3", flush=True)
    check(agree >= 0.99, "the mxu frame matches the MT frame to 1e-3 on "
          f"{agree:.4f} of pixels (>= 0.99)")

    # tie-heavy and signed-zero queries as plane-form tables, the primary
    # query re-culled at larger ray blocks, its first 65,536 rays as one
    tables = cluster.build_cluster_tables_mxu(scene.mesh)
    o, d, t0 = primary_rays(queries[0])
    extra = extra_parity([
        ("tie-heavy", tie_heavy_query(65536, 32, seed=7, device="cuda",
                                      variant="mxu"), cluster.RAY_BLOCK),
        ("signed-zero", signed_zero_query(65536, 32, seed=11, device="cuda"),
         cluster.RAY_BLOCK)]
        + [(f"primary rb {rb}", (o, d, t0) + tables, rb)
           for rb in (2048, 8192, 16384)]
        + [("primary 65536 rays rb 65536",
            (o[:65536], d[:65536], t0[:65536]) + tables, 65536)], "mxu ")
    return dict(
        name="cluster_sweep_mxu", route="cuda",
        source="wc_path_tracer_tpu_torch/kernels/csrc/cluster_sweep_mxu.cu",
        replaces="wc_path_tracer_tpu/kernels/cluster.py:421",
        launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in parity),
        **mean_entry(per_query),
        library_ms=None,
        ms_note="mean per launch over one 512^2 mxu frame's 5 queries",
        parity=parity, parity_extra=extra, per_query=per_query,
        layout=cluster.sweep_layout(B), card=smi, frame_ms=frame_ms,
        mrays_s=segments / (frame_ms / 1e3) / 1e6, peak_gib=peak,
        frame_vs_mt_within_2e5=exact)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {kind}; devices: {count}", flush=True)

    # -- 1. build every kernel from this checkout (one nvcc per source) ----
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(logs)} source(s) compiled in {build_s:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in build.SIGNATURES:
        build.load(name)

    # -- 2. the bunny scene; capture one frame's five kernel queries -------
    scene, cam = bunny_gltf_scene(device="cuda")
    mats = camera_matrices(cam, 1.0)
    tables = cluster.build_cluster_tables(scene.mesh)
    cfg = RenderConfig(**BUNNY)
    frame_fn = dispatch.get_render_frame("auto", scene, cfg)
    check(frame_fn is sweep.render_frame,
          "dispatch 'auto' picks the cluster sweep for the bunny "
          f"({scene.mesh.triangle_capacity} triangle slots)")
    queries = []

    def capture(nact, clist, bt0, rays, prev, tris):
        queries.append([x.clone() for x in (nact, clist, bt0, rays, prev,
                                            tris)])
        return cluster.cluster_sweep_kernel(nact, clist, bt0, rays, prev, tris)

    with torch.no_grad():
        golden.render_frame(scene, mats, cfg, 0, intersect_fn=sweep
                            .make_intersect_fn(scene, cfg, block_fn=capture))
    check(len(queries) == cfg.max_bounces + 1,
          f"one frame makes {cfg.max_bounces + 1} sweep queries")
    RB, B = queries[0][3].shape[:2]
    C = queries[0][5].shape[0] // cluster.CLUSTER_ROWS
    print(f"[bunny] {RB} blocks x {B} rays, {C} clusters", flush=True)

    # -- 3. kernel vs plain twin on every captured query (full size) -------
    parity = []
    for q, args in enumerate(queries):
        vk = torch.zeros(RB, dtype=torch.int32, device="cuda")
        vp = torch.zeros_like(vk)
        k = cluster.cluster_sweep_kernel(*args, vk)
        p = cluster.cluster_sweep_plain(*args, vp)
        torch.cuda.synchronize()
        rec = sweep_parity(q, k, p, vk, vp, args[0])
        parity.append(rec)
        check(rec["bitwise"] and rec["visits_equal"],
              f"query {q}: payload and visits equal the plain twin's bit "
              "for bit")

    # tie-heavy and signed-zero queries, the primary query re-culled at
    # ray_block 2048, and its first 65,536 rays as one ray block
    tie = tie_heavy_query(65536, 32, seed=7, device="cuda")
    o, d, t0 = primary_rays(queries[0])
    extra = extra_parity([
        ("tie-heavy", tie, cluster.RAY_BLOCK),
        ("signed-zero", signed_zero_query(65536, 32, seed=11, device="cuda",
                                          variant="mt"), cluster.RAY_BLOCK),
        ("primary rb 2048", (o, d, t0) + tables, 2048),
        ("primary 65536 rays rb 65536",
         (o[:65536], d[:65536], t0[:65536]) + tables, 65536)])
    k = cluster.cluster_sweep(*tie).view(-1, 16)
    ref = torch.cat([cluster.sweep_reference(
        tie[0][i:i + 8192], tie[1][i:i + 8192], tie[2][i:i + 8192], *tie[3:])
        for i in range(0, tie[0].shape[0], 8192)])
    extra["tie-heavy"]["slots_differ_from_global_first_min"] = int(
        (k[:, 11] != ref[:, 11]).sum())

    # kernel vs the independent brute oracle on 65,536 primary rays
    nact, clist, bt0, rays, prev, tris = queries[0]
    flat = rays.view(-1, 16)[:65536]
    t_init = prev.view(-1, 16)[:65536, 0]
    k = cluster.cluster_sweep_kernel(*queries[0]).view(-1, 16)[:65536]
    cmin = torch.zeros((C, 3), device="cuda")       # unused by the oracle
    ref = torch.cat([cluster.sweep_reference(
        flat[i:i + 2048, 0:3], flat[i:i + 2048, 3:6], t_init[i:i + 2048],
        tris, cmin, cmin) for i in range(0, flat.shape[0], 2048)])
    differ = k[:, 11] != ref[:, 11]
    ties = differ & (k[:, 0] == ref[:, 0])
    print(f"[oracle] 65536 primary rays: slot ids differ on "
          f"{int(differ.sum())} rays, all exact t-ties: "
          f"{bool(torch.equal(differ, ties))}", flush=True)
    check(torch.equal(differ, ties) and int(differ.sum()) <= 65,
          "kernel equals sweep_reference except on exact t-ties")

    # -- 4. the serving path: 4 progressive frames through dispatch auto --
    cluster.cluster_sweep_kernel.launches = 0
    image, frame_ms, peak_gib = serve(scene, mats, cfg, None)
    launches = cluster.cluster_sweep_kernel.launches
    check(launches == 4 * (cfg.max_bounces + 1),
          f"4 frames launched the cluster-sweep kernel {launches} times")
    check_image(image, "bunny")
    segments = 512 * 512 * (cfg.max_bounces + 1)
    print(f"[bunny] {frame_ms:.2f} ms/frame, "
          f"{segments / (frame_ms / 1e3) / 1e6:.2f} Mrays/s "
          f"(segments/s, 5 per pixel), peak {peak_gib:.2f} GiB, on {smi}",
          flush=True)

    # one frame through the plain twin must give the same image
    with torch.no_grad():
        img_k = golden.render_frame(scene, mats, cfg, 5, intersect_fn=sweep
                                    .make_intersect_fn(scene, cfg))
        img_p, plain_frame_s = sync_time(lambda: golden.render_frame(
            scene, mats, cfg, 5, intersect_fn=sweep.make_intersect_fn(
                scene, cfg, block_fn=cluster.cluster_sweep_plain)))
    agree = image_agreement(img_k, img_p, 1e-5)
    check(agree >= 0.999, f"kernel and plain-twin frames agree to 1e-5 on "
          f"{agree:.6f} of pixels (>= 0.999)")

    # the sweep path against the brute-force path on a small frame
    small = RenderConfig(**dict(BUNNY, width=48, height=48))
    with torch.no_grad():
        a = sweep.render_frame(scene, mats, small, 1)
        b = golden.render_frame(scene, mats, small, 1)
    agree = image_agreement(a, b, 1e-3)
    check(agree >= 0.99, f"48 x 48 sweep frame matches the brute-force "
          f"frame to 1e-3 on {agree:.4f} of pixels (>= 0.99)")

    # -- 5. Cornell 1024^2 through dispatch auto (brute path) -------------
    cscene, ccam = cornell_box_scene(device="cuda")
    cmats = camera_matrices(ccam, 1.0)
    ccfg = RenderConfig(**CORNELL)
    check(dispatch.get_render_frame("auto", cscene, ccfg)
          is golden.render_frame, "dispatch 'auto' picks brute force for "
          "the Cornell box")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        golden.render_step(cscene, cmats, ccfg, 0, None)    # warm-up
        cimg, cornell_s = sync_time(lambda: golden.render_step(
            cscene, cmats, ccfg, 1, golden.render_step(
                cscene, cmats, ccfg, 0, None)))
    cpeak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(cimg).all()) and 0.01 < float(cimg.mean()) < 3,
          f"Cornell image finite, mean {float(cimg.mean()):.4f}")
    cms = cornell_s / 2 * 1e3
    print(f"[cornell] {cms:.2f} ms/frame, "
          f"{1024 * 1024 * 5 / (cms / 1e3) / 1e6:.2f} Mrays/s, "
          f"peak {cpeak:.2f} GiB, on {smi}", flush=True)

    # -- 6. the "pallas" path: the split bunny through the BVH walk ---------
    b3, split_scene = pallas_phase(
        smi, cfg, scene, [line.strip() for line in logs.get(
            "bvh_walk", "").splitlines()
            if "ptxas" in line or "spill" in line])

    # -- 7. the plane-form sweep: cluster_kernel="mxu" ----------------------
    b2 = mxu_phase(smi, scene, mats, cfg)

    # -- 8. B1 kernel times against the bound, per launch -------------------
    per_query, layouts_same = [], True
    for q, args in enumerate(queries):
        visits = torch.zeros(RB, dtype=torch.int32, device="cuda")
        want = cluster.cluster_sweep_kernel(*args, visits)
        ms = event_ms(lambda: cluster.cluster_sweep_kernel(*args), 20)
        plain = event_ms(lambda: cluster.cluster_sweep_plain(*args), 2)
        ops = int(visits.sum()) * B * cluster.CLUSTER_TRIS * OPS_PER_TEST
        bound_ms, bound_by = bound(ops, nbytes(*args) + nbytes(args[4]))
        per_visit, pole = long_pole(args, visits)
        layouts, same = layout_ms(args, want, visits)
        layouts_same = layouts_same and same
        rec = dict(query=q, ms=ms, plain_ms=plain, bound_ms=bound_ms,
                   bound_by=bound_by, visits=int(visits.sum()),
                   nact_per_block=spread(args[0]),
                   visits_per_block=spread(visits),
                   blocks_visiting_half=int((visits >= (C + 1) // 2).sum()),
                   ms_per_visit_alone=per_visit, long_pole_ms=pole,
                   layouts_ms=layouts)
        per_query.append(rec)
        print(f"[kernel] query {q}: {ms:.3f} ms (plain {plain:.1f} ms), "
              f"bound {bound_ms:.3f} ms ({bound_by}), "
              f"{int(visits.sum())} block-cluster visits, on {smi}",
              flush=True)
        print_visits("", q, rec, RB, C, ms, smi, "x".join(
            map(str, cluster.sweep_layout(B)[:2])))
    check(layouts_same, "every B1 layout gives the same payload and visits "
          "on every query")
    clock = sm_clock(lambda: cluster.cluster_sweep_kernel(*queries[1]))
    print(f"[kernel] SM clock, max SM clock, power while B1 runs: {clock}",
          flush=True)

    print("[kernel] no PyTorch call computes a closest-hit sweep or a BVH "
          "walk, so no kernel has a library time (library_ms null)",
          flush=True)

    # -- 9. where one frame's device time goes (torch.profiler) -----------
    mxu_cfg = cfg.replace(cluster_kernel="mxu")
    with torch.no_grad():
        profiles = {label: device_profile(smi, label, fn) for label, fn in (
            ("bunny 512^2 frame",
             lambda: sweep.render_frame(scene, mats, cfg, 7)),
            ("bunny 512^2 mxu frame",
             lambda: sweep.render_frame(scene, mats, mxu_cfg, 7)),
            ("bunny 512^2 'pallas' frame",
             lambda: wavefront.render_frame_pallas(split_scene, mats, cfg,
                                                   7)),
            ("cornell 1024^2 frame",
             lambda: golden.render_frame(cscene, cmats, ccfg, 7)))}

    print(json.dumps({"kernels": [{
        "name": "cluster_sweep",
        "route": "cuda",
        "source": "wc_path_tracer_tpu_torch/kernels/csrc/cluster_sweep.cu",
        "replaces": "wc_path_tracer_tpu/kernels/cluster.py:274",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in parity),
        **mean_entry(per_query),
        "library_ms": None,
        "ms_note": "mean per launch over one 512^2 bunny frame's 5 queries",
        "parity": parity,
        "parity_extra": extra,
        "per_query": per_query,
        "layout": cluster.sweep_layout(B),
        "sm_clock_under_load": clock,
        "card": smi,
        "bunny_frame_ms": frame_ms,
        "bunny_mrays_s": segments / (frame_ms / 1e3) / 1e6,
        "bunny_plain_frame_ms": plain_frame_s * 1e3,
        "bunny_peak_gib": peak_gib,
        "cornell_frame_ms": cms,
        "cornell_peak_gib": cpeak,
        "build_s": build_s,
        "profiles": profiles,
    }, b2, b3]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
