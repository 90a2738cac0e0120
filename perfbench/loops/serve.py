"""The serving loop (traffic ``kind`` "serve"): one client's closed loop of
progressive frames through the program's ``Renderer``.

Frames come in cycles of ``cycle``: before frame 0 a material edit
(``update_material``, the albedo of material ``edit_material``, drawn from
the seed), before frames 1 .. ``orbit_frames`` a camera step on an orbit
around the vertical axis through the configuration camera's
``orbit_center`` (``set_camera``, from a start angle drawn from the seed),
then still frames that accumulate.
Every edit resets the accumulation, as the editor does.  A frame is timed
from the call of ``Renderer.step(1)`` until ``Renderer.output()`` has
returned the uint8 image on the host; edits fall between frames.

Set-up builds the Renderer, serves ``warmup_frames`` frames after an edit
and a camera step, and puts material and camera back.  After the window,
a sample of its frames drawn from the seed (perfbench.loops.serve.kept_frames
says which may be drawn), one of the most accumulated among them, is
rendered again by the configuration's reference (``ctx.reference``) from
the same edits and compared: the accumulated HDR image and the uint8
output.

A traced run on the card, after ``trace_skip`` frames, profiles
``trace_steps`` frames with CUDA activity only, one more with CPU activity
too (the idle gaps), then a span pass (perfbench.trace.span_pass): one
profiled frame dropped, ``span_frames`` profiled frames, as many counted
ones; ``post_ms`` times ``output()`` between CUDA events on every frame of
the traced run but the span pass's.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from perfbench import check, harness, program, trace
from perfbench.reference import post as ref_post


def kept_frames(tr: dict, seed: int):
    """frame j -> whether the check may sample it: the last frame of each
    cycle (the most accumulated) and one more per cycle at a position drawn
    from the seed.  Only these frames' images are kept through the window,
    so that the check holds no more device memory than a few frames."""
    rng = np.random.default_rng([seed, 3])
    extra: dict = {}

    def kept(j):
        c, pos = divmod(j, tr["cycle"])
        if c not in extra:
            extra[c] = int(rng.integers(0, tr["cycle"] - 1))
        return pos in (tr["cycle"] - 1, extra[c])

    return kept


def schedule(tr: dict, seed: int, raw_camera: dict):
    """frame j -> (albedo or None, camera or None): the edits made before
    frame j (a function of the seed)."""
    rng = np.random.default_rng([seed, 2])
    cx, cz = raw_camera["orbit_center"]
    px, py, pz = raw_camera["position"]
    radius = math.hypot(px - cx, pz - cz)
    phase0 = math.degrees(math.atan2(px - cx, pz - cz))
    cycles: dict = {}

    def cycle(c):
        if c not in cycles:
            lo, hi = tr["albedo_range"]
            cycles[c] = (rng.uniform(lo, hi, 3).astype(np.float32).tolist(),
                         float(rng.choice(tr["orbit_start_deg"])))
        return cycles[c]

    def camera_at(theta):
        a = math.radians(phase0 + theta)
        return dict(raw_camera,
                    position=[cx + radius * math.sin(a), py,
                              cz + radius * math.cos(a)],
                    yaw=float(raw_camera["yaw"]) - theta)

    def edits(j):
        c, pos = divmod(j, tr["cycle"])
        albedo, start = cycle(c)
        if pos == 0:
            return albedo, None
        if pos <= tr["orbit_frames"]:
            return None, camera_at(start + pos * tr["orbit_step_deg"])
        return None, None

    return edits


def run(ctx):
    from wc_path_tracer_tpu_torch.render.renderer import Renderer

    dev = torch.device(ctx.device)
    r, tr = ctx.render, ctx.traffic
    post = tr["post"]
    scene, cam = program.build_scene(ctx.raw, dev)
    rdr = Renderer(scene, cam, program.render_config(r, **post),
                   renderer=ctx.config["renderer"], device=dev)
    mi = tr["edit_material"]
    raw_cam = ctx.raw["camera"]
    edits = schedule(tr, ctx.seed, raw_cam)
    keep = kept_frames(tr, ctx.seed)

    def apply(j):
        albedo, camera = edits(j)
        if albedo is not None:
            rdr.update_material(mi, albedo=albedo)
        if camera is not None:
            rdr.set_camera(position=camera["position"], yaw=camera["yaw"])

    def cam_fields(c):
        return dict(position=c["position"], yaw=c["yaw"], pitch=c["pitch"],
                    fov=c["fov"])

    for j in range(tr["warmup_frames"]):      # an edit, then a camera step
        apply(j)
        rdr.step(1)
        rdr.output()
    rdr.update_material(mi, albedo=ctx.raw["materials"][mi]["albedo"])
    rdr.set_camera(**cam_fields(raw_cam))
    if ctx.trace and dev.type == "cuda":
        trace.warm_up(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = ctx.setup_s()

    frame_ms, kept, post_ms = [], [], []
    state = dict(albedo=ctx.raw["materials"][mi]["albedo"], camera=raw_cam,
                 malformed=0)

    def frames(n, timed_post=False):
        for _ in range(n):
            j = len(frame_ms)
            albedo, camera = edits(j)
            apply(j)
            state["albedo"] = albedo or state["albedo"]
            state["camera"] = camera or state["camera"]
            t0 = time.perf_counter()
            hdr = rdr.step(1)
            if timed_post:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            out = rdr.output()
            if timed_post:
                ev[1].record()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            state["malformed"] += out.shape != (r["height"], r["width"], 3) \
                or out.dtype != np.uint8
            if timed_post:
                post_ms.append(ev)
            if keep(j):
                kept.append((hdr, out, state["albedo"], state["camera"],
                             rdr.frame_count))

    timed_post = ctx.trace and dev.type == "cuda"
    stretch = gaps = split = None
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while True:
        if timed_post and stretch is None \
                and len(frame_ms) >= tr["trace_skip"]:
            stretch = trace.stretch(lambda n: frames(n, True),
                                    tr["trace_steps"], dev)
            gaps = trace.idle_gaps(lambda n: frames(n, True), dev)
            t_pass = time.perf_counter()
            split = trace.span_pass(lambda n: frames(n, False), dev,
                                    tr["span_frames"])
            print(f"perfbench: span pass of 1 + 2 x {tr['span_frames']} "
                  f"frames in {time.perf_counter() - t_pass:.2f} s",
                  file=sys.stderr)
        else:
            frames(1, timed_post)
        if time.perf_counter() >= deadline and not (
                timed_post and stretch is None):
            break
    window_s = time.perf_counter() - t0
    n = len(frame_ms)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if timed_post:
        torch.cuda.synchronize(dev)
    spans = {"post_ms": [a.elapsed_time(b) for a, b in post_ms]}
    failed = state["malformed"]
    checked = []
    if kept:
        most = max(k[4] for k in kept)
        longest = [i for i, k in enumerate(kept) if k[4] == most]
        must = longest[int(np.random.default_rng([ctx.seed, 4]).integers(
            len(longest)))]
        checked = [kept[i] for i in harness.sample(
            ctx.seed, len(kept), tr["check_frames"], must)]
    del rdr, scene, cam, kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    segments = r["width"] * r["height"] * r["samples"] * (r["max_bounces"] + 1)
    out = harness.Outcome(
        e2e={"serve_mrays": n * segments / window_s / 1e6,
             "frame_ms_p95": harness.percentile(frame_ms, 95.0),
             "setup_s": setup_s},
        attempted=n, failed=failed, samples=[], memory_peak=int(peak),
        stretch=stretch, spans=spans)
    if stretch is not None:
        out.busy_s, out.window_s = stretch.busy_s, stretch.wall_s
        out.breakdown = {"device_ops": trace.device_ops_top(stretch),
                         "idle_gaps": gaps}
        out.counters = split.pop("counters")
        out.span_ms = split
    t_ref = time.perf_counter()
    reference = ctx.reference
    base = reference.prepare(ctx.raw, dev)
    with reference.exact_matmuls():
        for hdr, u8, albedo, camera, count in checked:
            ref_hdr, ref_u8 = replay(reference, base, r, post, mi, albedo,
                                     camera, count)
            out.samples.append(check.serve_numbers(hdr, u8, ref_hdr, ref_u8))
    print(f"perfbench: reference of {sum(c[4] for c in checked)} frames in "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return out


def replay(reference, base, render: dict, post: dict, mi: int, albedo,
           camera, count: int):
    """The accumulated HDR image and uint8 output of the module
    ``reference`` (of perfbench/reference) after ``count`` frames since the
    last reset, at that material and camera, from its scene ``base``."""
    sc = reference.with_camera(reference.with_material(base, mi,
                                                       albedo=albedo),
                               **camera)
    img = None
    for f in range(count):
        img = reference.accumulate(img, reference.render_frame(sc, render, f),
                                   f)
    u8 = ref_post.finalize(img, post["tonemap"], post["gamma"],
                           post["bloom"])
    return img, u8
