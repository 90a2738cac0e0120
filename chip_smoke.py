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
tie-heavy and signed-zero banks, walking every lane and only the
transport's live lanes; its frame walking live lanes only must equal the
frame walking every lane.  The rows entry points
``sweep.render_rows``, ``sweep.trace_rays`` and
``wavefront.render_rows_pallas`` must launch their kernel 5 times per
512 x 512 frame and equal the golden transport through the same backend
bit for bit.  Per query it prints
the time walking every lane and the live lanes only, the bound, and the
nodes and triangles each ray visits.
It also renders the 1024 x 1024 Cornell box through the brute-force path,
``Scene.empty()`` (which must be the gradient sky alone) at that size,
and the plain "wavefront" BVH walks at 64 x 64, checks the images, and
prints times beside the card's name and power limit.
Its [shade] phase holds T1 (kernels/csrc/shade_segment.cu), the
transport's shading, against ``golden._bounce`` on the lanes and hit
record of every segment of a 1024 x 1024 Cornell frame (black sky) and a
512 x 512 bunny frame (gradient sky, Russian roulette from bounce 1):
every field of the next PathState bit for bit, both timed, T1 against its
bytes bound.
Its [brute] phase holds H1 (kernels/csrc/brute_hit.cu), the brute-force
closest-hit search, against ``golden._brute_search`` on every query of a
1024 x 1024 frame of both serving boxes (the Cornell box, 5 queries; the
full-BSDF box with Russian roulette and compaction, 9): its four outputs
bit for bit, both timed, H1 against its operations bound.
Its [post] phase holds P1 (kernels/csrc/post_frame.cu), the serving
post-processing, against ``render/renderer.py::_finalize`` at the serving
cells' shapes (1024 x 1024 and 512 x 512, bloom, ACES, gamma 2.2) on a
seeded HDR image: the uint8 image bit for bit, its launches, its device
time (CUDA events) against its bytes bound and the plain chain's, and the
host time of one call.

Its [cull] phase holds C1 (kernels/csrc/cluster_cull.cu), the cluster
sweep's cull and per-block order, against ``cluster.cull_order_plain`` on
the 5 closest-hit queries of a 512 x 512 bunny frame and the 5 shadow
queries of a lit 512 x 512 bunny NEE+MIS frame: its five outputs, and B1
on both sets of inputs bit for bit, both timed, C1 against its
operations and bytes bound.

Its [train] phase drives the training path: the bench's fwd+bwd step
(``parallel.render.scene_loss_grad`` with the bench loss, mean(img^2) over
albedo, emission, emission_strength and roughness) on the 1024 x 1024
Cornell box and on the 512 x 512 bunny through each kernel path, with next-
event estimation and MIS off and on (the NEE cells on a bunny lit by one
emissive sphere); the NEE shadow queries of B1 and B2 (through
``sweep.occluded_sweep``) and B3 (the full closest hit) held against their
twins and timed against their bounds; kernel-vs-twin parity of the shadow
flags, image, loss and grads of a 64 x 64 lit bunny on all three paths; a
5-step inverse-rendering run on the Cornell box with checkpoints, resumed;
and 3 steps moving the lit bunny's vertices through B1.

Its [edge] phase drives the silhouette estimator (``edge_grads``): the
widened query of the 512 x 512 bunny's primary rays (miter-expanded tables)
through B1 against its twin, bit for bit, timed against its bound; fwd+bwd
steps over the vertices and the camera position on the bunny through B1
and through B2 (whose widened query stays on B1), on the lit bunny with
NEE+MIS (soft sphere shadows) and on the 1024 x 1024 Cornell box (brute
force); kernel-vs-twin parity of 64 x 64 frames (widened query, shadow
flags, image, loss and grads); 3 Adam steps of the lit bunny's vertices,
whose loss must fall.  Its [compact] phase renders the JAX bench's bsdf_row
(1024 x 1024 full-BSDF box, 8 bounces, RR; brute force) and the RR bunny
through B1 with compaction off and on, with the alive share per bounce.
Its [serve] phase drives the progressive ``Renderer`` (the user's serving
entry point) on the 512 x 512 bunny through B1: 8 frames bit for bit with
the chain of ``golden.render_step`` calls, a material edit and a camera
move each resetting it to a fresh frame 0, bloom + tonemap + gamma output
written to a PNG and read back, ms per frame, the profiled busy share and
the share of a frame that rebuilds the sweep's tables; then the 1024 x 1024
Cornell box (brute force).  Its [cli] phase runs ``python -m
wc_path_tracer_tpu_torch`` in subprocesses: the glTF bunny at 512^2 through
B1 with bloom, metrics and a checkpoint, resumed (its PNG equal to a
Renderer's), through "pallas" (B3), ``invert`` on the 128^2 Cornell box
and ``info``.  Its [dp] phase runs ``parallel/dp_check.py`` as 2 ranks on
the card over gloo and 1 rank over NCCL: the Cornell 1024^2 bench step's
loss and grads, the sharded 512^2 bunny render through B1 on each band,
``render_image_sharded``'s brute-force Cornell 1024^2 frame, and the
multi-device dry run's train steps, each against this process alone.
Its [scene] phase drives the native host scene library (built with g++
from scene/csrc/scene_native.cpp beside the kernels; the script fails if
the BVHs fell back to NumPy): the NumPy BVH builder against the native one
on the glTF bunny and bumpy spheres of 81,920 and 327,680 triangles (trees
equal on every array, seconds of each on the card's host); the 327,680-
triangle mesh of ``bunny_like_scene(7)`` written as an OBJ and rendered at
512^2 by ``render --obj`` in subprocesses through "auto" (B1, 5 launches
per frame) and "pallas" (B3, one draw, 5 per frame); one in-process frame
of each with its peak memory; and B1 and B3 against their twins, bit for
bit, on that scene's primary query, timed against their bounds.
Its [bench] phase runs the port's bench (``python -m
wc_path_tracer_tpu_torch.bench``) in subprocesses: the default command
(Cornell 1024^2 fwd+bwd with bvh_row, bsdf_row and scaling_efficiency_8),
--forward-only, --nee, the 512^2 bunny through "pallas", the 327,680-
triangle bunny through "auto" and "pallas", and the single triangle; each
JSON line must carry the root bench.py's keys and metric strings (read from
its source), finite values > 0 and the launches of its path (Cornell none,
"auto" on the bunny B1 5 per step, "pallas" B3 5 per step); in process, the
bench's 512^2 bunny and config must be this script's and its step the fold
of scene_loss_grad's loss and grads, bit for bit, the scaling row's
batched step must equal the same 8 band frames rendered one after another
(images bit for bit) with far fewer launches, and B3 must equal its
twin bit for bit on the primary query of the bench's 327,680-triangle
"pallas" scene (64 draws of 5,120), timed against its bound.
The last two lines of standard output are a JSON line describing every
ported kernel and {"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero and prints no result.  It fails without a CUDA card and
outside the repository (the port's package must be importable).
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

from wc_path_tracer_tpu_torch import RenderConfig, bench
from wc_path_tracer_tpu_torch.io.image import read_png
from perfbench import peaks, trace
from wc_path_tracer_tpu_torch.kernels import (brute, build, cluster, post,
                                              shade, traversal)
from wc_path_tracer_tpu_torch.kernels.launches import (KERNELS, library,
                                                       named, read_counts,
                                                       reset_counts, zeros)
from wc_path_tracer_tpu_torch.models.builtin import (cornell_box_scene,
                                                     full_bsdf_scene,
                                                     mesh_scene)
from wc_path_tracer_tpu_torch.models.gltf import gltf_scene, parse_gltf
from wc_path_tracer_tpu_torch.models.procedural import (
    BUNNY_GLB, bumpy_sphere, bunny_gltf_scene, signed_zero_query,
    tie_heavy_query)
from wc_path_tracer_tpu_torch.ops import rng
from wc_path_tracer_tpu_torch.optim import params as reg
from wc_path_tracer_tpu_torch.optim.inverse import (InverseRenderConfig,
                                                    run_inverse_rendering)
from wc_path_tracer_tpu_torch.parallel import dp_check
from wc_path_tracer_tpu_torch.parallel import render as prender
from wc_path_tracer_tpu_torch.render import dispatch, golden, sweep, wavefront
from wc_path_tracer_tpu_torch.render import renderer as renderer_module
from wc_path_tracer_tpu_torch.render.renderer import Renderer
from wc_path_tracer_tpu_torch.scene import native
from wc_path_tracer_tpu_torch.scene.bvh import build_bvh
from wc_path_tracer_tpu_torch.scene.camera import (camera_matrices,
                                                   primary_ray_directions)
from wc_path_tracer_tpu_torch.scene.types import (MATERIAL_LAMBERTIAN,
                                                  MATERIAL_METAL, Scene,
                                                  SceneBuilder, leaf_names)
from wc_path_tracer_tpu_torch.utils.checkpoint import load_pytree

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
# T1's bytes bound, per lane: it reads its state (o, d, total, trans, seed,
# alive; the origin once where every lane shares the camera's) and writes
# the next; a live lane reads its hit flag, a lane that hit the rest of its
# record (t, p, normal, front, material).  The material table is read once
# per launch.
T1_STATE, T1_HIT_FLAG, T1_HIT_REST = 57, 1, 33
T1_FIELDS = ("o", "d", "total", "trans", "seed", "alive")
# H1's operations bound: each lane tests every live slot, a triangle in
# OPS_PER_TEST, a sphere in OPS_PER_SPHERE (oc 3, b 5, c 7, the
# discriminant 2, its guard and root 2, the miss and the two roots 4, the
# root's choice and t > 0 2); its bytes: the rays in, the four outputs out,
# the slot tables once
OPS_PER_SPHERE = 25
H1_FIELDS = ("t_s", "s_idx", "t_tri", "t_idx")
# C1's operations bound: each padded ray tests every cluster's box, the slab
# test of OPS_PER_SLAB and the 3 enter compares; its bytes: the rays in (an
# expanded origin once), the boxes once, the five outputs out
OPS_PER_CULL = OPS_PER_SLAB + 3
C1_FIELDS = ("nact", "clist", "bt0", "rays", "prev")
# [post]: the serving cells' post settings (perfbench's serve_edit_orbit)
POST = dict(tonemap="aces", gamma=2.2, bloom=True, threshold=1.0, knee=0.1,
            strength=1.0)
PLANE_T_RTOL = 5e-5          # B2 vs MT t: see mxu_phase
# sweep layouts timed against each other: (CTAs per ray block, threads per
# ray), for B1 and for B2
LAYOUTS = [(1, 1), (2, 2), (2, 4), (4, 2), (4, 4), (8, 4)]
BUNNY = dict(width=512, height=512, samples=1, max_bounces=4, sky="gradient")
CORNELL = dict(width=1024, height=1024, samples=1, max_bounces=4,
               sky="gradient")
NEE = dict(use_nee=True, mis=True)
PARITY = dict(width=64, height=64, samples=1, max_bounces=2, sky="gradient",
              **NEE)
INVERSE = dict(width=128, height=128, samples=1, max_bounces=4, sky="black",
               **NEE)
# the multi-device dry run's trainable set
DRY_RUN_TRAINABLE = ("albedo", "emission_strength", "roughness", "vertices",
                     "camera_position")
# the [edge] cells' trainables: geometry and camera, whose silhouettes the
# estimator differentiates
EDGE_TRAINABLE = ("vertices", "camera_position")
# B1 launches per lit-bunny edge_grads NEE step: the widened query, the
# closest hits of both traced paths on bounces 1-4, their 2 x 5 shadow queries
EDGE_LIT_B1 = 1 + 2 * 4 + 2 * 5
SERVE_FRAMES = 8             # progressive frames of the [serve] Renderer
SCENE_SUBDIV = 7             # [scene]: bumpy_sphere(7), bunny_like_scene(7)
SCENE_TRIS = 20 * 4 ** SCENE_SUBDIV     # 327,680 triangles
SCENE_FRAMES = 2             # frames of each [scene] CLI render
ROOT = os.path.dirname(os.path.abspath(__file__))


def sweep_counts(**counts):
    """``zeros(**counts)`` with C1 beside B1 and B2: every cluster sweep on
    the card culls in one launch of C1 before its block sweep."""
    return zeros(**counts, C1=counts.get("B1", 0) + counts.get("B2", 0))


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
    """Profile one call as the benchmark traces a stretch
    (``perfbench.trace.stretch``: CUDA activity only, a named stage's range
    left out): wall ms (host clock, profiler on), the summed device time of
    its device operations, and the operations taking the most of it."""
    s = trace.stretch(lambda units: fn(), 1, torch.device("cuda"))
    wall = s.wall_s
    by_name = {}
    for name, _, ns in s.ops:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + ns / 1e6, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
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


def walk_bytes(mesh, touched, *io):
    """Bytes a B3 walk must move: its per-ray inputs and outputs ``io``,
    each once, the draw records, and one read of each node and triangle
    record it reaches (``touched``, the twin's masks: inner nodes entered,
    triangle slots tested), not the padded scene tables, most of which a
    walk never reads."""
    t = traversal.walk_tables(mesh)
    nodes, tris = (int(x.sum()) for x in touched)
    return (nbytes(*io, t.draws) + nodes * t.nodes[0].nbytes
            + tris * t.tris[0].nbytes)


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


def sweep_wrappers(cfg, scene, mats, frame):
    """``sweep.render_rows`` and ``sweep.trace_rays`` on the 512^2 bunny,
    frame 5: each launches B1 once per bounce and equals the golden
    transport through ``sweep.make_intersect_fn`` bit for bit (``frame``
    is that frame, rendered so)."""
    H, W = cfg.height, cfg.width
    reset_counts()
    with torch.no_grad():
        rows = sweep.render_rows(scene, mats, cfg, 5, 0, H)
    n = read_counts()["B1"]
    check(n == cfg.max_bounces + 1 and torch.equal(rows, frame),
          f"sweep.render_rows of the {W}^2 frame launched B1 {n} times and "
          "equals golden.render_rows through make_intersect_fn bit for bit")
    d = primary_ray_directions(mats, W, H).reshape(-1, 3)
    o = mats.position.expand_as(d)
    seed = rng.pixel_seed(torch.arange(H * W, device=d.device), 5)
    reset_counts()
    with torch.no_grad():
        light, out = sweep.trace_rays(scene, o, d, seed, cfg)
        n = read_counts()["B1"]
        want, want_seed = golden.trace_rays(
            scene, o, d, seed, cfg, sweep.make_intersect_fn(scene, cfg))
    check(n == cfg.max_bounces + 1 and torch.equal(light, want)
          and torch.equal(out, want_seed),
          f"sweep.trace_rays of the {W}^2 primary rays launched B1 {n} times "
          "and equals golden.trace_rays through make_intersect_fn bit for "
          "bit, radiance and seeds")


def pallas_rows(cfg, scene, mats):
    """``wavefront.render_rows_pallas`` of frame 5 launches B3 once per
    bounce and equals ``golden.render_rows`` through
    ``make_intersect_fn_pallas`` bit for bit."""
    reset_counts()
    with torch.no_grad():
        rows = wavefront.render_rows_pallas(scene, mats, cfg, 5, 0,
                                            cfg.height)
        n = read_counts()["B3"]
        want = golden.render_rows(
            scene, mats, cfg, 5, 0, cfg.height,
            intersect_fn=wavefront.make_intersect_fn_pallas(scene))
    check(n == cfg.max_bounces + 1 and torch.equal(rows, want),
          f"wavefront.render_rows_pallas of the {cfg.width}^2 frame launched "
          f"B3 {n} times and equals golden.render_rows through "
          "make_intersect_fn_pallas bit for bit")


def empty_sky(mats, cfg):
    """``Scene.empty()`` (device None: the card) renders the gradient sky
    alone at the config's size (tests/test_render_golden.py:30-41)."""
    sky = cfg.replace(sky="gradient")
    with torch.no_grad():
        scene = Scene.empty()
        img = golden.render_frame(scene, mats, sky, 0)
        d = primary_ray_directions(mats, sky.width, sky.height)
        a = 0.5 * (d[..., 1:2] + 1.0)
        want = torch.tensor([0.5, 0.7, 1.0], device=d.device) * (1 - a) + a
    err = float((img - want).abs().max())
    check(scene.device.type == "cuda" and err <= 1e-5,
          f"Scene.empty() on {scene.device} renders the gradient sky at "
          f"{sky.width}^2, max |diff| {err:.3g} <= 1e-5")


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


def bits_differ(got, want):
    """None where ``got`` equals ``want`` bit for bit (floats compared by
    their bits), else how many elements differ."""
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    if got.shape == want.shape and torch.equal(got, want):
        return None
    return f"{int((got != want).sum())} of {got.numel()} differ"


def shade_bytes(s, rec, materials):
    """Bytes one T1 launch must move on the lanes of ``s`` and ``rec``."""
    lanes = s.d.shape[0]
    shared = 12 * (lanes - 1) if s.o.stride(0) == 0 else 0
    return (2 * T1_STATE * lanes - shared
            + T1_HIT_FLAG * int(s.alive.sum())
            + T1_HIT_REST * int((s.alive & rec.hit).sum())
            + nbytes(*materials))


def shade_cell(smi, label, scene, mats, cfg):
    """T1 against ``golden._bounce`` on the lanes and hit record of every
    segment of one frame at full size: each field of the next PathState bit
    for bit, both timed (CUDA events), T1 against its bytes bound -> one
    record per segment."""
    fn = dispatch.get_intersect_fn("auto", scene, cfg)
    n = cfg.width * cfg.height
    dirs = primary_ray_directions(mats, cfg.width, cfg.height).reshape(-1, 3)
    seed = rng.pixel_seed(torch.arange(n, device=dirs.device), 0)
    s = golden._initial_state(mats.position.expand(n, 3), dirs, seed)
    materials = shade.pack_materials(scene.materials)
    per_segment = []
    for b in range(cfg.max_bounces + 1):
        rec = golden._closest_hit(scene, cfg, fn, s)

        def fused(s=s, rec=rec, b=b):
            return shade.shade_segment_kernel(
                s.o, s.d, s.total, s.trans, s.seed, s.alive, rec, materials,
                sky_gradient=cfg.sky != "black",
                rr=cfg.use_rr and b >= cfg.rr_start_bounce)

        def plain(s=s, rec=rec):
            return golden._bounce(scene, cfg, lambda *a, **k: rec, s)

        got, want = fused(), plain()
        torch.cuda.synchronize()
        differ = {name: bits_differ(g, getattr(want, name))
                  for name, g in zip(T1_FIELDS, got)}
        differ = {k: v for k, v in differ.items() if v}
        err = max(float((g.double() - getattr(want, k).double()).abs()
                        .nan_to_num(0.0).max())
                  for k, g in zip(T1_FIELDS, got) if g.is_floating_point())
        ms = event_ms(fused, 20)
        plain_ms = event_ms(plain, 3)
        nb = shade_bytes(s, rec, materials)
        bound_s, bound_by = peaks.bound(0, nb)
        bound_ms = bound_s * 1e3
        per_segment.append(dict(
            segment=b, lanes=n, alive=int(s.alive.sum()),
            hit=int((s.alive & rec.hit).sum()), bitwise=not differ,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nb,
            bound_ms=bound_ms, bound_by=bound_by))
        print(f"[shade] {label} segment {b}: {per_segment[-1]['alive']} of "
              f"{n} lanes alive; T1 {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, {nb / 1e6:.2f} MB), "
              f"{100 * bound_ms / ms:.1f} % of it; differ {differ or 'none'}"
              f", on {smi}", flush=True)
        check(not differ, f"[shade] {label} segment {b}: T1 equals _bounce "
              f"bit for bit in {', '.join(T1_FIELDS)}")
        s = want
    return per_segment


def shade_phase(smi, cscene, cmats, ccfg, scene, mats, cfg):
    """The [shade] phase: T1 against its plain twin on every segment of a
    1024^2 Cornell frame under the black sky (brute force) and a 512^2
    bunny frame under the gradient sky with Russian roulette from bounce 1
    (the sweep and B1) -> T1's entry of the kernels line."""
    with torch.no_grad():
        box = shade_cell(smi, "cornell 1024^2", cscene, cmats,
                         ccfg.replace(sky="black"))
        bunny = shade_cell(smi, "bunny 512^2 rr", scene, mats,
                           cfg.replace(use_rr=True, rr_start_bounce=1))
    return dict(
        name="shade_segment", route="cuda",
        source="wc_path_tracer_tpu_torch/kernels/csrc/shade_segment.cu",
        replaces=None,
        max_abs_err=max(r["max_abs_err"] for r in box + bunny),
        **mean_entry(box), library_ms=None,
        ms_note="mean per launch over one 1024^2 Cornell frame's 5 segments "
                "(black sky); replaces no TPU kernel: the JAX transport is "
                "one jitted program",
        per_segment=box, bunny=mean_entry(bunny), bunny_per_segment=bunny,
        card=smi)


def brute_cell(smi, label, scene, mats, cfg):
    """H1 against ``golden._brute_search`` on every closest-hit query of
    one frame at full size (dispatch "auto", compaction as ``cfg`` says):
    the four outputs bit for bit, both timed (CUDA events), H1 against its
    operations bound -> one record per query."""
    queries = []

    def capture(scene, o, d, cfg):
        # the camera's origin, expanded, stays a view (read in place)
        queries.append((o if o.stride(0) == 0 else o.clone(), d.clone()))
        return golden.intersect_scene_brute(scene, o, d, cfg)

    golden.render_frame(scene, mats, cfg, 0, capture)
    sph, mesh = scene.spheres, scene.mesh
    abc = golden.triangle_vertices(mesh)
    live_tris = int(golden._live_triangle_mask(scene).sum())
    per_query = []
    for q, (o, d) in enumerate(queries):

        def kernel(o=o, d=d):
            return brute.brute_hit_kernel(
                o, d, sph.position, sph.radius, sph.count, *abc,
                mesh.tri_draw, mesh.draw_count, cfg.sphere_near_root_only)

        def plain(o=o, d=d):
            return golden._brute_search(scene, o, d, cfg, *abc)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        differ = {name: bits_differ(g, w)
                  for name, g, w in zip(H1_FIELDS, got, want)}
        differ = {k: v for k, v in differ.items() if v}
        err = max(float((g.double() - w.double()).abs().nan_to_num(0.0)
                        .max()) for g, w in zip(got, want))
        ms = event_ms(kernel, 20)
        plain_ms = event_ms(plain, 3)
        lanes = d.shape[0]
        ops = lanes * (live_tris * OPS_PER_TEST
                       + int(sph.count) * OPS_PER_SPHERE)
        nb = (nbytes(o[:1] if o.stride(0) == 0 else o, d, *got, *abc,
                     mesh.tri_draw, sph.position, sph.radius))
        least_s, bound_by = peaks.bound(ops, nb)
        bound_ms = least_s * 1e3
        per_query.append(dict(
            query=q, lanes=lanes, bitwise=not differ, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, ops=ops, bytes=nb, bound_ms=bound_ms,
            bound_by=bound_by))
        print(f"[brute] {label} query {q}: {lanes} lanes; H1 {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}, {ops / 1e9:.3f} GFLOP, {nb / 1e6:.2f} MB), "
              f"{100 * bound_ms / ms:.1f} % of it; differ {differ or 'none'}"
              f", on {smi}", flush=True)
        check(not differ, f"[brute] {label} query {q}: H1 equals "
              f"_brute_search bit for bit in {', '.join(H1_FIELDS)}")
    return per_query


def brute_phase(smi, cscene, cmats, ccfg):
    """The [brute] phase: H1 against its plain twin on every query of a
    1024^2 frame of each serving box, ``cornell-serve``'s (5 queries) and
    ``bsdf-serve``'s (9, the last five compacted) -> H1's entry of the
    kernels line."""
    fscene, fcam = full_bsdf_scene(device="cuda")
    fcfg = RenderConfig(width=1024, height=1024, samples=1, max_bounces=8,
                        sky="black", use_rr=True, rr_start_bounce=3,
                        compact=True)
    with torch.no_grad():
        box = brute_cell(smi, "cornell 1024^2", cscene, cmats,
                         ccfg.replace(sky="black"))
        bsdf = brute_cell(smi, "full_bsdf 1024^2 rr compact", fscene,
                          camera_matrices(fcam, 1.0), fcfg)
    check(len(box) == 5 and len(bsdf) == 9, "[brute] one frame of each box "
          "makes 5 and 9 closest-hit queries")
    return dict(
        name="brute_hit", route="cuda",
        source="wc_path_tracer_tpu_torch/kernels/csrc/brute_hit.cu",
        replaces=None,
        max_abs_err=max(r["max_abs_err"] for r in box + bsdf),
        **mean_entry(box), library_ms=None,
        ms_note="mean per launch over one 1024^2 Cornell frame's 5 "
                "queries; replaces no TPU kernel: XLA fused the JAX brute "
                "sweep",
        per_query=box, bsdf=mean_entry(bsdf), bsdf_per_query=bsdf,
        card=smi)


def sweep_inputs(scene, mats, cfg):
    """Every ``cluster.cluster_sweep`` call of one frame through the sweep
    and its kernels -> [(origin, direction, t_init, cmin, cmax, ray_block,
    tris)] in call order."""
    real, seen = cluster.cluster_sweep, []

    def capture(origin, direction, t_init, tris, cmin, cmax,
                ray_block=cluster.RAY_BLOCK, **kw):
        # an origin expanded from one row stays a view (read in place)
        seen.append(tuple(x if x.stride(0) == 0 else x.clone()
                          for x in (origin, direction, t_init))
                    + (cmin, cmax, ray_block, tris))
        return real(origin, direction, t_init, tris, cmin, cmax,
                    ray_block=ray_block, **kw)

    cluster.cluster_sweep = capture
    try:
        with torch.no_grad():
            golden.render_frame(scene, mats, cfg, 0, intersect_fn=sweep
                                .make_intersect_fn(scene, cfg))
    finally:
        cluster.cluster_sweep = real
    return seen


def cull_differ(got, want):
    """C1's five outputs against the twin's -> {field: how many differ}:
    nact, clist and prev by their bits, bt0 and rays as floats (C1 gives
    +0.0 where the twin may give an entry of -0.0)."""
    out = {}
    for name, g, w in zip(C1_FIELDS, got, want):
        if name not in ("bt0", "rays"):
            out[name] = bits_differ(g, w)
        elif g.shape != w.shape or not torch.equal(g, w):
            out[name] = f"{int((g != w).sum())} of {g.numel()} differ"
    return {k: v for k, v in out.items() if v}


def cull_cell(smi, label, queries):
    """C1 against ``cluster.cull_order_plain`` on each captured query: its
    five outputs (``cull_differ``, and the largest absolute difference of
    any of their values, the integers' included), and B1 on both sets of
    inputs bit for bit in payload and visits; both timed (CUDA events), C1
    against its bound -> one record per query."""
    per_query = []
    for q, (o, d, t0, cmin, cmax, rb, tris) in enumerate(queries):

        def kernel(o=o, d=d, t0=t0, cmin=cmin, cmax=cmax, rb=rb):
            return cluster.cluster_cull_kernel(o, d, t0, cmin, cmax, rb)

        def plain(o=o, d=d, t0=t0, cmin=cmin, cmax=cmax, rb=rb):
            return cluster.cull_order_plain(o, d, t0, cmin, cmax, rb)

        got, want = kernel(), plain()
        vk = torch.zeros_like(got[0])
        vp = torch.zeros_like(vk)
        pk = cluster.cluster_sweep_kernel(*got, tris, vk)
        pp = cluster.cluster_sweep_kernel(*want, tris, vp)
        torch.cuda.synchronize()
        differ = cull_differ(got, want)
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        same = bits_differ(pk, pp) is None and torch.equal(vk, vp)
        ms = event_ms(kernel, 20)
        plain_ms = event_ms(plain, 3)
        R, C = d.shape[0], cmin.shape[0]
        ops = got[3].shape[0] * rb * C * OPS_PER_CULL
        nb = nbytes(o[:1] if o.stride(0) == 0 else o, d, t0, cmin, cmax,
                    *got)
        least_s, bound_by = peaks.bound(ops, nb)
        bound_ms = least_s * 1e3
        per_query.append(dict(
            query=q, rays=R, clusters=C, ray_block=rb,
            nact=int(got[0].sum()), bitwise=not differ, max_abs_err=err,
            sweep_bitwise=same,
            ms=ms, plain_ms=plain_ms, ops=ops, bytes=nb, bound_ms=bound_ms,
            bound_by=bound_by))
        print(f"[cull] {label} query {q}: {R} rays, {C} clusters, ray block "
              f"{rb}; C1 {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {ops / 1e9:.3f} GFLOP, "
              f"{nb / 1e6:.2f} MB), {100 * bound_ms / ms:.1f} % of it; "
              f"active {per_query[-1]['nact']}; differ {differ or 'none'}, "
              f"max_abs_err {err!r}; "
              f"B1 the same on both: {same}, on {smi}", flush=True)
        check(not differ and same, f"[cull] {label} query {q}: C1 equals "
              "cull_order_plain and B1 gives the same payload and visits "
              "on both")
    return per_query


def cull_phase(smi, scene, mats, cfg):
    """The [cull] phase: C1, the sweep's cull and per-block order, against
    its plain twin on the 5 closest-hit queries of one 512^2 bunny frame
    and the 5 shadow queries of one lit 512^2 bunny NEE+MIS frame -> C1's
    entry of the kernels line."""
    bunny = sweep_inputs(scene, mats, cfg)
    lit = sweep_inputs(lit_bunny_scene(), mats, cfg.replace(**NEE))
    check(len(bunny) == 5 and len(lit) == 10, "[cull] one bunny frame makes "
          "5 sweep queries, one lit bunny NEE frame 5 closest-hit and 5 "
          "shadow queries")
    with torch.no_grad():
        closest = cull_cell(smi, "bunny 512^2", bunny)
        shadow = cull_cell(smi, "lit bunny 512^2 shadow", lit[1::2])
    return dict(
        name="cluster_cull", route="cuda",
        source="wc_path_tracer_tpu_torch/kernels/csrc/cluster_cull.cu",
        replaces=None,
        max_abs_err=max(q["max_abs_err"] for q in closest + shadow),
        **mean_entry(closest),
        library_ms=None,
        ms_note="mean per launch over one 512^2 bunny frame's 5 queries; "
                "replaces no TPU kernel: XLA fused the JAX cull",
        per_query=closest, shadow=mean_entry(shadow),
        shadow_per_query=shadow, card=smi)


def post_bytes(h, w):
    """Bytes one P1 call with bloom must move at (h, w): the HDR image read
    and the uint8 image written once, each pyramid level written once and
    read once."""
    levels = sum(y * x for y, x in post.pyramid(h, w))
    return h * w * 3 * 4 + h * w * 3 + 2 * levels * 3 * 4


def post_hdr(h, w, seed):
    """A seeded (h, w, 3) HDR image on the card: values across zero, the
    bloom knee and the prefilter's clamp at 20."""
    r = np.random.default_rng(seed)
    x = r.choice([-0.3, 0.0, 0.02, 0.3, 0.9, 1.0, 1.1, 3.0, 25.0],
                 size=(h, w, 3)) * r.uniform(0.97, 1.03, (h, w, 3))
    return torch.tensor(x, dtype=torch.float32, device="cuda")


def post_cell(smi, size):
    """P1 against ``_finalize`` on a seeded size x size HDR image with the
    serving cells' settings: the uint8 image bit for bit, the launches of
    one call, device ms of both (CUDA events) against P1's bytes bound,
    and the host time of one P1 call -> one record."""
    img = post_hdr(size, size, seed=size)
    args = [POST[k] for k in ("tonemap", "gamma", "bloom", "threshold",
                              "knee", "strength")]

    def kernel():
        return post.post_frame_kernel(img, *args)

    def plain():
        return renderer_module._finalize(img, *args)

    before = read_counts()["P1"]
    got = kernel()
    n_launch = read_counts()["P1"] - before
    want = plain()
    torch.cuda.synchronize()
    differ = bits_differ(got, want)
    check(not differ, f"[post] {size}^2: P1 equals _finalize bit for bit "
          f"in the uint8 image ({differ or 'none differ'})")
    check(n_launch == 2 * len(post.pyramid(size, size)) <= 16,
          f"[post] {size}^2: one call launches P1 {n_launch} times (the "
          "pyramid's levels down and up, and the composite)")
    ms = event_ms(kernel, 20)
    plain_ms = event_ms(plain, 3)
    host_us = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel()
        host_us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    host_us = sorted(host_us)[len(host_us) // 2]
    nb = post_bytes(size, size)
    bound_s, bound_by = peaks.bound(0, nb)
    bound_ms = bound_s * 1e3
    profile = device_profile(smi, f"[post] P1 {size}^2", kernel, top=4)
    print(f"[post] {size}^2 aces gamma 2.2 bloom: P1 {ms:.4f} ms a call "
          f"(CUDA events), host {host_us:.1f} us a call (median of 30), "
          f"{n_launch} launches; plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}, {nb / 1e6:.2f} MB), "
          f"{100 * bound_ms / ms:.1f} % of it; on {smi}", flush=True)
    return dict(size=size, launches=n_launch, bitwise=not differ, ms=ms,
                plain_ms=plain_ms, host_us=host_us, bytes=nb,
                bound_ms=bound_ms, bound_by=bound_by,
                profile_launches=profile["launches"],
                profile_device_ms=profile["device_ms"])


def post_phase(smi):
    """The [post] phase: P1 against its plain twin at the serving cells'
    shapes (1024^2 and 512^2) -> P1's entry of the kernels line."""
    with torch.no_grad():
        cells = [post_cell(smi, size) for size in (1024, 512)]
    return dict(
        name="post_frame", route="cuda",
        source="wc_path_tracer_tpu_torch/kernels/csrc/post_frame.cu",
        replaces=None, max_abs_err=0.0,
        **{k: cells[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "host_us", "launches")},
        library_ms=None,
        ms_note="one call (bloom, ACES, gamma 2.2) on a seeded 1024^2 HDR "
                "image; replaces no TPU kernel: XLA fuses the JAX "
                "package's jnp bloom and tonemaps",
        per_size=cells, card=smi)


def walk_expected(twin, t0, alive):
    """The twin's (t, off, counts) over every lane, as a walk of only the
    lanes of ``alive`` must give them (dead lanes: t_init, -1, 0)."""
    tp, op, cp = twin
    if alive is None:
        return tp, op, cp
    return (torch.where(alive, tp, t0), torch.where(alive, op, -1),
            torch.where(alive[:, None], cp, 0))


def walk_same(query, mesh, twin):
    """B3 against its twin, bitwise in t, off and the counters, on every
    lane and on the live lanes only -> whether both equal it."""
    o, d, t0, alive = query
    same = True
    for mask in (None, alive):
        ck = torch.full_like(twin[2], 7)
        tk, ok = traversal.bvh_walk_kernel(o, d, t0, mesh, ck, alive=mask)
        torch.cuda.synchronize()
        want = walk_expected(twin, t0, mask)
        same = same and all(torch.equal(a, b) for a, b in
                            zip((tk, ok, ck), want))
    return same


def walk_twin(query, mesh, masked=False):
    """The twin over every lane (``masked``: the query's live lanes) ->
    ((t, off, counts), device ms of the one run, CUDA events, the records
    it reached as ``bvh_walk_plain``'s ``touched`` masks)."""
    o, d, t0, alive = query
    counts = torch.zeros((o.shape[0], traversal.COUNT_COLS),
                         dtype=torch.int32, device="cuda")
    touched = (torch.zeros(mesh.bvh_left.shape[0], dtype=torch.bool,
                           device="cuda"),
               torch.zeros(mesh.indices.shape[0] // 3, dtype=torch.bool,
                           device="cuda"))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    tp, op = traversal.bvh_walk_plain(o, d, t0, mesh, counts,
                                      alive if masked else None, touched)
    end.record()
    torch.cuda.synchronize()
    return (tp, op, counts), start.elapsed_time(end), touched


def pallas_phase(smi, cfg, unsplit, ptxas):
    """The "pallas" path: the kernel's tables, capture (with the transport's
    alive masks), parity with and without the masks (the five queries, the
    unsplit bunny ``unsplit``, seeded tie-heavy and signed-zero banks),
    times, serving, frames.  Returns the kernel's JSON entry and the split
    scene."""
    scene, cam = bunny_gltf_scene(
        max_blas_tris=dispatch.PALLAS_MAX_TRIS, device="cuda")
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
    check(frame_fn.backend == "pallas",
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
    print(f"[pallas] {nd} draws, {m.bvh_left.shape[0]} node slots, tree "
          f"depth {tables.depth}, {R} rays per query", flush=True)

    parity, per_query = [], []
    for q, query in enumerate(queries):
        o, d, t0, alive = query
        twin, plain, touched = walk_twin(query, m)
        tp, op, cp = twin
        ck = torch.zeros_like(cp)
        tk, ok = traversal.bvh_walk_kernel(o, d, t0, m, ck)
        torch.cuda.synchronize()
        same = walk_same(query, m, twin)
        live = int(alive.sum())
        rec = dict(query=q, bitwise=bool(torch.equal(tk, tp)
                                         and torch.equal(ok, op)),
                   counts_equal=bool(torch.equal(ck, cp)),
                   max_abs_err=float((tk - tp).abs().max()),
                   bitwise_with_and_without_mask=same,
                   hits=int((op >= 0).sum()), live=live)
        parity.append(rec)
        print(f"[parity] pallas query {q}: {json.dumps(rec)}", flush=True)
        check(rec["bitwise"] and rec["counts_equal"] and same,
              f"pallas query {q}: t, off and counters equal the twin's bit "
              f"for bit, on every lane and on the {live} live lanes")
        pops, inner, tests = (int(x) for x in cp.long().sum(0))
        ops = (R * nd * OPS_PER_SLAB + pops * OPS_PER_POP
               + inner * OPS_PER_INNER + tests * OPS_PER_TEST)
        nb = walk_bytes(m, touched, o, d, t0, tk, ok)
        bound_s, bound_by = peaks.bound(ops, nb)
        bound_ms = bound_s * 1e3
        ms = event_ms(lambda: traversal.bvh_walk_kernel(o, d, t0, m), 20)
        ms_live = event_ms(lambda: traversal.bvh_walk_kernel(
            o, d, t0, m, alive=alive), 20)
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
                              host_enqueue_ms=host_ms))
        print(f"[kernel] bvh_walk query {q}: {ms:.4f} ms all lanes, "
              f"{ms_live:.4f} ms live lanes only ({live / R:.4f} live), "
              f"plain {plain:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{ms / bound_ms:.1f}x; {pops / R:.2f} nodes popped, "
              f"{inner / R:.2f} inner entered, {tests / R:.2f} triangles "
              f"tested per ray; host enqueue {host_ms:.4f} ms per call, on "
              f"{smi}", flush=True)

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
        twin = walk_twin(query, mesh)[0]
        same = walk_same(query, mesh, twin)
        extra[label] = dict(bitwise_with_and_without_mask=same,
                            hits=int((twin[1] >= 0).sum()),
                            rays=query[0].shape[0],
                            live=int(query[3].sum()),
                            tree_depth=traversal.walk_tables(mesh).depth)
        print(f"[parity] pallas {label}: {json.dumps(extra[label])}",
              flush=True)
        check(same, f"pallas {label}: t, off and counters equal the twin's "
              "bit for bit, with and without the alive mask")

    reset_counts()
    image, frame_ms, peak = serve(scene, mats, cfg, frame_fn)
    launches = read_counts()["B3"]
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
    pallas_rows(cfg, scene, mats)
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
        tables_build_s=tables.build_s,
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
        bound_s, bound_by = peaks.bound(ops, nbytes(*args) + nbytes(args[4]))
        bound_ms = bound_s * 1e3
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

    reset_counts()
    image, frame_ms, peak = serve(scene, mats, cfg, sweep.render_frame)
    counts = read_counts()
    launches = counts["B2"]
    check(launches == 4 * (cfg.max_bounces + 1) and counts["B1"] == 0,
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


def lit_bunny_scene(max_blas_tris=None):
    """``bunny_gltf_scene()``'s scene plus one emissive sphere of
    ``default_scene``'s "Left" material (emission 1.6, strength 1) at
    (-2, 3, 1), radius 0.5, clear of the bunny's bounds (x +-1.18, y -0.18
    to 2.18, z +-1.06): the stock bunny is lit by the sky alone, so NEE
    would sample nothing there."""
    model = parse_gltf(BUNNY_GLB)
    b = SceneBuilder()
    gm = model.materials[model.meshes[0].material]
    body = b.add_material(MATERIAL_LAMBERTIAN, albedo=gm["albedo"])
    ground = b.add_material(MATERIAL_METAL, albedo=(0.6, 0.6, 0.6),
                            roughness=0.9)
    for mesh in model.meshes:
        b.add_mesh(mesh.vertices, mesh.indices, normals=mesh.normals,
                   uvs=mesh.uvs, tri_material=body,
                   max_blas_tris=max_blas_tris)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    lamp = b.add_material(MATERIAL_METAL, emission=(1.6, 1.6, 1.6),
                          emission_strength=1.0)
    b.add_sphere((-2.0, 3.0, 1.0), 0.5, lamp)
    return b.build("cuda")


def grad_stats(grads):
    """(every leaf finite, global grad norm)."""
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    return finite, norm


def segments_per_s(cfg, seconds):
    """The bench's rate: W·H·spp·(bounces+1) path segments per second."""
    return (cfg.width * cfg.height * cfg.samples * (cfg.max_bounces + 1)
            / seconds / 1e6)


def train_cell(smi, label, scene, mats, cfg, renderer, per_step):
    """The bench's fwd+bwd step (mean(img^2) over the bench's trainables)
    through ``renderer``: 1 warm-up step, then 4 steps timed on the host
    clock (synchronized), with every kernel's launch count set to 0 just
    before them; ``per_step`` {kernel: launches per step} is what the path
    must launch."""
    loss_grad = prender.scene_loss_grad(cfg, prender.BENCH_TRAINABLE,
                                        renderer)
    target = torch.zeros((cfg.height, cfg.width, 3), device="cuda")
    loss_grad(scene, mats, 0, target)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for frame in range(1, 5):
        (loss, grads), s = sync_time(
            lambda: loss_grad(scene, mats, frame, target))
        times.append(s * 1e3)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite, norm = grad_stats(grads)
    want = sweep_counts(**{k: 4 * n for k, n in per_step.items()})
    check(counts == want, f"[train] {label}: 4 steps launched {counts} "
          f"(expected {want})")
    check(finite and norm > 0.0, f"[train] {label}: every grad leaf is "
          f"finite, grad norm {norm:.6g} > 0")
    ms = sum(times) / len(times)
    rate = segments_per_s(cfg, ms / 1e3)
    print(f"[train] {label}: {ms:.2f} ms/step (4 steps after 1 warm-up, "
          f"{min(times):.2f}-{max(times):.2f}), {rate:.2f} Mrays/s, peak "
          f"{peak:.2f} GiB, loss {float(loss):.6g}, grad norm {norm:.6g}, "
          f"launches {counts}, on {smi}", flush=True)
    return dict(ms_per_step=ms, step_ms=times, mrays_s=rate, peak_gib=peak,
                loss=float(loss), grad_norm=norm, launches=counts)


def sweep_shadow_queries(smi, scene, mats, cfg):
    """One NEE frame's sweep queries through B1 (B2 under cluster_kernel
    "mxu"), closest-hit and shadow queries alternating; each of the five
    shadow queries (``occluded_sweep``: bounded at the light, -inf on
    disabled lanes) against the twin bit for bit (payload and visits),
    timed, against its bound, with its active-lane share and visits
    against ``nact`` (the block-wide early exit trims a list only where
    visits < nact)."""
    mxu = cfg.cluster_kernel == "mxu"
    kernel, plain = sweep_fns(mxu)
    queries = []

    def capture(*args):
        queries.append([x.clone() for x in args])
        return kernel(*args)

    with torch.no_grad():
        golden.render_frame(scene, mats, cfg, 0, intersect_fn=sweep
                            .make_intersect_fn(scene, cfg, block_fn=capture))
    check(len(queries) == 2 * (cfg.max_bounces + 1),
          f"one NEE frame makes {cfg.max_bounces + 1} closest-hit and "
          f"{cfg.max_bounces + 1} shadow sweep queries")
    name = "cluster_sweep_mxu" if mxu else "cluster_sweep"
    out = []
    for q, args in enumerate(queries[1::2]):
        RB, B = args[3].shape[:2]
        vk = torch.zeros(RB, dtype=torch.int32, device="cuda")
        vp = torch.zeros_like(vk)
        k, p = kernel(*args, vk), plain(*args, vp)
        torch.cuda.synchronize()
        rec = sweep_parity(f"shadow {q}", k, p, vk, vp, args[0],
                           "mxu " if mxu else "")
        check(rec["bitwise"] and rec["visits_equal"],
              f"{name} shadow query {q}: payload and visits equal the "
              "twin's bit for bit")
        ops = rec["visits"] * B * cluster.CLUSTER_TRIS * (
            OPS_PER_PLANE_TEST if mxu else OPS_PER_TEST)
        bound_s, bound_by = peaks.bound(ops, nbytes(*args) + nbytes(args[4]))
        bound_ms = bound_s * 1e3
        ms = event_ms(lambda: kernel(*args), 20)
        lanes_on = args[3][..., 6] > 0.0
        active = float(lanes_on.float().mean())
        dead = ~lanes_on.any(dim=1)          # blocks with every lane disabled
        rec.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                   active_share=active,
                   early_exit_trims=rec["visits"] < rec["nact"],
                   dead_blocks=int(dead.sum()),
                   dead_block_visits=int(vk[dead].sum()))
        out.append(rec)
        trim = ("the early exit trims" if rec["early_exit_trims"]
                else "no list trimmed")
        print(f"[shadow] {name} bounce {q}: {ms:.4f} ms per launch, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {ms / bound_ms:.1f}x; active "
              f"lanes {active:.4f}; visits {rec['visits']} of nact "
              f"{rec['nact']} ({trim}); {rec['dead_blocks']} of {RB} blocks "
              f"all disabled, visiting {rec['dead_block_visits']}; "
              f"{rec['hits']} occluded, on {smi}", flush=True)
    return out


def walk_shadow_queries(smi, scene, mats, cfg):
    """One NEE "pallas" frame's walks (closest hit and shadow alternating;
    the shadow walks take the NEE lanes as their alive mask); each shadow
    walk against the twin bit for bit (t, off, counters), timed, against
    its bound."""
    calls = []

    def capture(o, d, t0, mesh, alive=None):
        calls.append([x.clone() for x in (o, d, t0, alive)])
        return traversal.bvh_walk_kernel(o, d, t0, mesh, alive=alive)

    with torch.no_grad():
        golden.render_frame(scene, mats, cfg, 0, intersect_fn=wavefront
                            .make_intersect_fn_pallas(scene, capture))
    check(len(calls) == 2 * (cfg.max_bounces + 1),
          f"one NEE 'pallas' frame makes {cfg.max_bounces + 1} closest-hit "
          f"and {cfg.max_bounces + 1} shadow walks")
    m = scene.mesh
    nd = int(m.draw_count)
    out = []
    for q, (o, d, t0, alive) in enumerate(calls[1::2]):
        twin, _, touched = walk_twin((o, d, t0, alive), m, masked=True)
        ck = torch.zeros_like(twin[2])
        tk, ok = traversal.bvh_walk_kernel(o, d, t0, m, ck, alive=alive)
        torch.cuda.synchronize()
        want = walk_expected(twin, t0, alive)
        same = all(torch.equal(a, b) for a, b in zip((tk, ok, ck), want))
        check(same, f"bvh_walk shadow walk {q}: t, off and counters of the "
              "live lanes equal the twin's bit for bit")
        live = int(alive.sum())
        pops, inner, tests = (int(x) for x in ck.long().sum(0))
        ops = (live * nd * OPS_PER_SLAB + pops * OPS_PER_POP
               + inner * OPS_PER_INNER + tests * OPS_PER_TEST)
        nb = walk_bytes(m, touched, o, d, t0, alive, tk, ok)
        bound_s, bound_by = peaks.bound(ops, nb)
        bound_ms = bound_s * 1e3
        ms = event_ms(lambda: traversal.bvh_walk_kernel(o, d, t0, m,
                                                        alive=alive), 20)
        rec = dict(query=q, bitwise=same, ms=ms, bound_ms=bound_ms,
                   bound_by=bound_by, live_share=live / o.shape[0],
                   hits=int((ok >= 0).sum()), nodes_popped=pops,
                   tris_tested=tests)
        out.append(rec)
        print(f"[shadow] bvh_walk bounce {q}: {ms:.4f} ms per launch, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {ms / bound_ms:.1f}x; live "
              f"lanes {live / o.shape[0]:.4f}, {rec['hits']} hits, on {smi}",
              flush=True)
    return out


def parity_run(scene, mats, cfg, path, plain):
    """Bench loss and grads (and the vertex grads) of one 64 x 64 NEE frame
    through ``path`` ("B1", "B2", "B3"), the kernel or (``plain``) its twin,
    under deterministic algorithms -> (shadow flags or shadow walks, image,
    loss, grads, ops PyTorch names as having no deterministic form)."""
    shadow = []

    def make(s, c):
        if path == "B3":
            walk = (traversal.bvh_walk_plain if plain
                    else traversal.bvh_walk_kernel)
            calls = []

            def rec_walk(o, d, t0, mesh, alive=None):
                res = walk(o, d, t0, mesh, alive=alive)
                calls.append(res)
                if len(calls) % 2 == 0:        # the shadow walk
                    shadow.append(res)
                return res

            return wavefront.make_intersect_fn_pallas(s, rec_walk)
        fn = sweep.make_intersect_fn(
            s, c, block_fn=sweep_fns(path == "B2")[1] if plain else None)
        occ = fn.occlusion_fn

        def rec_occ(*args):
            flags = occ(*args)
            shadow.append(flags)
            return flags

        fn.occlusion_fn = rec_occ
        return fn

    trainable = prender.BENCH_TRAINABLE + ("vertices",)
    target = torch.zeros((cfg.height, cfg.width, 3), device="cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss, grads = prender.scene_loss_grad(cfg, trainable, make)(
                scene, mats, 1, target)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    flags = list(shadow)
    with torch.no_grad():
        image = golden.render_frame(scene, mats, cfg, 1,
                                    intersect_fn=make(scene, cfg))
    return flags, image, loss, grads, nondet


def train_parity(smi, lit, lit_split, mats):
    """Kernel path against plain-twin path on a 64 x 64 lit bunny, NEE+MIS,
    2 bounces, for B1, B2 and B3: shadow flags (B3: shadow walks' t and
    off), image and loss bitwise; grads bitwise under deterministic
    algorithms, or within 1e-6 of each leaf's max |g| where an op has no
    deterministic CUDA form (named)."""
    out = {}
    cfg = RenderConfig(**PARITY)
    for path, scene, c in (("B1", lit, cfg),
                           ("B2", lit, cfg.replace(cluster_kernel="mxu")),
                           ("B3", lit_split, cfg)):
        fk, ik, lk, gk, nk = parity_run(scene, mats, c, path, False)
        fp, ip, lp, gp, np_ = parity_run(scene, mats, c, path, True)
        nondet = sorted(set(nk) | set(np_))
        same_flags = len(fk) == len(fp) == c.max_bounces + 1 and all(
            all(torch.equal(a, b) for a, b in zip(x, y))
            if isinstance(x, tuple) else torch.equal(x, y)
            for x, y in zip(fk, fp))
        grad_err = {k: float((gk[k] - gp[k]).abs().max())
                    / max(float(gp[k].abs().max()), 1e-30) for k in gk}
        bitwise = all(torch.equal(gk[k], gp[k]) for k in gk)
        rec = dict(shadow_equal=same_flags, image_equal=bool(
            torch.equal(ik, ip)), loss_equal=bool(torch.equal(lk, lp)),
            grads_bitwise=bitwise, grad_rel_err=grad_err,
            nondeterministic_ops=nondet,
            occluded=int(sum(int(f.sum()) for f in fk)) if path != "B3"
            else None)
        out[path] = rec
        print(f"[parity] train {path}: {json.dumps(rec)}", flush=True)
        check(same_flags and rec["image_equal"] and rec["loss_equal"],
              f"train {path}: kernel and twin paths give the same shadow "
              "queries, image and loss bit for bit (64 x 64 lit bunny, "
              "NEE+MIS)")
        if nondet:
            check(max(grad_err.values()) <= 1e-6,
                  f"train {path}: grads within 1e-6 of each leaf's max |g| "
                  f"(no deterministic CUDA form: {nondet})")
        else:
            check(bitwise, f"train {path}: grads bitwise equal under "
                  "deterministic algorithms")
    return out


def step_split(scene, mats, cfg, renderer):
    """Host ms (synchronized) of the forward (building the graph) and of
    the backward of one bench-loss step."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in reg.get_params(scene, None,
                                         prender.BENCH_TRAINABLE).items()}
    s, _ = reg.apply_params(scene, None, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = golden.render_frame(s, mats, cfg, 1, intersect_fn=dispatch
                              .get_intersect_fn(renderer, s, cfg))
    loss = torch.mean(img * img)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def inverse_run(smi, cam_scene_cfg):
    """The dry run's training check on the Cornell box, NEE+MIS: one train
    step lowers the loss of frame 0 with every grad finite; a 5-step
    ``run_inverse_rendering`` (checkpoints every 2 steps) lowers the loss;
    3 steps, a checkpoint and a resume to 5 reproduce its loss curve."""
    scene, cam = cam_scene_cfg
    cfg = RenderConfig(**INVERSE)
    target = torch.zeros((cfg.height, cfg.width, 3), device="cuda")
    step = prender.make_train_step(
        cfg, functools.partial(torch.optim.Adam, lr=1e-2),
        DRY_RUN_TRAINABLE, "auto")
    s1, c1, state, loss0 = step(scene, cam, None, 0, target)
    loss1, _ = prender.scene_loss_grad(cfg, DRY_RUN_TRAINABLE, "auto")(
        s1, c1, 0, target)
    finite, norm = grad_stats(state.grads)
    check(finite and norm > 0.0, f"[inverse] every grad leaf of "
          f"{DRY_RUN_TRAINABLE} is finite, norm {norm:.6g}")
    check(float(loss1) < float(loss0), f"[inverse] one step lowers the "
          f"frame-0 loss: {float(loss0):.6g} -> {float(loss1):.6g}")

    def inv(steps):
        return InverseRenderConfig(trainable=DRY_RUN_TRAINABLE,
                                   learning_rate=0.1, steps=steps,
                                   vary_seed=True, log_every=1)

    with tempfile.TemporaryDirectory() as tmp:
        _, _, hist_a = run_inverse_rendering(
            scene, cam, target, cfg, inv(5), renderer="auto",
            checkpoint_dir=os.path.join(tmp, "a"), checkpoint_every=2)
        run_inverse_rendering(scene, cam, target, cfg, inv(3),
                              renderer="auto",
                              checkpoint_dir=os.path.join(tmp, "b"),
                              checkpoint_every=2)
        _, _, hist_b = run_inverse_rendering(
            scene, cam, target, cfg, inv(5), renderer="auto",
            checkpoint_dir=os.path.join(tmp, "b"), resume=True)
    losses = [h["loss"] for h in hist_a]
    check(losses[-1] < losses[0], f"[inverse] 5 steps lower the loss: "
          + " -> ".join(f"{x:.6g}" for x in losses))
    full = {h["step"]: h["loss"] for h in hist_a}
    worst = max(abs(h["loss"] - full[h["step"]]) / abs(full[h["step"]])
                for h in hist_b)
    check([h["step"] for h in hist_b] == [3, 4] and worst <= 1e-5,
          f"[inverse] the resumed run reproduces steps 3-4 of the loss "
          f"curve (max rel diff {worst:.3g} <= 1e-5)")
    ms = [(b["wall_s"] - a["wall_s"]) * 1e3
          for a, b in zip(hist_a, hist_a[1:])]
    print(f"[inverse] Cornell 128^2 NEE+MIS, {DRY_RUN_TRAINABLE}: "
          f"{sum(ms) / len(ms):.2f} ms per step after the first, losses "
          f"{losses}, on {smi}", flush=True)
    return dict(losses=losses, resumed_losses=[h["loss"] for h in hist_b],
                resume_max_rel_diff=worst, ms_per_step=sum(ms) / len(ms),
                loss_before_after_one_step=[float(loss0), float(loss1)])


def vertex_steps(smi, lit, cam):
    """3 inverse-rendering steps of the lit 512^2 bunny (NEE+MIS) moving
    its vertices (and albedo) through B1."""
    cfg = RenderConfig(**BUNNY, **NEE)
    target = torch.zeros((cfg.height, cfg.width, 3), device="cuda")
    reset_counts()
    out, _, hist = run_inverse_rendering(
        lit, cam, target, cfg, InverseRenderConfig(
            trainable=("albedo", "vertices"), learning_rate=1e-3, steps=3,
            vary_seed=True, log_every=1), renderer="auto")
    counts = read_counts()
    check(counts == sweep_counts(B1=30),
          f"[inverse] 3 lit-bunny steps launched {counts} (B1: 10 per step)")
    moved = float((out.mesh.vertices - lit.mesh.vertices).abs().max())
    check(moved > 0.0 and all(math.isfinite(h["grad_norm"]) for h in hist),
          f"[inverse] the vertices moved (max {moved:.3g}), grads finite")
    ms = [hist[0]["wall_s"] * 1e3] + [(b["wall_s"] - a["wall_s"]) * 1e3
                                      for a, b in zip(hist, hist[1:])]
    print(f"[inverse] lit bunny 512^2 NEE+MIS, albedo + vertices through "
          f"B1: ms per step {', '.join(f'{x:.1f}' for x in ms)} (the first "
          f"includes the optimizer's set-up), on {smi}", flush=True)
    return dict(ms_per_step=ms, launches=counts, max_vertex_move=moved)


def train_phase(smi, scene, cam, split_scene, cscene, ccam):
    """The [train] phase: every cell, the shadow queries, the parity, the
    inverse-rendering run -> its JSON record."""
    mats = camera_matrices(cam, 1.0)
    cmats = camera_matrices(ccam, 1.0)
    lit, lit_split = lit_bunny_scene(), lit_bunny_scene(
        max_blas_tris=dispatch.PALLAS_MAX_TRIS)
    bunny, cornell = RenderConfig(**BUNNY), RenderConfig(**CORNELL)
    cells = {}
    for label, sc, m, cfg, renderer, per_step in (
            ("cornell 1024^2", cscene, cmats, cornell, "auto",
             {"H1": 5}),
            ("cornell 1024^2 nee+mis", cscene, cmats,
             cornell.replace(**NEE), "auto", {"H1": 5}),
            ("bunny 512^2 auto (B1)", scene, mats, bunny, "auto",
             {"B1": 5}),
            ("bunny 512^2 mxu (B2)", scene, mats,
             bunny.replace(cluster_kernel="mxu"), "auto", {"B2": 5}),
            ("bunny 512^2 pallas (B3)", split_scene, mats, bunny, "pallas",
             {"B3": 5}),
            ("lit bunny 512^2 nee+mis auto (B1)", lit, mats,
             bunny.replace(**NEE), "auto", {"B1": 10}),
            ("lit bunny 512^2 nee+mis mxu (B2)", lit, mats,
             bunny.replace(cluster_kernel="mxu", **NEE), "auto", {"B2": 10}),
            ("lit bunny 512^2 nee+mis pallas (B3)", lit_split, mats,
             bunny.replace(**NEE), "pallas", {"B3": 10})):
        cells[label] = train_cell(smi, label, sc, m, cfg, renderer,
                                  per_step)

    shadow = {
        "B1": sweep_shadow_queries(smi, lit, mats, bunny.replace(**NEE)),
        "B2": sweep_shadow_queries(smi, lit, mats, bunny.replace(
            cluster_kernel="mxu", **NEE)),
        "B3": walk_shadow_queries(smi, lit_split, mats,
                                  bunny.replace(**NEE))}
    parity = train_parity(smi, lit, lit_split, mats)

    split = {}
    for label, sc, m, cfg in (("cornell 1024^2", cscene, cmats, cornell),
                              ("bunny 512^2 auto (B1)", scene, mats, bunny)):
        fwd, bwd = step_split(sc, m, cfg, "auto")
        split[label] = dict(forward_ms=fwd, backward_ms=bwd,
                            backward_share=bwd / (fwd + bwd))
        print(f"[profile] {label} fwd+bwd step: forward {fwd:.2f} ms, "
              f"backward {bwd:.2f} ms ({bwd / (fwd + bwd):.1%} of the step;"
              f" host clock, synchronized), on {smi}", flush=True)
    profiles = {}
    for label, sc, m, cfg in (("cornell 1024^2", cscene, cmats, cornell),
                              ("bunny 512^2", scene, mats, bunny)):
        loss_grad = prender.scene_loss_grad(cfg, prender.BENCH_TRAINABLE,
                                            "auto")
        target = torch.zeros((cfg.height, cfg.width, 3), device="cuda")
        profiles[f"{label} fwd+bwd step"] = device_profile(
            smi, f"{label} fwd+bwd step",
            lambda: loss_grad(sc, m, 7, target))

    inverse = inverse_run(smi, cornell_box_scene(device="cuda"))
    vertices = vertex_steps(smi, lit, cam)
    return dict(cells=cells, shadow=shadow, parity=parity,
                step_split=split, profiles=profiles, inverse=inverse,
                lit_bunny_vertex_steps=vertices, card=smi)


def edge_query(smi, scene, mats, cfg):
    """The silhouette estimator's widened query of one frame's primary rays
    (miter-expanded Möller-Trumbore tables, ``t_init = KINF``) through B1
    and its twin on the same inputs: payload and visits bit for bit, then
    B1's ms per launch (CUDA events, 20 launches) against its operation
    bound, the twin's ms, active clusters and visits."""
    W, H = cfg.width, cfg.height
    dirs = primary_ray_directions(mats, W, H).reshape(-1, 3)
    origin = mats.position.expand_as(dirs).contiguous()
    pix_ang = 2.0 * mats.inverse_projection[1, 1] / float(H)
    seen = {}

    def both(*args):
        vk, vp = torch.zeros_like(args[0]), torch.zeros_like(args[0])
        seen.update(args=[x.clone() for x in args],
                    k=cluster.cluster_sweep_kernel(*args, vk),
                    p=cluster.cluster_sweep_plain(*args, vp), vk=vk, vp=vp)
        return seen["k"]

    with torch.no_grad():
        sweep.tri_edge_candidate_sweep(scene, origin, dirs, cfg, pix_ang,
                                       block_fn=both)
    torch.cuda.synchronize()
    label = f"edge {W}x{H}"
    rec = sweep_parity(label, seen["k"], seen["p"], seen["vk"], seen["vp"],
                       seen["args"][0])
    check(rec["bitwise"] and rec["visits_equal"],
          f"{label} query: B1's payload and visits equal the twin's bit for "
          "bit")
    args = seen["args"]
    B = args[3].shape[1]
    ops = rec["visits"] * B * cluster.CLUSTER_TRIS * OPS_PER_TEST
    bound_s, bound_by = peaks.bound(ops, nbytes(*args) + nbytes(args[4]))
    bound_ms = bound_s * 1e3
    ms = event_ms(lambda: cluster.cluster_sweep_kernel(*args), 20)
    plain = event_ms(lambda: cluster.cluster_sweep_plain(*args), 1)
    rec.update(ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
               nact_per_block=spread(args[0]),
               visits_per_block=spread(seen["vk"]))
    print(f"[edge] {label} query (B1): {ms:.4f} ms per launch, plain "
          f"{plain:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{ms / bound_ms:.1f}x; nact {rec['nact']}, visits "
          f"{rec['visits']}, {rec['hits']} of {args[3].shape[0] * B} rays "
          f"find a widened triangle, on {smi}", flush=True)
    return rec


def edge_cell(smi, label, scene, cam, cfg, per_step):
    """fwd+bwd of mean((img - target)^2) over ``EDGE_TRAINABLE`` under
    ``edge_grads`` through dispatch "auto", the target half the hard
    estimator's frame 0: 1 warm-up step, then 4 steps timed on the host
    clock (synchronized), every kernel's launch count set to 0 just before
    them and read just after; ``per_step`` {kernel: launches per step} is
    what the path must launch."""
    mats = camera_matrices(cam, 1.0)
    with torch.no_grad():
        target = 0.5 * golden.render_frame(scene, mats, cfg.replace(
            edge_grads=False), 0, dispatch.get_intersect_fn("auto", scene,
                                                            cfg))
    loss_grad = prender.scene_loss_grad(cfg, EDGE_TRAINABLE, "auto")
    loss_grad(scene, cam, 0, target)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for frame in range(1, 5):
        (loss, grads), s = sync_time(
            lambda: loss_grad(scene, cam, frame, target))
        times.append(s * 1e3)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite, norm = grad_stats(grads)
    want = sweep_counts(**{k: 4 * n for k, n in per_step.items()})
    check(counts == want, f"[edge] {label}: 4 steps launched {counts} "
          f"(expected {want})")
    check(finite and norm > 0.0, f"[edge] {label}: the grads of "
          f"{EDGE_TRAINABLE} are finite, norm {norm:.6g} > 0")
    ms = sum(times) / len(times)
    rate = segments_per_s(cfg, ms / 1e3)
    print(f"[edge] {label}: {ms:.2f} ms/step (4 steps after 1 warm-up, "
          f"{min(times):.2f}-{max(times):.2f}), {rate:.2f} Mrays/s (both "
          f"paths count as one), peak {peak:.2f} GiB, loss {float(loss):.6g}, "
          f"grad norm {norm:.6g}, launches {counts}, on {smi}", flush=True)
    return dict(ms_per_step=ms, step_ms=times, mrays_s=rate, peak_gib=peak,
                loss=float(loss), grad_norm=norm, launches=counts)


def edge_parity(smi, scene, lit, mats):
    """Kernel path against plain-twin path on 64 x 64 ``edge_grads`` frames
    of the bunny (NEE off) and the lit bunny (NEE+MIS), through B1 and B2
    (whose widened query is B1 or its twin): the widened query's payload,
    the shadow flags, image and loss bit for bit; grads bitwise under
    deterministic algorithms (within 1e-6 of each leaf's max |g| where
    PyTorch names an op without a deterministic form)."""
    out = {}
    cfg = RenderConfig(**dict(PARITY, use_nee=False, edge_grads=True))
    for label, sc, c in (
            ("bunny", scene, cfg),
            ("lit bunny nee+mis", lit, cfg.replace(**NEE))):
        out[f"{label} edge query"] = edge_query(smi, sc, mats, c)
        for path, cc in (("B1", c), ("B2", c.replace(cluster_kernel="mxu"))):
            fk, ik, lk, gk, nk = parity_run(sc, mats, cc, path, False)
            fp, ip, lp, gp, np_ = parity_run(sc, mats, cc, path, True)
            nondet = sorted(set(nk) | set(np_))
            want_flags = 2 * (cc.max_bounces + 1) if cc.use_nee else 0
            same_flags = len(fk) == len(fp) == want_flags and all(
                torch.equal(x, y) for x, y in zip(fk, fp))
            grad_err = {k: float((gk[k] - gp[k]).abs().max())
                        / max(float(gp[k].abs().max()), 1e-30) for k in gk}
            bitwise = all(torch.equal(gk[k], gp[k]) for k in gk)
            rec = dict(shadow_equal=same_flags,
                       image_equal=bool(torch.equal(ik, ip)),
                       loss_equal=bool(torch.equal(lk, lp)),
                       grads_bitwise=bitwise, grad_rel_err=grad_err,
                       nondeterministic_ops=nondet)
            out[f"{label} {path}"] = rec
            print(f"[parity] edge {label} {path}: {json.dumps(rec)}",
                  flush=True)
            check(same_flags and rec["image_equal"] and rec["loss_equal"],
                  f"edge {label} {path}: kernel and twin paths give the same "
                  "shadow queries, image and loss bit for bit (64 x 64)")
            if nondet:
                check(max(grad_err.values()) <= 1e-6,
                      f"edge {label} {path}: grads within 1e-6 of each "
                      f"leaf's max |g| (no deterministic CUDA form: {nondet})")
            else:
                check(bitwise, f"edge {label} {path}: grads bitwise equal "
                      "under deterministic algorithms")
    return out


def edge_vertex_steps(smi, lit, cam):
    """3 Adam steps of the lit bunny's vertices (512^2, NEE+MIS,
    ``edge_grads``, through B1) on the bench loss, mean(img^2), over one
    fixed frame, so the loss is a function of the vertices alone and must
    fall.  (Against a copy moved a few pixels the loss sits at the floor of
    the estimator's hard events: Adam's first steps move every vertex by
    the learning rate, and the pixels whose later-bounce visibility, or
    silhouette over the same mesh, flips outweigh the gain.)"""
    cfg = RenderConfig(**BUNNY, **NEE, edge_grads=True)
    target = torch.zeros((cfg.height, cfg.width, 3), device="cuda")
    reset_counts()
    _, _, hist = run_inverse_rendering(
        lit, cam, target, cfg, InverseRenderConfig(
            trainable=("vertices",), learning_rate=1e-3, steps=3,
            vary_seed=False, log_every=1), renderer="auto")
    counts = read_counts()
    check(counts == sweep_counts(B1=3 * EDGE_LIT_B1),
          f"[edge] 3 lit-bunny vertex steps launched {counts} (B1: "
          f"{EDGE_LIT_B1} per step)")
    losses = [h["loss"] for h in hist]
    check(losses[-1] < losses[0], "[edge] 3 Adam steps of the vertices "
          "lower the loss: " + " -> ".join(f"{x:.6g}" for x in losses))
    ms = [(b["wall_s"] - a["wall_s"]) * 1e3 for a, b in zip(hist, hist[1:])]
    print(f"[edge] lit bunny 512^2 NEE+MIS vertex steps through B1: losses "
          f"{losses}, ms per step after the first "
          f"{', '.join(f'{x:.1f}' for x in ms)}, on {smi}", flush=True)
    return dict(losses=losses, ms_per_step=ms, launches=counts)


def edge_phase(smi, scene, cam, cscene, ccam):
    """The [edge] phase: the silhouette estimator's fwd+bwd cells, its
    widened query through B1 at full size, kernel-vs-twin parity at 64^2,
    3 vertex steps -> its JSON record."""
    mats = camera_matrices(cam, 1.0)
    lit = lit_bunny_scene()
    bunny = RenderConfig(**BUNNY, edge_grads=True)
    nb = bunny.max_bounces
    query = edge_query(smi, scene, mats, bunny)
    cells = {}
    for label, sc, c, cfg, per_step in (
            ("bunny 512^2 auto (B1)", scene, cam, bunny,
             {"B1": 1 + 2 * nb}),
            ("bunny 512^2 mxu (B2; widened query B1)", scene, cam,
             bunny.replace(cluster_kernel="mxu"), {"B1": 1, "B2": 2 * nb}),
            ("lit bunny 512^2 nee+mis auto (B1)", lit, cam,
             bunny.replace(**NEE), {"B1": EDGE_LIT_B1}),
            ("cornell 1024^2 (brute; H1 after the widened query)", cscene,
             ccam, RenderConfig(**CORNELL, edge_grads=True),
             {"H1": 2 * nb})):
        cells[label] = edge_cell(smi, label, sc, c, cfg, per_step)
    loss_grad = prender.scene_loss_grad(bunny, EDGE_TRAINABLE, "auto")
    target = torch.zeros((bunny.height, bunny.width, 3), device="cuda")
    profile = device_profile(smi, "bunny 512^2 edge_grads fwd+bwd step",
                             lambda: loss_grad(scene, cam, 7, target))
    parity = edge_parity(smi, scene, lit, mats)
    steps = edge_vertex_steps(smi, lit, cam)
    return dict(query=query, cells=cells, profile=profile, parity=parity,
                vertex_steps=steps, card=smi)


def compact_cell(smi, label, scene, mats, cfg, frame_fn_name):
    """Forward frames with compaction off and on: per setting 1 warm-up and
    3 frames timed (host clock, synchronized), every kernel's launch count
    set to 0 just before and read just after, the sweep queries of one
    frame captured and timed (CUDA events, 20 launches each); the two
    settings' frame 5 compared."""
    out = {}
    images = {}
    for compact in (False, True):
        c = cfg.replace(compact=compact)
        fn = dispatch.get_render_frame(frame_fn_name, scene, c)
        with torch.no_grad():
            fn(scene, mats, c, 0)
            reset_counts()
            _, s = sync_time(lambda: [fn(scene, mats, c, f)
                                      for f in (1, 2, 3)])
            counts = read_counts()
            images[compact] = fn(scene, mats, c, 5)
            queries = []

            def capture(*args):
                queries.append([x.clone() for x in args])
                return cluster.cluster_sweep_kernel(*args)

            if fn.backend == "sweep":
                golden.render_frame(scene, mats, c, 0, sweep.make_intersect_fn(
                    scene, c, block_fn=capture))
            profile = device_profile(
                smi, f"{label} frame, compaction "
                f"{'on' if compact else 'off'}", lambda: fn(scene, mats, c, 7),
                top=6)
        per_launch = [event_ms(lambda: cluster.cluster_sweep_kernel(*q), 20)
                      for q in queries]
        rays = [int(q[3].shape[0] * q[3].shape[1]) for q in queries]
        out["on" if compact else "off"] = dict(
            ms_per_frame=s / 3 * 1e3, launches=counts,
            b1_ms_per_launch=per_launch, b1_rays_per_launch=rays,
            profile=profile)
        print(f"[compact] {label} compaction {'on' if compact else 'off'}: "
              f"{s / 3 * 1e3:.2f} ms/frame (3 frames after 1 warm-up), "
              f"launches {counts}"
              + (f", B1 ms per launch {[round(x, 4) for x in per_launch]} "
                 f"over {rays} rays" if queries else "") + f", on {smi}",
              flush=True)
    a, b = images[False], images[True]
    differ = float(((a - b).abs().amax(dim=-1) > 0.0).float().mean())
    out.update(bitwise=bool(torch.equal(a, b)), pixels_differ=differ,
               agree_1e3=image_agreement(a, b, 1e-3))
    print(f"[compact] {label}: compacted frame equals the plain frame bit "
          f"for bit: {out['bitwise']}; {differ:.6f} of pixels differ, "
          f"{out['agree_1e3']:.6f} agree to 1e-3", flush=True)
    check(bool(torch.isfinite(b).all()) and out["agree_1e3"] >= 0.99,
          f"[compact] {label}: the compacted frame is finite and matches the "
          f"plain frame to 1e-3 on {out['agree_1e3']:.4f} of pixels (>= 0.99)")
    return out


def compact_phase(smi, scene, mats):
    """The [compact] phase: the JAX bench's bsdf_row forward (brute force,
    no kernel) and the RR bunny through B1, compaction off and on, with the
    alive share per bounce -> its JSON record."""
    fscene, fcam = full_bsdf_scene(device="cuda")
    fmats = camera_matrices(fcam, 1.0)
    bsdf = RenderConfig(width=1024, height=1024, samples=1, max_bounces=8,
                        sky="black", use_rr=True)
    out = {}
    for label, sc, m, cfg in (
            ("full_bsdf 1024^2 8 bounces rr (brute)", fscene, fmats, bsdf),
            ("bunny 512^2 rr from bounce 1 (B1)", scene, mats,
             RenderConfig(**BUNNY, use_rr=True, rr_start_bounce=1))):
        alive = golden.alive_per_bounce(
            sc, m, cfg, 0, dispatch.get_intersect_fn("auto", sc, cfg))
        share = [float(x) / (cfg.width * cfg.height) for x in alive]
        print(f"[compact] {label}: alive share entering each bounce "
              f"{[round(x, 4) for x in share]} (count_alive_segments "
              f"{int(alive.sum())} of {len(share) * cfg.width * cfg.height}); "
              f"compact_from {cfg.compact_from_resolved}, on {smi}",
              flush=True)
        rec = compact_cell(smi, label, sc, m, cfg, "auto")
        rec.update(alive_share=share, compact_from=cfg.compact_from_resolved)
        out[label] = rec
    check(out["full_bsdf 1024^2 8 bounces rr (brute)"]["bitwise"],
          "[compact] the brute-force compacted full_bsdf frame equals the "
          "plain frame bit for bit")
    b1 = out["bunny 512^2 rr from bounce 1 (B1)"]
    check(all(b1[k]["launches"] == sweep_counts(B1=15, T1=15)
              for k in ("off", "on")),
          "[compact] 3 RR bunny frames launched B1 and T1 15 times each with "
          "compaction off and on")
    return out


def serve_phase(smi, scene, cam, cscene, ccam):
    """The [serve] phase: the progressive ``Renderer`` at full width (the
    512^2 bunny through dispatch "auto" -> B1, then the 1024^2 Cornell box
    through brute force): 8 frames bit for bit with the chain of
    ``golden.render_step`` calls, edits that reset it to a fresh frame 0,
    bloom + tonemap + gamma post-processing written to a PNG and read back
    -> its JSON record."""
    cfg = RenderConfig(**BUNNY, bloom=True, tonemap="aces", gamma=2.2)
    mats = camera_matrices(cam, 1.0)
    with torch.no_grad():
        want = None
        for f in range(SERVE_FRAMES):
            want = golden.render_step(scene, mats, cfg, f, want)
    r = Renderer(scene, cam, cfg)
    check(r.device.type == "cuda", f"[serve] the Renderer defaults to the "
          f"card ({r.device})")
    torch.cuda.synchronize()
    reset_counts()
    times = []
    for _ in range(SERVE_FRAMES):
        _, s = sync_time(lambda: r.step(1))
        times.append(s * 1e3)
    counts = read_counts()
    check(counts == sweep_counts(B1=5 * SERVE_FRAMES, T1=5 * SERVE_FRAMES),
          f"[serve] {SERVE_FRAMES} Renderer steps launched {counts} (B1 5 "
          "per frame)")
    check(r.frame_count == SERVE_FRAMES and torch.equal(r.image, want),
          f"[serve] {SERVE_FRAMES} Renderer steps equal the chain of "
          "golden.render_step calls bit for bit")
    check_image(r.image, "[serve] bunny")
    frame_ms = sum(times[1:]) / (len(times) - 1)

    # the sweep's tables, rebuilt by dispatch on every frame
    sweep.make_intersect_fn(scene, cfg)
    _, s = sync_time(lambda: [sweep.make_intersect_fn(scene, cfg)
                              for _ in range(5)])
    tables_ms = s / 5 * 1e3
    profile = device_profile(smi, "[serve] bunny 512^2 Renderer.step",
                             lambda: r.step(1), top=8)

    # every edit resets accumulation: the next image is a fresh frame 0
    edits = {}
    for label, edit in (
            ("update_material", lambda: r.update_material(
                0, albedo=(0.9, 0.2, 0.2))),
            ("set_camera", lambda: r.set_camera(
                position=(cam.position + torch.tensor(
                    [0.05, 0.0, 0.0], device="cuda")).tolist()))):
        edit()
        check(r.frame_count == 0, f"[serve] {label} resets the frame counter")
        with torch.no_grad():
            fresh = golden.render_step(r.scene, camera_matrices(r.camera,
                                                                1.0),
                                       cfg, 0, None)
        edits[label] = bool(torch.equal(r.step(1), fresh))
        check(edits[label], f"[serve] after {label} the next image equals a "
              "fresh frame 0 bit for bit")

    # post-processing: bloom, ACES, gamma 2.2 -> uint8 -> PNG -> read back,
    # on the card through P1
    r.output()
    reset_counts()
    out, s = sync_time(r.output)
    post_ms = s * 1e3
    post_launches = read_counts()
    check(post_launches == zeros(P1=2 * len(post.pyramid(512, 512))),
          f"[serve] output() launched {post_launches} (P1: the pyramid's "
          "levels down and up, and the composite)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.png")
        r.save_png(path)
        back = read_png(path)
    check(out.shape == (512, 512, 3) and out.dtype == np.uint8
          and np.array_equal(back, out), "[serve] output() (bloom, aces, "
          "gamma 2.2) is 512 x 512 uint8 and its PNG reads back the same")
    with torch.no_grad():
        cpu = renderer_module._finalize(
            r.image.cpu(), "aces", 2.2, True, cfg.bloom_threshold,
            cfg.bloom_knee, cfg.bloom_strength).numpy()
    lsb = int(np.abs(cpu.astype(int) - out.astype(int)).max())
    check(lsb <= 1, f"[serve] the card's post-processing is within {lsb} "
          "LSB of the CPU's")
    print(f"[serve] bunny 512^2 Renderer ({SERVE_FRAMES} frames, B1): "
          f"{frame_ms:.2f} ms/frame after the first (host clock, "
          f"synchronized; {min(times):.2f}-{max(times):.2f}), "
          f"{segments_per_s(cfg, frame_ms / 1e3):.2f} Mrays/s; profiled "
          f"{profile['device_ms'] / profile['wall_ms']:.1%} busy; the "
          f"sweep's tables (built per frame) {tables_ms:.2f} ms = "
          f"{tables_ms / frame_ms:.1%} of a frame; output() {post_ms:.2f} "
          f"ms; launches {counts}, output() {named(post_launches)}, on "
          f"{smi}", flush=True)

    ccfg = RenderConfig(**CORNELL)
    rc = Renderer(cscene, ccam, ccfg)
    rc.step(1)
    reset_counts()
    _, s = sync_time(lambda: rc.step(3))
    ccounts = read_counts()
    check(ccounts == zeros(T1=15, H1=15) and rc.frame_count == 4,
          "[serve] Cornell 1024^2 Renderer steps launch no sweep or walk "
          "(brute force), H1 and T1 5 times a step")
    check(bool(torch.isfinite(rc.image).all())
          and 0.01 < float(rc.image.mean()) < 3,
          f"[serve] Cornell image finite, mean {float(rc.image.mean()):.4f}")
    cornell_ms = s / 3 * 1e3
    cprofile = device_profile(smi, "[serve] cornell 1024^2 Renderer.step",
                              lambda: rc.step(1), top=6)
    print(f"[serve] Cornell 1024^2 Renderer (brute force): {cornell_ms:.2f} "
          f"ms/frame (3 frames after 1), profiled "
          f"{cprofile['device_ms'] / cprofile['wall_ms']:.1%} busy, on {smi}",
          flush=True)
    return dict(frame_ms=frame_ms, step_ms=times, launches=counts,
                tables_ms=tables_ms, tables_share=tables_ms / frame_ms,
                post_ms=post_ms, post_launches=post_launches,
                post_lsb_vs_cpu=lsb, edits=edits,
                profile=profile, cornell_frame_ms=cornell_ms,
                cornell_profile=cprofile, card=smi)


def run_cli(args, timeout=600):
    """``python -m wc_path_tracer_tpu_torch ARGS`` in a subprocess from the
    repository root -> (stdout, stderr, seconds); a non-zero exit fails."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "wc_path_tracer_tpu_torch",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    s = time.perf_counter() - t0
    check(proc.returncode == 0, f"[cli] {' '.join(args[:3])} ... exits 0 "
          f"({s:.1f} s)" + ("" if proc.returncode == 0
                            else f":\n{proc.stderr[-3000:]}"))
    return proc.stdout, proc.stderr, s


def frame_records(path, n, per_frame, what):
    recs = [json.loads(line) for line in open(path)]
    check(len(recs) == n and all(
        0.0 < rec["alive_fraction"] <= 1.0 and rec["kernel_launches"]
        == per_frame for rec in recs),
        f"[cli] {what}: {n} frame records, alive_fraction in (0, 1], "
        f"launches {per_frame} per frame")
    return recs


def cli_phase(smi, kind):
    """The [cli] phase: the command-line interface in subprocesses, on the
    card by default: the glTF bunny at 512^2 (B1) with bloom, metrics and a
    checkpoint, resumed for 2 more frames and held against a Renderer; the
    same through "pallas" (B3); 5 inverse-rendering steps of the 128^2
    Cornell box; ``info`` -> its JSON record."""
    bunny = ["--gltf", BUNNY_GLB, "--width", "512", "--height", "512",
             "--bloom"]
    b1 = named(sweep_counts(B1=5, T1=5))
    b3 = named(zeros(B3=5, T1=5))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        p = functools.partial(os.path.join, tmp)
        _, _, s = run_cli(["render", *bunny, "--frames", "4", "--metrics",
                           p("m1.jsonl"), "--checkpoint", p("ck"), "--out",
                           p("a.png")])
        first = frame_records(p("m1.jsonl"), 4, b1, "bunny render")
        _, err, s2 = run_cli(["render", *bunny, "--frames", "2", "--resume",
                              p("ck"), "--metrics", p("m2.jsonl"), "--out",
                              p("b.png")])
        resumed = frame_records(p("m2.jsonl"), 2, b1, "resumed render")
        check("resumed at frame 4" in err and [r["frame"] for r in resumed]
              == [5, 6], "[cli] the resume continues at frame 5")
        scene, cam = gltf_scene(BUNNY_GLB, device="cuda")
        want = Renderer(scene, cam, RenderConfig(**BUNNY, bloom=True))
        want.step(6)
        png = read_png(p("b.png"))
        check(png.shape == (512, 512, 3) and np.array_equal(
            png, want.output()), "[cli] the resumed PNG equals a Renderer's "
            "6-frame output bit for bit")
        _, _, s3 = run_cli(["render", *bunny, "--renderer", "pallas",
                            "--frames", "2", "--metrics", p("m3.jsonl"),
                            "--out", p("c.png")])
        pallas = frame_records(p("m3.jsonl"), 2, b3, "'pallas' render")
        check(read_png(p("c.png")).shape == (512, 512, 3),
              "[cli] the 'pallas' PNG is 512 x 512")
        _, err, s4 = run_cli(["invert", "--scene", "cornell", "--width",
                              "128", "--height", "128", "--nee", "--steps",
                              "5", "--log-every", "1", "--metrics",
                              p("m4.jsonl")])
        losses = [json.loads(line)["loss"] for line in open(p("m4.jsonl"))]
        check(len(losses) == 5 and losses[-1] < losses[0],
              "[cli] invert: 5 steps, the final loss is below the first: "
              + " -> ".join(f"{x:.6g}" for x in losses))
        info, _, s5 = run_cli(["info"])
        check(kind in info and "rank: 0/1" in info,
              f"[cli] info names the card: {info.strip().splitlines()[0]}")
    for label, recs, secs in (("bunny render", first, s),
                              ("bunny resumed", resumed, s2),
                              ("bunny 'pallas' render", pallas, s3)):
        ms = [r["seconds"] * 1e3 for r in recs]
        out[label] = dict(frame_ms=ms, process_s=secs,
                          launches={k: sum(r["kernel_launches"][k]
                                           for r in recs) for k in b1},
                          alive_fraction=recs[0]["alive_fraction"])
        print(f"[cli] {label}: ms per frame {[round(x, 2) for x in ms]} "
              f"(host clock, synchronized), alive fraction "
              f"{recs[0]['alive_fraction']}, process {secs:.1f} s, launches "
              f"{out[label]['launches']}, on {smi}", flush=True)
    out["invert"] = dict(losses=losses, process_s=s4)
    out["info"] = dict(stdout=info, process_s=s5)
    return out


def dp_tasks():
    dry = dict(INVERSE, max_bounces=2)
    return [
        dict(name="bench", kind="loss_grad", scene="cornell", cfg=CORNELL,
             trainable=list(prender.BENCH_TRAINABLE), renderer="auto",
             frame=0, timed=3),
        dict(name="render_bunny", kind="render", scene="bunny_gltf",
             cfg=BUNNY, renderer="auto", frame=1),
        dict(name="dryrun_cornell", kind="train", scene="cornell", cfg=dry,
             trainable=list(DRY_RUN_TRAINABLE) + ["sphere_position"],
             renderer="auto", lr=1e-2),
        dict(name="dryrun_sweep", kind="train", scene="bunny_like2",
             cfg=dict(dry, sky="gradient"),
             trainable=["albedo", "vertices", "sphere_position"],
             renderer="auto", lr=1e-2),
        dict(name="replicate", kind="replicate", scene="cornell", cfg=CORNELL),
        dict(name="render_image", kind="render_image", scene="cornell",
             cfg=CORNELL, frame=2),
    ]


def dp_phase(smi):
    """The [dp] phase: data parallelism on the one card.  Two ranks on
    cuda:0 over gloo (NCCL refuses two ranks on one card), every collective
    on the CUDA tensors themselves, then one rank over NCCL so its
    all_reduce runs too.  Each is held against the same tasks in this
    process alone -> its JSON record."""
    torch.cuda.empty_cache()     # leave the card's memory to the ranks
    with tempfile.TemporaryDirectory() as tmp:
        tasks = dp_tasks()
        single = {t["name"]: dp_check.run_task(t, "cuda") for t in tasks}
        t0 = time.perf_counter()
        ranks = dp_check.run_ranks(tasks, 2, "gloo", "cuda:0",
                                   os.path.join(tmp, "gloo"))
        gloo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (nccl,) = dp_check.run_ranks(tasks[:1], 1, "nccl", "cuda:0",
                                     os.path.join(tmp, "nccl"))
        nccl_s = time.perf_counter() - t0
    print(f"[dp] ran 2 ranks ({ranks[0]['backend']} on {ranks[0]['device']}"
          f", {ranks[0]['device_name']}, collectives of CUDA tensors) in "
          f"{gloo_s:.1f} s and 1 rank ({nccl['backend']}) in {nccl_s:.1f} s, "
          f"on {smi}", flush=True)
    check([(r["backend"], r["world_size"]) for r in ranks + [nccl]]
          == [("gloo", 2), ("gloo", 2), ("nccl", 1)],
          "[dp] 2 gloo ranks and 1 NCCL rank on the card")

    want = single["bench"]
    worst = {}
    for r in ranks:
        got = r["bench"]
        rel = abs(float(got["loss"]) - float(want["loss"])) / float(
            want["loss"])
        check(rel <= 1e-6, f"[dp] rank {r['rank']}: Cornell 1024^2 bench "
              f"loss {float(got['loss']):.8g} within {rel:.3g} <= 1e-6 of "
              "the single process's")
        for k, g in want["grads"].items():
            err = float((got["grads"][k] - g).abs().max())
            scale = float(g.abs().max())
            rel = err / scale if scale else (0.0 if err == 0.0 else math.inf)
            worst[k] = max(worst.get(k, 0.0), rel)
    check(all(e <= 1e-5 for e in worst.values()), "[dp] every bench grad "
          "leaf within 1e-5 of its max of the single process's: "
          + ", ".join(f"{k} {e:.3g}" for k, e in worst.items()))
    check(torch.equal(nccl["bench"]["loss"], want["loss"]) and all(
        torch.equal(nccl["bench"]["grads"][k], g)
        for k, g in want["grads"].items()),
          "[dp] the NCCL world-size-1 group's loss and grads equal the "
          "single process's bit for bit")

    img = single["render_bunny"]["image"]
    shares = [float((r["render_bunny"]["image"] == img).all(-1).float()
                    .mean()) for r in ranks]
    check(all(s >= 0.999 for s in shares), f"[dp] the gathered 512^2 bunny "
          f"(B1 on each 256-row band) equals the single-process frame bit "
          f"for bit on {shares} of pixels (>= 0.999)")
    launches = {r["rank"]: {t: r[t]["launches"] for t in
                            ("render_bunny", "dryrun_sweep")} for r in ranks}
    check(all(v["render_bunny"]["B1"] == 5 and v["dryrun_sweep"]["B1"] > 0
              for v in launches.values()),
          f"[dp] each rank's band went through B1: {launches}")

    img = single["render_image"]["image"]
    check(all(torch.equal(r["render_image"]["image"], img) for r in ranks),
          "[dp] render_image_sharded's gathered Cornell 1024^2 frame (brute "
          "force, 512 rows per rank) equals the single-process frame bit for "
          "bit on both ranks")

    albedo = single["replicate"]["albedo"]   # rank 0 keeps its own
    check(all(torch.equal(r["replicate"]["albedo"], albedo)
              and r["replicate"]["before_differs"] == (r["rank"] != 0)
              for r in ranks),
          "[dp] replicate_scene's gloo broadcast of CUDA tensors hands both "
          "ranks rank 0's scene")

    for name in ("dryrun_cornell", "dryrun_sweep"):
        r0, r1 = (r[name] for r in ranks)
        finite = all(bool(torch.isfinite(g).all()) for g in
                     r0["grads"].values())
        check(finite and float(r0["loss_after"]) < float(r0["loss_before"]),
              f"[dp] {name}: every grad leaf finite, one Adam step over 2 "
              f"ranks lowers the loss {float(r0['loss_before']):.6g} -> "
              f"{float(r0['loss_after']):.6g}")
        check(all(torch.equal(r0["params"][k], r1["params"][k])
                  for k in r0["params"]),
              f"[dp] {name}: both ranks hold equal parameters after the step")
    single_ms = want["step_ms"]
    rank_ms = [r["bench"]["step_ms"] for r in ranks]
    print(f"[dp] Cornell 1024^2 bench fwd+bwd step: single process "
          f"{[round(x, 2) for x in single_ms]} ms; 2 ranks on one card "
          f"(512 rows each) {[[round(x, 2) for x in m] for m in rank_ms]} "
          f"ms (host clock, synchronized; both ranks share the card, so this "
          f"is no scaling figure), on {smi}", flush=True)
    return dict(bench_loss=float(want["loss"]), grad_rel_err=worst,
                bunny_bitwise_share=shares, launches=launches,
                single_step_ms=single_ms, rank_step_ms=rank_ms,
                dryrun={n: [float(ranks[0][n]["loss_before"]),
                            float(ranks[0][n]["loss_after"])]
                        for n in ("dryrun_cornell", "dryrun_sweep")},
                gloo_s=gloo_s, nccl_s=nccl_s, card=smi)


BVH_ARRAYS = ("node_min", "node_max", "node_left", "node_count", "indices",
              "tri_order")


def scene_meshes():
    """The [scene] phase's host-build meshes: (label, vertices, indices) of
    the glTF bunny and the bumpy spheres of 81,920 and 327,680 triangles."""
    bunny = parse_gltf(BUNNY_GLB).meshes[0]
    out = [("glTF bunny", bunny.vertices, bunny.indices)]
    for s in (6, SCENE_SUBDIV):
        out.append((f"bumpy_sphere({s})",) + bumpy_sphere(s))
    return out


def host_builds(smi, meshes):
    """(a) The port's NumPy ``build_bvh`` against ``build_bvh_native``,
    both robust, on each mesh: trees equal on every array (dtype and
    values), seconds on the card's host -> {label: record}."""
    out = {}
    for label, v, idx in meshes:
        t0 = time.perf_counter()
        nb = native.build_bvh_native(v, idx, robust=True)
        ns = time.perf_counter() - t0
        t0 = time.perf_counter()
        pb = build_bvh(v, idx, robust=True)
        ps = time.perf_counter() - t0
        tris = len(idx) // 3
        check(all(getattr(nb, k).dtype == getattr(pb, k).dtype
                  and np.array_equal(getattr(nb, k), getattr(pb, k))
                  for k in BVH_ARRAYS),
              f"[scene] {label} ({tris} triangles): the native tree equals "
              f"the NumPy builder's on every array ({', '.join(BVH_ARRAYS)})")
        out[label] = dict(triangles=tris, numpy_s=ps, native_s=ns,
                          nodes=nb.num_nodes, depth=nb.depth())
        print(f"[scene] host BVH build, {label}, {tris} triangles: NumPy "
              f"{ps:.3f} s, native {ns:.4f} s ({ps / ns:.0f}x), "
              f"{nb.num_nodes} nodes, depth {out[label]['depth']} (the "
              f"card's host CPU; card {smi})", flush=True)
    return out


def write_obj(path, v, idx):
    """``v`` (float32, written exactly) and 1-based triangle faces."""
    with open(path, "w") as f:
        f.writelines(f"v {x!r} {y!r} {z!r}\n" for x, y, z in v.tolist())
        f.writelines(f"f {a} {b} {c}\n"
                     for a, b, c in (idx.reshape(-1, 3) + 1).tolist())


def scene_cli(smi, obj, tmp):
    """(c) ``render --obj`` of the large OBJ at 512^2, 4 bounces, through
    "auto" (B1, 5 launches per frame) and "pallas" (B3, 5 per frame), T1 5
    per frame in both, each in a subprocess -> {path: record}."""
    p = functools.partial(os.path.join, tmp)
    args = ["render", "--obj", obj, "--width", "512", "--height", "512",
            "--bounces", "4", "--frames", str(SCENE_FRAMES)]
    out = {}
    for path, tag in (("auto", "B1"), ("pallas", "B3")):
        _, err, s = run_cli([*args, "--renderer", path, "--metrics",
                             p(f"{path}.jsonl"), "--checkpoint",
                             p(f"ck_{path}"), "--out", p(f"{path}.png")])
        recs = frame_records(p(f"{path}.jsonl"), SCENE_FRAMES,
                             named(sweep_counts(T1=5, **{tag: 5})),
                             f"{SCENE_TRIS}-triangle OBJ '{path}' render")
        line = next((ln for ln in err.splitlines()
                     if ln.startswith("scene: ")), "")
        check(f"{SCENE_TRIS} triangles, 1 draw(s)" in line
              and "bvh builder: native (" in line,
              f"[scene] the '{path}' process built one {SCENE_TRIS}-"
              f"triangle draw with the native builder: {line}")
        check(read_png(p(f"{path}.png")).shape == (512, 512, 3),
              f"[scene] the '{path}' PNG is 512 x 512 x 3")
        image = load_pytree(p(f"ck_{path}"), {
            "image": torch.zeros((512, 512, 3))})["image"]
        check_image(image, f"[scene] the '{path}' process's accumulated "
                    f"{SCENE_FRAMES}-frame")
        ms = [r["seconds"] * 1e3 for r in recs]
        out[path] = dict(frame_ms=ms, process_s=s, scene_line=line,
                         launches={k: sum(r["kernel_launches"][k]
                                          for r in recs)
                                   for k in named(zeros())},
                         alive_fraction=recs[0]["alive_fraction"])
        print(f"[scene] CLI render --obj, {SCENE_TRIS} triangles, 512^2, "
              f"'{path}': ms per frame {[round(x, 2) for x in ms]} (host "
              f"clock, synchronized), process {s:.1f} s, launches "
              f"{out[path]['launches']}, {line}, on {smi}", flush=True)
    return out


def scene_frame(smi, scene, mats, cfg, path, tag):
    """One in-process frame through dispatch ``path``: its launches (the
    counts set to 0 just before and read just after), peak memory and
    image -> record."""
    frame_fn = dispatch.get_render_frame(path, scene, cfg)
    check(frame_fn.backend == ("sweep" if path == "auto" else path),
          f"[scene] dispatch '{path}' picks {frame_fn.backend}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        image, s = sync_time(lambda: golden.render_step(
            scene, mats, cfg, 0, None, frame_fn=frame_fn))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(counts == sweep_counts(T1=5, **{tag: 5}),
          f"[scene] one in-process '{path}' frame launched {counts}")
    check_image(image, f"[scene] in-process '{path}'")
    print(f"[scene] in-process '{path}' frame 0 (the first on this scene): "
          f"{s * 1e3:.2f} ms, peak {peak:.2f} GiB allocated, on {smi}",
          flush=True)
    return dict(first_frame_ms=s * 1e3, peak_gib=peak, launches=counts)


def scene_sweep(smi, scene, mats, cfg):
    """(d) B1 on the large scene's primary query: bit for bit with its twin
    (``sweep_both``), ms per launch against its bound, the whole query
    (cull, sort, kernel), its cull alone (C1) and the per-frame table
    rebuild -> record."""
    queries = []

    def capture(nact, clist, bt0, rays, prev, tris):
        if not queries:
            queries.append([x.clone() for x in (nact, clist, bt0, rays, prev,
                                                tris)])
        return cluster.cluster_sweep_kernel(nact, clist, bt0, rays, prev, tris)

    with torch.no_grad():
        golden.render_frame(scene, mats, cfg, 0, intersect_fn=sweep
                            .make_intersect_fn(scene, cfg, block_fn=capture))
    args = queries[0]
    RB, B = args[3].shape[:2]
    tables = cluster.build_cluster_tables(scene.mesh)
    C = tables[0].shape[0] // cluster.CLUSTER_ROWS
    live = int(torch.all(tables[1] <= tables[2], dim=1).sum())
    o, d, t0 = primary_rays(args)
    k, p, vk, vp, nact = sweep_both((o, d, t0) + tables, cluster.RAY_BLOCK)
    rec = sweep_parity(f"{SCENE_TRIS}-triangle primary", k, p, vk, vp, nact)
    check(rec["bitwise"] and rec["visits_equal"], f"[scene] B1 on the "
          f"{SCENE_TRIS}-triangle primary query: payload and visits equal "
          "the plain twin's bit for bit")
    visits = torch.zeros(RB, dtype=torch.int32, device="cuda")
    cluster.cluster_sweep_kernel(*args, visits)
    ms = event_ms(lambda: cluster.cluster_sweep_kernel(*args), 20)
    plain = event_ms(lambda: cluster.cluster_sweep_plain(*args), 1)
    query_ms = event_ms(lambda: cluster.cluster_sweep(o, d, t0, *tables), 5)
    cull_ms = event_ms(lambda: cluster.cluster_cull_kernel(
        o, d, t0, tables[1], tables[2]), 5)
    ops = int(visits.sum()) * B * cluster.CLUSTER_TRIS * OPS_PER_TEST
    bound_s, bound_by = peaks.bound(ops, nbytes(*args) + nbytes(args[4]))
    bound_ms = bound_s * 1e3
    sweep.make_intersect_fn(scene, cfg)
    _, s = sync_time(lambda: [sweep.make_intersect_fn(scene, cfg)
                              for _ in range(3)])
    out = dict(ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
               max_abs_err=rec["max_abs_err"], parity=rec,
               query_ms=query_ms, tables_ms=s / 3 * 1e3, clusters=C,
               live_clusters=live, visits=int(visits.sum()),
               nact_per_block=spread(args[0]), visits_per_block=spread(visits),
               cull_ms=cull_ms)
    print(f"[scene] B1 primary query, {C} clusters ({live} live): "
          f"{ms:.4f} ms per launch (plain {plain:.1f} ms), bound "
          f"{bound_ms:.4f} ms ({bound_by}), {ms / bound_ms:.1f}x; "
          f"{out['visits']} block-cluster visits (nact per block mean "
          f"{out['nact_per_block']['mean']:.1f}, max "
          f"{out['nact_per_block']['max']}); whole query (cull, sort, "
          f"kernel) {query_ms:.3f} ms, of which the cull of {RB * B} rays x "
          f"{C} clusters (C1) {cull_ms:.3f} ms; the sweep's tables "
          f"(rebuilt per frame) {out['tables_ms']:.2f} ms, on {smi}",
          flush=True)
    return out


def walk_query(smi, tag, what, scene, mats, cfg):
    """B3 on ``scene``'s primary query, however many draws it has: bit for
    bit with its twin on every lane and the live lanes (``walk_twin``,
    ``walk_same``), ms per launch against its bound -> (record, the walk
    tables)."""
    m = scene.mesh
    nd = int(m.draw_count)
    queries = []

    def capture(o, d, t_init, mesh, alive=None):
        if not queries:
            queries.append([x.clone() for x in (o, d, t_init, alive)])
        return traversal.bvh_walk_kernel(o, d, t_init, mesh, alive=alive)

    with torch.no_grad():
        golden.render_frame(scene, mats, cfg, 0, intersect_fn=wavefront
                            .make_intersect_fn_pallas(scene, capture))
    tables = traversal.walk_tables(m)
    query = queries[0]
    o, d, t0, alive = query
    R = o.shape[0]
    twin, plain, touched = walk_twin(query, m)
    same = walk_same(query, m, twin)
    tp, op, cp = twin
    check(same, f"{tag} B3 on {what}, primary query: t, off and counters "
          "equal the twin's bit for bit, on every lane and the live lanes")
    tk, ok = traversal.bvh_walk_kernel(o, d, t0, m)
    ms = event_ms(lambda: traversal.bvh_walk_kernel(o, d, t0, m), 20)
    ms_live = event_ms(lambda: traversal.bvh_walk_kernel(
        o, d, t0, m, alive=alive), 20)
    pops, inner, tests = (int(x) for x in cp.long().sum(0))
    ops = (R * nd * OPS_PER_SLAB + pops * OPS_PER_POP
           + inner * OPS_PER_INNER + tests * OPS_PER_TEST)
    nb = walk_bytes(m, touched, o, d, t0, tk, ok)
    bound_s, bound_by = peaks.bound(ops, nb)
    bound_ms = bound_s * 1e3
    out = dict(ms=ms, ms_live=ms_live, plain_ms=plain, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nb,
               max_abs_err=float((tk - tp).abs().max()),
               bitwise_with_and_without_mask=same,
               hits=int((op >= 0).sum()), live=int(alive.sum()),
               nodes_popped=pops, inner_entered=inner, tris_tested=tests,
               node_records_read=int(touched[0].sum()),
               tri_records_read=int(touched[1].sum()),
               node_records=tables.nodes.shape[0],
               tri_records=tables.tris.shape[0],
               draws=nd, tree_depth=tables.depth,
               tables_build_s=tables.build_s)
    print(f"{tag} B3 primary query, {what}, {nd} draws, depth "
          f"{tables.depth}: {ms:.4f} ms all lanes, {ms_live:.4f} ms "
          f"live lanes, plain {plain:.1f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}, {nb / 1e6:.2f} MB), {ms / bound_ms:.1f}x; "
          f"{pops / R:.2f} nodes popped per ray; {inner} inner nodes "
          f"entered and {tests} triangles tested in all, reading "
          f"{out['node_records_read']} of {out['node_records']} node and "
          f"{out['tri_records_read']} of {out['tri_records']} triangle "
          f"records; walk tables built in "
          f"{tables.build_s * 1e3:.1f} ms, on {smi}", flush=True)
    return out, tables


def scene_walk(smi, scene, mats, cfg):
    """(d) B3 on the large scene's primary query, one draw ->
    ``walk_query``'s record."""
    out, tables = walk_query(smi, "[scene]", f"the {SCENE_TRIS}-triangle "
                             "OBJ", scene, mats, cfg)
    check(out["draws"] == 1 and tables.depth <= traversal.STACK_DEPTH,
          f"[scene] one draw, tree depth {tables.depth} <= "
          f"{traversal.STACK_DEPTH} stack slots")
    return out


def scene_phase(smi):
    """The [scene] phase: the native host scene pipeline and the large
    mesh end to end.  (a) host BVH builds, NumPy against native, at 20,480,
    81,920 and 327,680 triangles; (b) bunny_like_scene's 327,680-triangle
    mesh written as an OBJ; (c) ``render --obj`` of it in subprocesses on
    "auto" (B1) and "pallas" (B3); (d) B1 and B3 against their twins on its
    primary query, with times and peak memory -> its JSON record."""
    check(native.available(), "[scene] the native scene library "
          f"is built from this checkout and loaded: {native.status()}")
    meshes = scene_meshes()
    builds = host_builds(smi, meshes)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        v, idx = meshes[-1][1].copy(), meshes[-1][2]
        v[:, 1] += 1.0                  # as bunny_like_scene lifts it
        obj = os.path.join(tmp, "bumpy_sphere7.obj")
        t0 = time.perf_counter()
        write_obj(obj, v, idx)
        print(f"[scene] wrote the {SCENE_TRIS}-triangle OBJ "
              f"({os.path.getsize(obj) / 2**20:.1f} MiB) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cli = scene_cli(smi, obj, tmp)
        t0 = time.perf_counter()
        scene, cam = mesh_scene(obj, device="cuda")     # the CLI's scene
        scene_s = time.perf_counter() - t0
    mats = camera_matrices(cam, 1.0)
    cfg = RenderConfig(**BUNNY)
    frames = {path: scene_frame(smi, scene, mats, cfg, path, tag)
              for path, tag in (("auto", "B1"), ("pallas", "B3"))}
    b1 = scene_sweep(smi, scene, mats, cfg)
    b3 = scene_walk(smi, scene, mats, cfg)
    del scene
    torch.cuda.empty_cache()
    return dict(host_builds=builds, cli=cli, scene_build_s=scene_s,
                frames=frames, B1=b1, B3=b3, card=smi)


def scene_entry(scene, key, cli_key):
    """A kernel's [scene] keys for the kernels line: its launches in the
    two CLI renders and, for B1 and B3, its times on the primary query."""
    out = dict(scene_launches={path: rec["launches"][cli_key]
                               for path, rec in scene["cli"].items()})
    if key in scene:
        r = scene[key]
        out.update(scene_ms=r["ms"], scene_plain_ms=r["plain_ms"],
                   scene_bound_ms=r["bound_ms"],
                   scene_bound_by=r["bound_by"],
                   scene_max_abs_err=r["max_abs_err"],
                   scene_note=f"one launch on the primary query of the "
                              f"{SCENE_TRIS}-triangle OBJ at 512^2")
    return out


def slice_launches(serving, cli, dp, key, cli_key):
    """A kernel's launches in the [serve], [cli] and [dp] runs."""
    return dict(
        serve_launches=serving["launches"][key],
        cli_launches={label: rec["launches"][cli_key]
                      for label, rec in cli.items() if "launches" in rec},
        dp_launches={rank: {task: n[key] for task, n in per.items()}
                     for rank, per in dp["launches"].items()})


def shadow_entry(train, key):
    """A kernel's NEE shadow-query keys for the kernels line: ms per launch
    and bound averaged over the lit bunny's five shadow queries, and its
    launches in each [train] cell."""
    per = train["shadow"][key]
    by = [r["bound_by"] for r in per]
    return dict(
        shadow_ms=sum(r["ms"] for r in per) / len(per),
        shadow_bound_ms=sum(r["bound_ms"] for r in per) / len(per),
        shadow_bound_by=max(set(by), key=by.count),
        shadow_note="mean per launch over one lit 512^2 bunny NEE+MIS "
                    "frame's 5 shadow queries",
        train_launches={label: c["launches"][key]
                        for label, c in train["cells"].items()})


# [bench]: (label, arguments) of each run of the port's bench; what each must
# print follows from its arguments (bench_expected)
BENCH_RUNS = [
    ("default", []),
    ("forward-only", ["--forward-only"]),
    ("nee", ["--nee"]),
    ("bunny pallas", ["--scene", "bunny", "--size", "512", "--renderer",
                      "pallas"]),
    (f"bunny {SCENE_TRIS} auto", ["--scene", "bunny", "--size", "512",
                                  "--subdiv", str(SCENE_SUBDIV), "--iters",
                                  "2"]),
    (f"bunny {SCENE_TRIS} pallas", ["--scene", "bunny", "--size", "512",
                                    "--subdiv", str(SCENE_SUBDIV), "--iters",
                                    "2", "--renderer", "pallas"]),
    ("triangle", ["--scene", "triangle"]),
]
BENCH_WALK_RUN = f"bunny {SCENE_TRIS} pallas"     # B3's twin check in [bench]
BENCH_ROWS = ("bvh_row", "bsdf_row")
BENCH_LAUNCH = "bench: launches "


def bench_py_metric(fn, **names):
    """The ``"metric"`` expression of the dict function ``fn`` of the root
    bench.py builds (``main``, ``_bvh_row``, ``_bsdf_row``), read from its
    source and evaluated with ``names``."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    node = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == fn)
    expr = next(v for d in ast.walk(node) if isinstance(d, ast.Dict)
                for k, v in zip(d.keys, d.values)
                if isinstance(k, ast.Constant) and k.value == "metric")
    return eval(compile(ast.Expression(expr), "bench.py", "eval"), names)


def bench_expected(args):
    """(headline metric, the rows the record must carry, the kernel the
    headline must launch) of one bench run, as bench.py would label it."""
    a = bench.parse_args(args)[1]
    mode = "fwd" if a.forward_only else "fwd+bwd"
    size = a.size or (128 if a.small else 1024)
    metric = bench_py_metric("main", mode=mode, size=size, args=a,
                             cfg=types.SimpleNamespace(max_bounces=a.bounces))
    rows = ()
    if a.scene == "cornell" and not a.small and a.renderer == "auto":
        rows = BENCH_ROWS + (() if a.forward_only
                             else ("scaling_efficiency_8",))
    kernel = None
    if a.scene == "bunny":
        kernel = "bvh_walk" if a.renderer == "pallas" else "cluster_sweep"
    return metric, rows, kernel


def bench_run(smi, label, args):
    """One run of ``python -m wc_path_tracer_tpu_torch.bench ARGS`` in a
    subprocess -> record: its JSON line held to bench.py's metric strings,
    every value finite and > 0, each row's kernel launches per step."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "wc_path_tracer_tpu_torch.bench", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    s = time.perf_counter() - t0
    check(proc.returncode == 0, f"[bench] {label} exits 0 ({s:.1f} s)" + (
        "" if proc.returncode == 0 else f":\n{proc.stderr[-3000:]}"))
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    metric, rows, kernel = bench_expected(args)
    keys = {"metric", "value", "unit", "vs_baseline", "alive_fraction",
            "alive_mrays", *rows}
    check(set(rec) == keys and rec["metric"] == metric,
          f"[bench] {label}: the record has bench.py's keys {sorted(keys)} "
          f"and its metric string {metric!r}")
    values = [rec["value"], rec["vs_baseline"], rec["alive_fraction"],
              rec["alive_mrays"]]
    for row in rows:
        values += ([rec[row]] if row.startswith("scaling") else
                   [v for k, v in rec[row].items() if k != "metric" and
                    k != "unit"])
    check(all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
              for v in values), f"[bench] {label}: every value is finite "
          f"and > 0: {values}")
    if rows:
        check(rec["bvh_row"]["metric"] == bench_py_metric("_bvh_row")
              and rec["bsdf_row"]["metric"] == bench_py_metric(
                  "_bsdf_row", COMPACT_CONFIG_D=bench.COMPACT_CONFIG_D),
              f"[bench] {label}: the row metrics equal bench.py's: "
              f"{rec['bvh_row']['metric']!r}, {rec['bsdf_row']['metric']!r}")
    launches = {r["row"]: r for r in (
        json.loads(line[len(BENCH_LAUNCH):]) for line in
        proc.stderr.splitlines() if line.startswith(BENCH_LAUNCH))}
    want = {"headline": kernel, "bvh_row": "cluster_sweep", "bsdf_row": None,
            "scaling_efficiency_8": None}
    want = {row: want[row] for row in ("headline",) + rows}
    # T1 shades the forward-only headline's segments (no grad, NEE off); H1
    # searches every segment of the rows on a box (brute force): the
    # headline's and the scaling row's on any scene but the bunny, and
    # bsdf_row's 9 (8 bounces)
    a = bench.parse_args(args)[1]
    fused = a.bounces + 1 if a.forward_only and not a.nee else 0
    box = 0 if a.scene == "bunny" else a.bounces + 1
    searched = {"headline": box, "bvh_row": 0, "bsdf_row": 9,
                "scaling_efficiency_8": box}
    zero = named(zeros())
    check(set(launches) == set(want) and all(
        launches[row]["per_step"] == dict(zero, **(
            {k: 5} if k else {}), **(
            {"cluster_cull": 5} if k == "cluster_sweep" else {}), **(
            {"shade_segment": fused} if row == "headline" else {}),
            brute_hit=searched[row])
        for row, k in want.items()),
        f"[bench] {label}: kernel launches per step "
        + ", ".join(f"{row} {launches[row]['per_step']}" for row in launches))
    print(f"[bench] {label} ({' '.join(args) or 'no flags'}): {s:.1f} s; "
          f"{json.dumps(rec)} (on {smi})", flush=True)
    for line in proc.stderr.splitlines():
        if line.startswith("bench: ") and not line.startswith(BENCH_LAUNCH):
            print(f"  {line}", flush=True)
    return dict(args=args, record=rec, process_s=s, launches={
        row: r["counts"] for row, r in launches.items()})


def same_scene(a, b):
    """Whether two scenes hold equal tensors in every leaf."""
    return a.mesh.max_leaf_tris == b.mesh.max_leaf_tris and all(
        torch.equal(getattr(getattr(a, g), f), getattr(getattr(b, g), f))
        for g, f in (name.split(".") for name in leaf_names()))


def bench_step_parity(smi, scene, mats):
    """What the [bench] bunny runs are, checked in process: the bench's
    scene ladder and config for ``--scene bunny --size 512`` give this
    script's bunny (every tensor and camera matrix equal) and the [train]
    bunny cell's config, and its fwd+bwd step on frame 1 is the fold of
    ``scene_loss_grad(cfg, BENCH_TRAINABLE, "auto")``'s loss and grads, bit
    for bit under deterministic algorithms.  The step's agreement with the
    JAX package is tests/test_torch_bench.py's."""
    args = bench.parse_args(["--scene", "bunny", "--size", "512"])[1]
    bscene, bcam, sky = bench.build_scene("bunny", "auto", args.subdiv,
                                          "cuda")
    cfg = bench.make_config(args, 512, sky)
    bmats = camera_matrices(bcam, 1.0)
    check(cfg == RenderConfig(**BUNNY) and same_scene(bscene, scene) and all(
        torch.equal(getattr(bmats, f.name), getattr(mats, f.name))
        for f in dataclasses.fields(mats)),
        "[bench] the bench's bunny is this script's, every tensor and camera "
        f"matrix equal, and its config the [train] bunny cell's: {cfg}")
    target = torch.zeros((512, 512, 3), device="cuda")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            scalar = bench.make_step(cfg, "auto")(bscene, bmats, 1, target)
            loss, grads = prender.scene_loss_grad(
                RenderConfig(**BUNNY), prender.BENCH_TRAINABLE, "auto")(
                scene, mats, 1, target)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    check(torch.equal(scalar, bench.fold(loss, grads)),
          f"[bench] the bench's fwd+bwd step on the 512^2 bunny, frame 1, "
          f"{float(scalar):.9g}, is bit for bit the fold of scene_loss_grad's "
          f"loss {float(loss):.9g} and grads of {', '.join(grads)}")
    return dict(loss=float(loss), scalar=float(scalar))


def looped_scaling(n, scene, mats, cfg):
    """The scaling row's step with its n band frames rendered one after
    another through ``golden.render_rows`` (the form before the batch):
    step -> (images, loss, grads)."""
    band = cfg.height // n

    def loss_grad(step):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in reg.get_params(scene, None,
                                             prender.BENCH_TRAINABLE).items()}
        s, _ = reg.apply_params(scene, None, params)
        imgs = [golden.render_rows(s, mats, cfg, step * n + i, 0, band)
                for i in range(n)]
        loss = sum(torch.mean(img ** 2) for img in imgs) / n
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return torch.stack(imgs).detach(), loss.detach(), {
            k: g for k, g in zip(params, grads) if g is not None}
    return loss_grad


def device_launches(fn):
    """The kernels and copies ``fn`` puts on the card (torch.profiler, CUDA
    activity only: cheap to read back for the ~50,000 of a looped step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation)


def bench_scaling_parity(smi):
    """The bench's scaling_efficiency_8 step on its 1024^2 Cornell box: the
    batched step (``bench.scaling_loss_grad``, 8 band frames of 128 rows as
    one batch) against the looped one, images bit for bit, loss and grads
    to rtol 1e-5; each step's ms (host clock, synchronized, the best of 3
    after a warm-up), its launches on the card (``device_launches``), and
    the efficiency each form gives against the bench's full-frame step
    timed alike, T(full) / T(8 band frames) -> record."""
    n, size = 8, 1024
    args = bench.parse_args([])[1]
    scene, cam, sky = bench.build_scene(args.scene, args.renderer,
                                        args.subdiv, "cuda")
    cfg = bench.make_config(args, size, sky)
    mats = camera_matrices(cam, 1.0)
    target = torch.zeros((size, size, 3), device="cuda")
    full = bench.make_step(cfg, "auto")
    full(scene, mats, 1, target)
    full_ms = min(sync_time(lambda: full(scene, mats, 2, target))[1]
                  for _ in range(3)) * 1e3
    rec, res = dict(full_ms=full_ms), {}
    for form, fn in (("batched", bench.scaling_loss_grad(n, scene, mats, cfg)),
                     ("looped", looped_scaling(n, scene, mats, cfg))):
        res[form] = fn(1)
        ms = min(sync_time(lambda: fn(2))[1] for _ in range(3)) * 1e3
        launches = device_launches(lambda: fn(3))
        rec[form] = dict(ms=ms, launches=launches, efficiency=full_ms / ms)
        print(f"[bench] scaling_efficiency_8 step, {form}: {ms:.2f} ms (host "
              f"clock, synchronized), {launches} launches, efficiency "
              f"against the {full_ms:.2f} ms full step {full_ms / ms:.4f}, "
              f"on {smi}", flush=True)
    (img, loss, grads), (want_img, want_loss, want) = (res["batched"],
                                                       res["looped"])
    rel = {k: float(((grads[k] - want[k]).abs()
                     / want[k].abs().clamp_min(1e-30)).max()) for k in want}
    ok = set(grads) == set(want) and all(
        torch.allclose(grads[k], want[k], rtol=1e-5, atol=0) for k in want)
    check(torch.equal(img, want_img) and ok and math.isclose(
        float(loss), float(want_loss), rel_tol=1e-5),
        f"[bench] the batched scaling step's {n} x {size // n} x {size} "
        f"images equal the looped step's bit for bit; loss "
        f"{float(loss):.9g} vs {float(want_loss):.9g} and grads ({rel}) "
        "within rtol 1e-5")
    check(rec["batched"]["launches"] * 4 <= rec["looped"]["launches"],
          f"[bench] the batched step issues far fewer launches than the "
          f"loop: {rec['batched']['launches']} against "
          f"{rec['looped']['launches']}")
    return dict(rec, grad_rel_err=rel, loss=float(loss))


def bench_walk(smi):
    """B3 at the shapes the [bench] 327,680-triangle "pallas" run gives it:
    the bench's own scene (``bunny_like_scene(SCENE_SUBDIV)`` in draws of
    ``PALLAS_MAX_TRIS``) and config, its primary query through
    ``walk_query`` -> record."""
    args = bench.parse_args(dict(BENCH_RUNS)[BENCH_WALK_RUN])[1]
    scene, cam, sky = bench.build_scene(args.scene, args.renderer,
                                        args.subdiv, "cuda")
    m = scene.mesh
    draws = int(m.draw_count)
    per_draw = m.draw_index_count[:draws] // 3
    check(draws > 1 and int(per_draw.max()) <= dispatch.PALLAS_MAX_TRIS
          and int(per_draw.sum()) == SCENE_TRIS,
          f"[bench] the {SCENE_TRIS}-triangle bunny under 'pallas' is "
          f"{draws} draws of {int(per_draw.min())}-{int(per_draw.max())} "
          f"triangles, at most {dispatch.PALLAS_MAX_TRIS}")
    out, _ = walk_query(
        smi, "[bench]", f"the {SCENE_TRIS}-triangle bunny in {draws} draws",
        scene, camera_matrices(cam, 1.0), bench.make_config(args, args.size,
                                                            sky))
    return out


def bench_phase(smi, scene, mats):
    """The [bench] phase: the port's bench entry point in subprocesses, on
    the card by default: its default command (Cornell 1024^2 fwd+bwd with
    bvh_row, bsdf_row and scaling_efficiency_8), --forward-only, --nee, the
    bunny through "pallas" (B3), the 327,680-triangle bunny through "auto"
    (B1) and "pallas" (B3), the single triangle; then, in process, its bunny
    and step against this script's (``bench_step_parity``) and B3 against
    its twin on the 327,680-triangle "pallas" scene (``bench_walk``), and
    the scaling row's batched step against the looped one
    (``bench_scaling_parity``) -> its JSON record."""
    t0 = time.perf_counter()
    runs = {label: bench_run(smi, label, args) for label, args in BENCH_RUNS}
    parity = bench_step_parity(smi, scene, mats)
    scaling = bench_scaling_parity(smi)
    walk = bench_walk(smi)
    return dict(runs=runs, step_parity=parity, scaling_step=scaling, B3=walk,
                phase_s=time.perf_counter() - t0, card=smi)


def bench_launches(bench_rec, cli_key):
    """A kernel's launches in each [bench] run, summed over its rows."""
    return {label: sum(c[cli_key] for c in run["launches"].values())
            for label, run in bench_rec["runs"].items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS needs a fixed workspace under deterministic algorithms (the
    # [train] grad parity); read when its first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {kind}; devices: {count}", flush=True)

    # -- 1. build every kernel and the host scene library from this checkout
    # (one nvcc or g++ per source, all started together) ------------------
    t0 = time.perf_counter()
    logs = build.build_all(sources={native.LIBRARY: native.SOURCE})
    build_s = time.perf_counter() - t0
    print(f"[build] {len(logs)} source(s) compiled in {build_s:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for tag in KERNELS:
        library(tag)
    check(native.available(), "every BVH of this run is built by "
          f"the native host library: {native.status()}")

    # -- 2. the bunny scene; capture one frame's five kernel queries -------
    scene, cam = bunny_gltf_scene(device="cuda")
    mats = camera_matrices(cam, 1.0)
    tables = cluster.build_cluster_tables(scene.mesh)
    cfg = RenderConfig(**BUNNY)
    frame_fn = dispatch.get_render_frame("auto", scene, cfg)
    check(frame_fn.backend == "sweep",
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
    reset_counts()
    image, frame_ms, peak_gib = serve(scene, mats, cfg, None)
    launches = read_counts()["B1"]
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
    sweep_wrappers(cfg, scene, mats, img_k)

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
    check(dispatch.get_render_frame("auto", cscene, ccfg).backend
          == "golden", "dispatch 'auto' picks brute force for "
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
    empty_sky(cmats, ccfg)

    # -- 5b. T1, the transport's shading, against its plain twin -----------
    t1 = shade_phase(smi, cscene, cmats, ccfg, scene, mats, cfg)

    # -- 5c. H1, the brute-force closest-hit search, against its twin ------
    h1 = brute_phase(smi, cscene, cmats, ccfg)

    # -- 5d. P1, the serving post-processing, against its twin ------------
    p1 = post_phase(smi)

    # -- 5e. C1, the sweep's cull and per-block order, against its twin ---
    c1 = cull_phase(smi, scene, mats, cfg)

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
        bound_s, bound_by = peaks.bound(ops, nbytes(*args) + nbytes(args[4]))
        bound_ms = bound_s * 1e3
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

    # -- 10. the training path: fwd+bwd cells, NEE shadow queries, parity,
    # inverse rendering ----------------------------------------------------
    train = train_phase(smi, scene, cam, split_scene, cscene, ccam)
    for entry, key in ((b2, "B2"), (b3, "B3")):
        entry.update(shadow_entry(train, key))

    # -- 11. the silhouette estimator (edge_grads) and alive-lane compaction
    edge = edge_phase(smi, scene, cam, cscene, ccam)
    compact = compact_phase(smi, scene, mats)
    b2["edge_launches"] = {label: c["launches"]["B2"]
                           for label, c in edge["cells"].items()}

    # -- 12. the serving entry points, the CLI and data parallelism -------
    serving = serve_phase(smi, scene, cam, cscene, ccam)
    cli = cli_phase(smi, kind)
    dp = dp_phase(smi)
    for entry, key, cli_key in ((b2, "B2", "cluster_sweep_mxu"),
                                (b3, "B3", "bvh_walk"),
                                (t1, "T1", "shade_segment"),
                                (h1, "H1", "brute_hit")):
        entry.update(slice_launches(serving, cli, dp, key, cli_key))

    # -- 13. the native host scene pipeline and the 327,680-triangle OBJ
    # through the CLI on B1 and B3 -----------------------------------------
    scene_rec = scene_phase(smi)
    for entry, key, cli_key in ((b2, "B2", "cluster_sweep_mxu"),
                                (b3, "B3", "bvh_walk"),
                                (t1, "T1", "shade_segment"),
                                (h1, "H1", "brute_hit")):
        entry.update(scene_entry(scene_rec, key, cli_key))
    b3["scene"] = scene_rec["B3"]

    # -- 14. the port's bench entry point (python -m
    # wc_path_tracer_tpu_torch.bench) in subprocesses ----------------------
    bench_rec = bench_phase(smi, scene, mats)
    for entry, cli_key in ((b2, "cluster_sweep_mxu"), (b3, "bvh_walk"),
                           (t1, "shade_segment"), (h1, "brute_hit")):
        entry["bench_launches"] = bench_launches(bench_rec, cli_key)
    w = b3["bench"] = bench_rec["B3"]
    b3.update(bench_ms=w["ms"], bench_plain_ms=w["plain_ms"],
              bench_bound_ms=w["bound_ms"], bench_bound_by=w["bound_by"],
              bench_max_abs_err=w["max_abs_err"],
              bench_note=f"one launch on the primary query of the bench's "
                         f"{SCENE_TRIS}-triangle 'pallas' bunny at 512^2, "
                         f"{w['draws']} draws")

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
        **shadow_entry(train, "B1"),
        "train": train,
        "edge_ms": edge["query"]["ms"],
        "edge_bound_ms": edge["query"]["bound_ms"],
        "edge_bound_by": edge["query"]["bound_by"],
        "edge_note": "the widened silhouette query of one 512^2 bunny "
                     "frame's primary rays (1 launch per frame)",
        "edge": edge,
        "compact": compact,
        **slice_launches(serving, cli, dp, "B1", "cluster_sweep"),
        "serve": serving,
        "cli": cli,
        "dp": dp,
        **scene_entry(scene_rec, "B1", "cluster_sweep"),
        "scene": {k: v for k, v in scene_rec.items() if k != "B3"},
        "bench_launches": bench_launches(bench_rec, "cluster_sweep"),
        "bench": {k: v for k, v in bench_rec.items() if k != "B3"},
    }, b2, b3, t1, h1,
        dict(p1, serve_launches=serving["post_launches"]["P1"]),
        dict(c1, serve_launches=serving["launches"]["C1"])]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
