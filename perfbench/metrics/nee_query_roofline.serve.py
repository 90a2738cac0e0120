"""Share of its roofline that the query kernels reach in a served frame
with next-event estimation, where the same kernels answer the closest-hit
queries and the shadow queries.

The bound is the work of the cell's queries, computed from the cell's
parameters alone, whatever computes them: per frame, samples x
(max_bounces + 1) closest-hit queries and as many shadow queries, each of
W x H lanes (a rank's band on several ranks).  A closest-hit query is
counted as hit_kernel_roofline.serve counts it (its constants are read
from that file): 36 bytes a lane, the scene's triangles (36 bytes each)
and spheres (16 bytes each) read once, one 54-operation ray-triangle test
a lane.  A shadow query moves 29 bytes a lane (origin, direction and
bound in, one flag out), reads the scene once and does 54 operations a
lane.  Each query's least time is the larger of operations over the FP32
peak and bytes over the memory bandwidth (perfbench.peaks.bound); the two
are summed.  The device time is that of the query kernels named in
KERNELS (B1, B2 and their instantiations, B3, H1) over the traced
stretch."""

import importlib.util
from pathlib import Path

from perfbench import peaks


def _closest_hit_metric():
    path = Path(__file__).with_name("hit_kernel_roofline.serve.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_hit_kernel_roofline_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HIT = _closest_hit_metric()
KERNELS = HIT.KERNELS + ("brute_hit",)
SHADOW_BYTES_PER_LANE = 29


def read(view):
    s = view.stretch
    device_s = sum(d for name, _, d in s.kernels
                   if any(k in name for k in KERNELS)) / 1e9
    if device_s <= 0 or not s.units:
        return None
    r = view.render
    lanes = r["width"] * r["height"] // view.world
    scene_bytes = (view.scene_sizes["triangles"] * HIT.BYTES_PER_TRIANGLE
                   + view.scene_sizes["spheres"] * HIT.BYTES_PER_SPHERE)
    ops = HIT.OPS_PER_LANE * lanes
    hit_s, _ = peaks.bound(ops, lanes * HIT.BYTES_PER_LANE + scene_bytes)
    shadow_s, _ = peaks.bound(ops, lanes * SHADOW_BYTES_PER_LANE
                              + scene_bytes)
    queries = s.units * r["samples"] * (r["max_bounces"] + 1)
    return 100.0 * queries * (hit_s + shadow_s) / device_s
