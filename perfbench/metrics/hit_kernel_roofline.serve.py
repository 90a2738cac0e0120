"""Share of its roofline that the closest-hit kernels reach in a served
frame.

The bound is the work of the cell's closest-hit queries, computed from
the cell's parameters alone, whatever computes them: per frame, samples x
(max_bounces + 1) queries of W x H lanes (a rank's band on several
ranks).  A query moves 36 bytes per lane (origin, direction and t_max in;
t and the triangle id out) and reads the scene's triangles (36 bytes
each) and spheres (16 bytes each) once; it does one 54-operation
ray-triangle test per lane.  Its least time is the larger of operations
over the FP32 peak and bytes over the memory bandwidth (perfbench.peaks).
The device time is that of the closest-hit kernels named in KERNELS
(B1, B2 and their instantiations, B3) over the traced stretch."""

from perfbench import peaks

KERNELS = ("sweep_kernel", "bvh_walk_kernel")
BYTES_PER_LANE = 36
BYTES_PER_TRIANGLE = 36
BYTES_PER_SPHERE = 16
OPS_PER_LANE = 54


def read(view):
    s = view.stretch
    device_s = sum(d for name, _, d in s.kernels
                   if any(k in name for k in KERNELS)) / 1e9
    if device_s <= 0 or not s.units:
        return None
    r = view.render
    lanes = r["width"] * r["height"] // view.world
    nbytes = (lanes * BYTES_PER_LANE
              + view.scene_sizes["triangles"] * BYTES_PER_TRIANGLE
              + view.scene_sizes["spheres"] * BYTES_PER_SPHERE)
    queries = s.units * r["samples"] * (r["max_bounces"] + 1)
    least_s, _ = peaks.bound(OPS_PER_LANE * lanes, nbytes)
    return 100.0 * queries * least_s / device_s
