// Brute-force closest-hit search for NVIDIA Hopper (sm_90a): H1.
//
// Replaces no TPU kernel.  The JAX package's brute-force query
// (render/golden.py::intersect_scene_brute) is an all-pairs sweep that XLA
// fuses; in eager PyTorch each of its ~126 ops over (rays x slots) is a
// launch of its own that writes a (rays x slots) tensor to memory, and one
// 1024^2 Cornell query took ~11 ms.  This kernel does the detached discrete
// search of that query for every lane in one launch: the closest live
// sphere and the closest live triangle, each with the slot that wins.  Its
// plain twin is wc_path_tracer_tpu_torch/render/golden.py::_brute_search,
// and the two agree bit for bit in all four outputs on every lane (dead
// lanes too: nothing is skipped per lane).  The differentiable re-shade of
// the winners (golden.resolve_hit) stays in PyTorch.
//
// Per lane, in the twin's order:
//  - spheres: ops/intersect.py::ray_sphere_sweep's arithmetic with
//    safe_sqrt; the candidate is the near root (sphere_near_root_only), else
//    the near root where it is > 0 and the far one otherwise; it counts
//    where it is > 0 and the slot is below the live count, else kInf;
//  - triangles: ops/intersect.py::_moller_trumbore on (a, b - a, c - a),
//    the edges formed in float32 as PyTorch forms them; a slot counts where
//    it hits and belongs to a live draw (golden._live_triangle_mask), else
//    kInf;
//  - golden._first_min's rule over each set: the least value, and the
//    lowest slot among equal least values.  A strict `<` running minimum
//    over the slots in ascending order, started at (+inf, 0), gives exactly
//    that, also where nothing counts (kInf at slot 0) and where a hit's t
//    overflowed to +inf (the lowest kInf slot wins, as amin's equality
//    does).  No candidate is NaN: a NaN t fails `> 0`.
//
// Bit for bit with PyTorch's op-by-op arithmetic: built with -fmad=false;
// the terms of every dot and cross product in ops/intersect.py's order;
// sqrtf and IEEE division, as PyTorch's kernels call them; `1.0 / x` as
// PyTorch's reciprocal(x) * 1.0, which is 1.0f / x exactly.
//
// What bounds it: operations.  A lane tests every slot: 54 FP32 operations a
// triangle (the count of cluster_sweep.cu), ~20 a sphere; a 1024^2 query of
// the Cornell box's 32 triangles and 4 spheres is ~1.9 GFLOP, ~0.028 ms at
// 67 TFLOP/s, against 24 bytes in and 24 out a lane (~0.015 ms of HBM).
// Built with -fmad=false each operation is its own instruction, so half
// that peak is the ceiling.
//
// Design: one thread per lane, 256-thread blocks.  Each block stages the
// slots in shared memory, a tile at a time (spheres as (center, radius),
// triangles as (a, live), (b - a), (c - a)), and every thread walks the same
// slots in ascending order: the shared-memory reads are broadcasts, and a
// dead slot is a uniform branch.  As in cluster_sweep.cu, a warp skips q, v
// and t of a triangle where none of its lanes has 0 <= u <= 1 (no lane can
// hit it); every value that is computed is computed in the twin's order.
// Tiles keep any slot count in bounds, so dispatch "golden" forced onto a
// large mesh runs too.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;                 // slots staged per tile
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kInf = 0x1.fffffep+127f;   // golden.KINF, float32 max

struct Params {
  const float* o;           // (lanes, 3), or one row read by every lane
  const float* d;           // (lanes, 3)
  const float* position;    // (spheres, 3)
  const float* radius;      // (spheres,)
  const int* sphere_count;  // () live spheres
  const float* a;           // (triangles, 3) vertex rows
  const float* b;
  const float* c;
  const int* tri_draw;      // (triangles,) draw of each slot, -1 = padding
  const int* draw_count;    // () live draws
  float* t_s;               // (lanes,) outputs
  int64_t* s_idx;
  float* t_tri;
  int64_t* t_idx;
  int lanes, o_stride, spheres, triangles;
  bool near_root_only;
};

__global__ void __launch_bounds__(kThreads) brute_hit(const Params q) {
  __shared__ float4 sph[kTile];
  __shared__ float4 tri[3][kTile];

  const int lane = blockIdx.x * kThreads + threadIdx.x;
  // threads past the last lane compute the last lane's answer and store
  // nothing: every thread stays in the block's barriers and warp votes
  const size_t i = static_cast<size_t>(lane < q.lanes ? lane : q.lanes - 1);
  const float* o = q.o + static_cast<size_t>(q.o_stride) * i;
  const float ox = o[0], oy = o[1], oz = o[2];
  const float dx = q.d[3 * i], dy = q.d[3 * i + 1], dz = q.d[3 * i + 2];

  // -- spheres: golden.sphere_closest's search ------------------------------
  const int live_spheres = *q.sphere_count;
  float best = __int_as_float(0x7f800000);  // +inf
  int64_t win = 0;
  for (int base = 0; base < q.spheres; base += kTile) {
    const int n = min(kTile, q.spheres - base);
    __syncthreads();  // the previous tile's reads are done
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const size_t s = base + j;
      sph[j] = make_float4(q.position[3 * s], q.position[3 * s + 1],
                           q.position[3 * s + 2], q.radius[s]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float cand = kInf;
      if (base + j < live_spheres) {
        const float4 s = sph[j];
        const float ocx = ox - s.x, ocy = oy - s.y, ocz = oz - s.z;
        const float bq = ocx * dx + ocy * dy + ocz * dz;
        const float cq = ocx * ocx + ocy * ocy + ocz * ocz - s.w * s.w;
        const float disc = bq * bq - cq;
        const float root = disc > 0.0f ? sqrtf(disc) : 0.0f;  // safe_sqrt
        const bool miss = disc < 0.0f;
        const float near = miss ? -1.0f : -bq - root;
        const float far = miss ? -1.0f : -bq + root;
        const float t = q.near_root_only ? near : (near > 0.0f ? near : far);
        if (t > 0.0f) cand = t;
      }
      if (cand < best) {
        best = cand;
        win = base + j;
      }
    }
  }
  if (lane < q.lanes) {
    q.t_s[i] = best;
    q.s_idx[i] = win;
  }

  // -- triangles: the Moller-Trumbore sweep over live slots -----------------
  const int live_draws = *q.draw_count;
  best = __int_as_float(0x7f800000);
  win = 0;
  for (int base = 0; base < q.triangles; base += kTile) {
    const int n = min(kTile, q.triangles - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const size_t s = base + j;
      const float ax = q.a[3 * s], ay = q.a[3 * s + 1], az = q.a[3 * s + 2];
      const int draw = q.tri_draw[s];
      tri[0][j] = make_float4(ax, ay, az,
                              draw >= 0 && draw < live_draws ? 1.0f : 0.0f);
      tri[1][j] = make_float4(q.b[3 * s] - ax, q.b[3 * s + 1] - ay,
                              q.b[3 * s + 2] - az, 0.0f);
      tri[2][j] = make_float4(q.c[3 * s] - ax, q.c[3 * s + 1] - ay,
                              q.c[3 * s + 2] - az, 0.0f);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 a = tri[0][j];
      float cand = kInf;
      if (a.w != 0.0f) {  // a live slot: the same for every thread
        const float4 e1 = tri[1][j], e2 = tri[2][j];
        // ops/intersect.py::_moller_trumbore's order
        const float oax = ox - a.x, oay = oy - a.y, oaz = oz - a.z;
        const float px = dy * e2.z - dz * e2.y;
        const float py = dz * e2.x - dx * e2.z;
        const float pz = dx * e2.y - dy * e2.x;
        const float inv_det = 1.0f / (e1.x * px + e1.y * py + e1.z * pz);
        const float u = (oax * px + oay * py + oaz * pz) * inv_det;
        const bool u_in = (u >= 0.0f) & (u <= 1.0f);
        if (__any_sync(kFullWarp, u_in)) {  // else no lane of the warp hits
          const float qx = oay * e1.z - oaz * e1.y;
          const float qy = oaz * e1.x - oax * e1.z;
          const float qz = oax * e1.y - oay * e1.x;
          const float v = dx * (qx * inv_det) + dy * (qy * inv_det) +
                          dz * (qz * inv_det);
          const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
          if ((t > 0.0f) & u_in & (v >= 0.0f) & (u + v <= 1.0f)) cand = t;
        }
      }
      if (cand < best) {
        best = cand;
        win = base + j;
      }
    }
  }
  if (lane < q.lanes) {
    q.t_tri[i] = best;
    q.t_idx[i] = win;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t), one thread per lane; returns the
// launch's error code (0 on success), so a refused launch is reported to
// the caller.  `o_stride` is the row stride of `o` in floats (3, or 0 for
// one origin shared by every lane); `sphere_count` and `draw_count` are
// read on the device.
extern "C" int wc_brute_hit(const void* o, const void* d,
                            const void* position, const void* radius,
                            const void* sphere_count, const void* a,
                            const void* b, const void* c,
                            const void* tri_draw, const void* draw_count,
                            void* t_s, void* s_idx, void* t_tri, void* t_idx,
                            int lanes, int o_stride, int spheres,
                            int triangles, int near_root_only, void* stream) {
  if (lanes <= 0) return cudaSuccess;
  const Params q{static_cast<const float*>(o),
                 static_cast<const float*>(d),
                 static_cast<const float*>(position),
                 static_cast<const float*>(radius),
                 static_cast<const int*>(sphere_count),
                 static_cast<const float*>(a),
                 static_cast<const float*>(b),
                 static_cast<const float*>(c),
                 static_cast<const int*>(tri_draw),
                 static_cast<const int*>(draw_count),
                 static_cast<float*>(t_s),
                 static_cast<int64_t*>(s_idx),
                 static_cast<float*>(t_tri),
                 static_cast<int64_t*>(t_idx),
                 lanes,
                 o_stride,
                 spheres,
                 triangles,
                 near_root_only != 0};
  const int blocks = (lanes + kThreads - 1) / kThreads;
  brute_hit<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
