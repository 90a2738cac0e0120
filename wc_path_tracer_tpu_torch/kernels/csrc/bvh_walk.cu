// BVH walk closest hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wc_path_tracer_tpu/kernels/traversal.py
// ::_traversal_kernel (Pallas, launched by packet_bvh_intersect and, per
// SMEM-sized chunk, by packet_bvh_intersect_chunked).  Same contract: per
// ray the closest triangle hit over every draw's BVH, pruned by t_init, as
// (t, first-index offset into mesh.indices or -1).  The plain PyTorch twin
// is wc_path_tracer_tpu_torch/kernels/traversal.py::bvh_walk_plain.
//
// Layout: one thread per ray, each with its own 64-slot stack in local
// memory.  The TPU kernel shared one scalar stack per 1024-ray packet and
// descended wherever any lane entered, because a TPU lane has no stack; a
// GPU thread has one, so this is the reference shader's per-thread walk
// (pathTracer.comp:151-201): draws in order with t carried across them, pop,
// slab test in ops/intersect.py::ray_box's order (NaN propagates through
// min/max as in torch.minimum, so a 0 * inf lane never enters), enter iff
// t0 <= t1 && t1 >= 0 && t0 <= t_best, leaf triangles in
// ops/intersect.py::ray_triangle's order with a strict `<` update, and at
// an inner node push the far child then the near one by t0 > 0 ? t0 : t1.
// The scene tables (node boxes, indices, vertices) are read from global
// memory through L2; one launch walks every draw, so the TPU's SMEM
// chunking has no counterpart.
//
// Bound: operations at this size, counted as the walk needs them, not as
// this loop issues them.  Per ray, each node reached needs one slab test
// (6 subtractions, 6 multiplies, 10 min/max: 22 ops), computed for both
// children at an entered inner node with the near-child choice (47 ops)
// and for the roots once per draw; each pop adds 3 enter compares, each
// leaf triangle one Moller-Trumbore test (54, counted as in
// cluster_sweep.cu).  This loop recomputes each popped node's slab test,
// which its parent already did.  The tables are a few MB and the rays move
// 36 bytes each, below the operation time at 67 TFLOP/s FP32 (H100 SXM,
// 700 W).
// This first version is simple and right, not fast: divergent threads, no
// ray sorting, no wide BVH, no packets.  Built with -fmad=false so every
// product and sum is rounded separately, as in the PyTorch twin.

#include <cuda_runtime.h>

namespace {

constexpr int kStack = 64;       // per-ray stack slots (host checks depth)
constexpr int kCountCols = 3;    // nodes popped, inner entered, tris tested

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

struct Box {
  float t0, t1;
};

// ops/intersect.py::ray_box: t0 = max over axes of min(top, bot),
// t1 = min over axes of max(top, bot)
__device__ __forceinline__ Box slab(const float* __restrict__ bmin,
                                    const float* __restrict__ bmax, int node,
                                    float ox, float oy, float oz, float ix,
                                    float iy, float iz) {
  const float* lo = bmin + 3 * static_cast<size_t>(node);
  const float* hi = bmax + 3 * static_cast<size_t>(node);
  const float bx = (lo[0] - ox) * ix, tx = (hi[0] - ox) * ix;
  const float by = (lo[1] - oy) * iy, ty = (hi[1] - oy) * iy;
  const float bz = (lo[2] - oz) * iz, tz = (hi[2] - oz) * iz;
  Box b;
  b.t0 = nan_max(nan_max(nan_min(tx, bx), nan_min(ty, by)), nan_min(tz, bz));
  b.t1 = nan_min(nan_min(nan_max(tx, bx), nan_max(ty, by)), nan_max(tz, bz));
  return b;
}

__global__ void bvh_walk_kernel(
    const float* __restrict__ origin,     // (R, 3)
    const float* __restrict__ direction,  // (R, 3)
    const float* __restrict__ t_init,     // (R,)
    const float* __restrict__ bvh_min,    // (N, 3)
    const float* __restrict__ bvh_max,    // (N, 3)
    const int* __restrict__ bvh_left,     // (N,) left child / first index
    const int* __restrict__ bvh_count,    // (N,) index count, 0 = inner
    const int* __restrict__ indices,      // (I,) draw-relative vertex ids
    const float* __restrict__ vertices,   // (V, 3)
    const int* __restrict__ draw_node_off,
    const int* __restrict__ draw_index_off,
    const int* __restrict__ draw_vert_off,
    const int* __restrict__ draw_count,   // () live draws
    float* __restrict__ t_out,            // (R,)
    int* __restrict__ off_out,            // (R,)
    int* __restrict__ counts,             // (R, 3) or null
    int num_rays, int draw_capacity, int max_leaf_tris) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  const float ox = origin[3 * r], oy = origin[3 * r + 1], oz = origin[3 * r + 2];
  const float dx = direction[3 * r], dy = direction[3 * r + 1],
              dz = direction[3 * r + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float t_best = t_init[r];
  int best = -1;
  int popped = 0, entered = 0, tested = 0;
  int stack[kStack];

  const int nd = min(*draw_count, draw_capacity);
  for (int di = 0; di < nd; ++di) {
    const int node_off = draw_node_off[di];
    const int index_off = draw_index_off[di];
    const int vert_off = draw_vert_off[di];
    stack[0] = node_off;
    int ptr = 1;
    while (ptr > 0) {
      const int node = stack[--ptr];
      ++popped;
      const Box b = slab(bvh_min, bvh_max, node, ox, oy, oz, ix, iy, iz);
      if (!((b.t0 <= b.t1) & (b.t1 >= 0.0f) & (b.t0 <= t_best))) continue;
      const int count = bvh_count[node];
      const int left = bvh_left[node];
      if (count > 0) {
        for (int k = 0; k < max_leaf_tris && 3 * k < count; ++k) {
          ++tested;
          const int i0 = index_off + left + 3 * k;
          const float* a = vertices + 3 * static_cast<size_t>(vert_off + indices[i0]);
          const float* pb = vertices + 3 * static_cast<size_t>(vert_off + indices[i0 + 1]);
          const float* pc = vertices + 3 * static_cast<size_t>(vert_off + indices[i0 + 2]);
          const float ax = a[0], ay = a[1], az = a[2];
          const float e1x = pb[0] - ax, e1y = pb[1] - ay, e1z = pb[2] - az;
          const float e2x = pc[0] - ax, e2y = pc[1] - ay, e2z = pc[2] - az;
          const float oax = ox - ax, oay = oy - ay, oaz = oz - az;
          // Moller-Trumbore, in ops/intersect.py::ray_triangle's order
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float inv_det = 1.0f / (e1x * px + e1y * py + e1z * pz);
          const float qx = oay * e1z - oaz * e1y;
          const float qy = oaz * e1x - oax * e1z;
          const float qz = oax * e1y - oay * e1x;
          const float u = (oax * px + oay * py + oaz * pz) * inv_det;
          const float v = dx * (qx * inv_det) + dy * (qy * inv_det) + dz * (qz * inv_det);
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool hit = (t > 0.0f) & (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) &
                           (u + v <= 1.0f);
          if (hit && t < t_best) {
            t_best = t;
            best = i0;
          }
        }
      } else {
        ++entered;
        const int lchild = node_off + left;
        const int rchild = lchild + 1;
        const Box lb = slab(bvh_min, bvh_max, lchild, ox, oy, oz, ix, iy, iz);
        const Box rb = slab(bvh_min, bvh_max, rchild, ox, oy, oz, ix, iy, iz);
        const float ldist = lb.t0 > 0.0f ? lb.t0 : lb.t1;
        const float rdist = rb.t0 > 0.0f ? rb.t0 : rb.t1;
        const bool near_left = ldist < rdist;
        if (ptr <= kStack - 2) {  // always true: the wrapper refuses deeper trees
          stack[ptr++] = near_left ? rchild : lchild;  // far: popped last
          stack[ptr++] = near_left ? lchild : rchild;  // near: popped next
        }
      }
    }
  }
  t_out[r] = t_best;
  off_out[r] = best;
  if (counts != nullptr) {
    counts[kCountCols * r] = popped;
    counts[kCountCols * r + 1] = entered;
    counts[kCountCols * r + 2] = tested;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.
extern "C" int wc_bvh_walk(const void* origin, const void* direction,
                           const void* t_init, const void* bvh_min,
                           const void* bvh_max, const void* bvh_left,
                           const void* bvh_count, const void* indices,
                           const void* vertices, const void* draw_node_off,
                           const void* draw_index_off,
                           const void* draw_vert_off, const void* draw_count,
                           void* t_out, void* off_out, void* counts,
                           int num_rays, int draw_capacity, int max_leaf_tris,
                           void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  bvh_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origin), static_cast<const float*>(direction),
      static_cast<const float*>(t_init), static_cast<const float*>(bvh_min),
      static_cast<const float*>(bvh_max), static_cast<const int*>(bvh_left),
      static_cast<const int*>(bvh_count), static_cast<const int*>(indices),
      static_cast<const float*>(vertices),
      static_cast<const int*>(draw_node_off),
      static_cast<const int*>(draw_index_off),
      static_cast<const int*>(draw_vert_off),
      static_cast<const int*>(draw_count), static_cast<float*>(t_out),
      static_cast<int*>(off_out), static_cast<int*>(counts), num_rays,
      draw_capacity, max_leaf_tris);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
