// Plane-form cluster-sweep closest hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wc_path_tracer_tpu/kernels/cluster.py
// ::_make_sweep_kernel_mxu (Pallas, launched by _sweep_chunk under
// cluster_sweep(variant="mxu")).  Same inputs, same payload, same visit
// order, tie rule and early exit; the plain PyTorch twin is
// wc_path_tracer_tpu_torch/kernels/cluster.py::cluster_sweep_mxu_plain.
//
// Layout: one CUDA block per ray block, one thread per ray (2 or 4 rays per
// thread in a ray block of more than 1,024 rays); each block reads its own
// active-cluster count and list and walks it front to back.  Per visit the
// threads stage the cluster's (8, 768) plane-form slab (24 KiB) in shared
// memory; then every thread forms, for each of the 128 slots in ascending
// order, the six dot products Q, P, Bu, Au, Bv, Av of its X = [o, d, 1, 0]
// with the slot's slab columns, summed
// term by term from k = 0 to 7 as the twin does, and tests
// t = -P * (1 / Q), u = Au + t Bu, v = Av + t Bv against t > 0, u >= 0,
// v >= 0, u + v <= 1 with a strict `<` update (lowest slot wins a tie, the
// first-visited cluster across clusters).  Dead slots have Q = 0, so t is
// +-inf or NaN and every comparison is false.  The block stops once every
// ray's min(t_best, t_lim) is at or before the next cluster's entry
// (__syncthreads_or).  The payload row of a winner is [t, 0 x 9, material,
// slot id, 0 x 4]: the re-shade fetches vertices by slot id.
//
// The TPU kernel put the six dot products on its matrix unit as one
// (rays, 8) @ (8, 768) product per visit.  This kernel keeps them on the
// FP32 CUDA cores: Hopper's tensor cores have no full-FP32 mode (TF32 keeps
// 10 mantissa bits), and a low-precision t would reorder closest hits.
//
// Bound: operations.  The function needs 46 FP32 ops per ray x slot: Q,
// Bu and Bv read only d (3 multiplies + 2 adds each), P, Au and Av read o
// and the constant 1 (3 + 3 each), then t (a division, a negation, a
// multiply), u and v (2 each), u + v and 5 compares; against 67 TFLOP/s
// FP32 (H100 SXM, 700 W).  The loop below issues 103, since it sums all 8
// rows of every dot product, structural zeros and the 1 included; the
// slabs are 24 KiB per cluster and stay in L2.  Simple and right first: no
// structural-zero skipping, no TMA, no double buffering.  Built with
// -fmad=false so every product and sum is rounded separately, as in the
// PyTorch twin, which makes the two bitwise comparable.

#include <cuda_runtime.h>

namespace {

constexpr int kClusterTris = 128;                // slots per cluster
constexpr int kRows = 8;                         // o (3), d (3), 1, pad
constexpr int kFields = 6;                       // Q, P, Bu, Au, Bv, Av
constexpr int kCols = kFields * kClusterTris;    // 768 slab columns
constexpr int kPayloadCols = 16;

// kRays rays per thread: ray i of a thread is threadIdx.x + i * blockDim.x
// of its ray block (a block of more than 1,024 rays exceeds a CTA).
template <int kRays>
__global__ void __launch_bounds__(1024) cluster_sweep_mxu_kernel(
    const int* __restrict__ nact,      // (blocks,) active clusters per block
    const int* __restrict__ clist,     // (blocks, clusters) ids, front first
    const float* __restrict__ bt0,     // (blocks, clusters) entry distances
    const float* __restrict__ rays,    // (blocks * ray_block, 16) o, d, t, t_lim
    const float* __restrict__ prev,    // (blocks * ray_block, 16) initial payload
    const float* __restrict__ trisW,   // (clusters * 8, 768) plane-form slabs
    const float* __restrict__ mat_tbl, // (clusters, 128) material ids
    float* __restrict__ out,           // (blocks * ray_block, 16) payload
    int* __restrict__ visits,          // (blocks,) clusters visited, or null
    int ray_block, int num_clusters) {
  __shared__ float s_w[kRows * kCols];

  const int block = blockIdx.x;
  float xo[kRays][6], t_lim[kRays], t_best[kRays];
  int win[kRays];
  bool valid[kRays];
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    const int k = threadIdx.x + i * blockDim.x;
    valid[i] = k < ray_block;
    const size_t ray = static_cast<size_t>(block) * ray_block + (valid[i] ? k : 0);
    const float* r = rays + ray * kPayloadCols;
#pragma unroll
    for (int c = 0; c < 6; ++c) xo[i][c] = r[c];
    t_lim[i] = r[7];
    t_best[i] = prev[ray * kPayloadCols];
    win[i] = -1;
  }
  const float x6 = 1.0f, x7 = 0.0f;

  const int n = nact[block];
  const int* list = clist + static_cast<size_t>(block) * num_clusters;
  const float* entry = bt0 + static_cast<size_t>(block) * num_clusters;
  int j = 0;
  bool go = n > 0;  // uniform across the block
  while (go) {
    const int c = list[j];
    const float* slab = trisW + static_cast<size_t>(c) * kRows * kCols;
    __syncthreads();  // the previous cluster's slab is no longer read
    for (int i = threadIdx.x; i < kRows * kCols; i += blockDim.x) s_w[i] = slab[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      const float x0 = xo[i][0], x1 = xo[i][1], x2 = xo[i][2];
      const float x3 = xo[i][3], x4 = xo[i][4], x5 = xo[i][5];
      for (int l = 0; l < kClusterTris; ++l) {
        float y[kFields];
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
          const float* w = s_w + f * kClusterTris + l;
          float acc = x0 * w[0];
          acc = acc + x1 * w[1 * kCols];
          acc = acc + x2 * w[2 * kCols];
          acc = acc + x3 * w[3 * kCols];
          acc = acc + x4 * w[4 * kCols];
          acc = acc + x5 * w[5 * kCols];
          acc = acc + x6 * w[6 * kCols];
          acc = acc + x7 * w[7 * kCols];
          y[f] = acc;
        }
        const float t = -y[1] * (1.0f / y[0]);
        const float u = y[3] + t * y[2];
        const float v = y[5] + t * y[4];
        const bool hit = (t > 0.0f) & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f);
        if (hit && t < t_best[i]) {
          t_best[i] = t;
          win[i] = c * kClusterTris + l;
        }
      }
    }
    ++j;
    const float next_entry = entry[j < n ? j : n - 1];
    bool more = false;
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      const float eff = t_best[i] < t_lim[i] ? t_best[i] : t_lim[i];
      more = more || (valid[i] && eff > next_entry);
    }
    go = __syncthreads_or(more) && j < n;
  }
  if (visits != nullptr && threadIdx.x == 0) visits[block] = j;

#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    if (!valid[i]) continue;
    const size_t ray = static_cast<size_t>(block) * ray_block + threadIdx.x + i * blockDim.x;
    float* o = out + ray * kPayloadCols;
    if (win[i] >= 0) {
      o[0] = t_best[i];
      for (int k = 1; k < 10; ++k) o[k] = 0.0f;
      o[10] = mat_tbl[win[i]];
      o[11] = static_cast<float>(win[i]);
      for (int k = 12; k < kPayloadCols; ++k) o[k] = 0.0f;
    } else {
      const float* p = prev + ray * kPayloadCols;
      for (int k = 0; k < kPayloadCols; ++k) o[k] = p[k];
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.  A ray block of up
// to 1,024 rays runs one ray per thread, up to 4,096 rays 2 or 4 per thread.
extern "C" int wc_cluster_sweep_mxu(const void* nact, const void* clist,
                                    const void* bt0, const void* rays,
                                    const void* prev, const void* trisW,
                                    const void* mat_tbl, void* out,
                                    void* visits, int num_blocks,
                                    int ray_block, int num_clusters,
                                    void* stream) {
  const int per_thread = ray_block <= 1024 ? 1 : ray_block <= 2048 ? 2 : 4;
  const int threads = (ray_block + per_thread - 1) / per_thread;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<num_blocks, threads, 0, s>>>(
        static_cast<const int*>(nact), static_cast<const int*>(clist),
        static_cast<const float*>(bt0), static_cast<const float*>(rays),
        static_cast<const float*>(prev), static_cast<const float*>(trisW),
        static_cast<const float*>(mat_tbl), static_cast<float*>(out),
        static_cast<int*>(visits), ray_block, num_clusters);
  };
  if (per_thread == 1) launch(cluster_sweep_mxu_kernel<1>);
  else if (per_thread == 2) launch(cluster_sweep_mxu_kernel<2>);
  else launch(cluster_sweep_mxu_kernel<4>);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
