// A measurement probe, not part of the port: the plane-form sweep (B2) with
// its six dot products on the tensor cores in 3xTF32, to settle whether
// the tensor cores pay for this function on Hopper.  Built and timed by
// tools/mxu_tf32_probe.py against cluster_sweep_mxu.cu on the same queries.
//
// Per ray the product X = [o, d, 1, 0] (K = 8) with a cluster's slab is one
// mma.sync.m16n8k8 (TF32 in, FP32 accumulate) per 16 rays and 8 slab
// columns.  3xTF32: x = x_hi + x_lo with x_hi = tf32(x) and
// x_lo = tf32(x - x_hi), and x.w ~ x_lo.w_hi + x_hi.w_lo + x_hi.w_hi (the
// lo.lo term dropped), three MMAs per tile, which keeps about 21 of FP32's
// 24 mantissa bits; the accumulation order inside an MMA is the hardware's,
// so the result cannot be bitwise equal to a twin.  The slab's hi/lo split
// is made at table time (the Python side), in fragment order: the n-tile j
// of slot quad s holds fields 2j and 2j + 1 of slots 4s .. 4s + 3, column
// 2q + e for slot 4s + q and field 2j + e, so the accumulator fragment of
// lane (g, q) = (lane / 4, lane % 4) holds, over the three tiles of a quad,
// all six fields Q, P, Bu, Au, Bv, Av of slot 4s + q for rays g and g + 8.
// Each ray is therefore tested by 4 lanes (slots q, q + 4, ...) whose first
// minima merge by __shfl_xor_sync as in the port's kernels.
//
// Layout: one CTA of 1,024 threads (32 warps x 16 rays) per 512-ray block,
// heaviest blocks first; per visit the cluster's 48 KiB of fragments is
// staged in shared memory; the block stops as the port's kernels do
// (__syncthreads_or over min(t_best, t_lim) > next entry).  The epilogue
// (t = -P * (1 / Q), u, v, the tests) runs on the CUDA cores as in B2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTris = 128;
constexpr int kQuads = kTris / 4;
constexpr int kTiles = 3;
constexpr int kPayload = 16;
constexpr int kRayBlock = 512;
constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFragsPerCluster = kQuads * kTiles * 32;  // float4 each

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads) probe_kernel(
    const int* __restrict__ nact, const int* __restrict__ clist,
    const float* __restrict__ bt0, const int* __restrict__ order,
    const float* __restrict__ rays, const float* __restrict__ prev,
    const float4* __restrict__ frags,  // (clusters, 32, 3, 32) hi0 hi1 lo0 lo1
    const float* __restrict__ mat_tbl, float* __restrict__ out,
    int num_clusters) {
  extern __shared__ float4 s_frag[];  // one cluster's fragments
  const int block = order[blockIdx.x];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  size_t ray[2];
  float t_best[2], t_lim[2];
  int win[2] = {-1, -1};
  uint32_t a_hi[4], a_lo[4];
  for (int i = 0; i < 2; ++i) {
    ray[i] = static_cast<size_t>(block) * kRayBlock + warp * 16 + g + 8 * i;
    const float* r = rays + ray[i] * kPayload;
    t_lim[i] = r[7];
    t_best[i] = prev[ray[i] * kPayload];
    // A fragment: K columns q and q + 4 of X = [o, d, 1, 0] for rows
    // (rays) g and g + 8, i.e. a[i] = X[q], a[2 + i] = X[q + 4] of ray i
    const float xk = r[q];  // o0, o1, o2, d0
    const float xk4 = q == 0 ? r[4] : q == 1 ? r[5] : q == 2 ? 1.0f : 0.0f;
    a_hi[i] = tf32(xk);
    a_lo[i] = tf32(xk - __uint_as_float(a_hi[i]));
    a_hi[2 + i] = tf32(xk4);
    a_lo[2 + i] = tf32(xk4 - __uint_as_float(a_hi[2 + i]));
  }
  const int n = nact[block];
  const int* list = clist + static_cast<size_t>(block) * num_clusters;
  const float* entry = bt0 + static_cast<size_t>(block) * num_clusters;
  int v = 0;
  bool go = n > 0;
  while (go) {
    const int c = list[v];
    __syncthreads();
    const float4* src = frags + static_cast<size_t>(c) * kFragsPerCluster;
    for (int k = tid; k < kFragsPerCluster; k += kThreads) s_frag[k] = src[k];
    __syncthreads();
    float tc[2] = {t_best[0], t_best[1]};
    int lc[2] = {-1, -1};
    for (int s = 0; s < kQuads; ++s) {
      float acc[kTiles][4];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const float4 b = s_frag[(s * kTiles + j) * 32 + lane];
        const uint32_t h0 = __float_as_uint(b.x), h1 = __float_as_uint(b.y);
        const uint32_t l0 = __float_as_uint(b.z), l1 = __float_as_uint(b.w);
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
        mma(acc[j], a_lo, h0, h1);
        mma(acc[j], a_hi, l0, l1);
        mma(acc[j], a_hi, h0, h1);
      }
      const int l = 4 * s + q;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float Q = acc[0][2 * i], P = acc[0][2 * i + 1];
        const float t = -P * __frcp_rn(Q);
        const float u = acc[1][2 * i + 1] + t * acc[1][2 * i];
        const float w = acc[2][2 * i + 1] + t * acc[2][2 * i];
        if (t > 0.0f && u >= 0.0f && w >= 0.0f && u + w <= 1.0f &&
            t < tc[i]) {
          tc[i] = t;
          lc[i] = l;
        }
      }
    }
    bool more = false;
    const float next_entry = entry[v + 1 < n ? v + 1 : n - 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      for (int off = 1; off < 4; off <<= 1) {
        const float to = __shfl_xor_sync(kFull, tc[i], off);
        const int lo = __shfl_xor_sync(kFull, lc[i], off);
        if (to < tc[i] || (to == tc[i] && lo < lc[i])) {
          tc[i] = to;
          lc[i] = lo;
        }
      }
      if (lc[i] >= 0) {
        t_best[i] = tc[i];
        win[i] = c * kTris + lc[i];
      }
      const float eff = t_best[i] < t_lim[i] ? t_best[i] : t_lim[i];
      more = more || eff > next_entry;
    }
    go = __syncthreads_or(more) && v + 1 < n;
    ++v;
  }
  if (q != 0) return;
  for (int i = 0; i < 2; ++i) {
    float* o = out + ray[i] * kPayload;
    if (win[i] >= 0) {
      o[0] = t_best[i];
      for (int k = 1; k < 10; ++k) o[k] = 0.0f;
      o[10] = mat_tbl[win[i]];
      o[11] = static_cast<float>(win[i]);
      for (int k = 12; k < kPayload; ++k) o[k] = 0.0f;
    } else {
      const float* p = prev + ray[i] * kPayload;
      for (int k = 0; k < kPayload; ++k) o[k] = p[k];
    }
  }
}

}  // namespace

// One CTA per 512-ray block; returns the launch's error code.
extern "C" int wc_mxu_tf32_probe(const void* nact, const void* clist,
                                 const void* bt0, const void* order,
                                 const void* rays, const void* prev,
                                 const void* frags, const void* mat_tbl,
                                 void* out, int num_blocks, int ray_block,
                                 int num_clusters, void* stream) {
  if (ray_block != kRayBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kFragsPerCluster * static_cast<int>(sizeof(float4));
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_kernel<<<num_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nact), static_cast<const int*>(clist),
      static_cast<const float*>(bt0), static_cast<const int*>(order),
      static_cast<const float*>(rays), static_cast<const float*>(prev),
      static_cast<const float4*>(frags), static_cast<const float*>(mat_tbl),
      static_cast<float*>(out), num_clusters);
  return static_cast<int>(cudaGetLastError());
}
