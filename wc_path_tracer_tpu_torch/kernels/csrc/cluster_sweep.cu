// Cluster-sweep closest hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wc_path_tracer_tpu/kernels/cluster.py
// ::_make_sweep_kernel (Pallas, launched by _sweep_chunk under
// cluster_sweep).  Same inputs, same payload, same visit order, tie rule and
// early exit; the plain PyTorch twin is
// wc_path_tracer_tpu_torch/kernels/cluster.py::cluster_sweep_plain, and the
// two agree bit for bit (payload and visits).
//
// What bounds it: operations.  Each ray x slot test is 48 FP32
// add/sub/mul/div and 6 compares (54 ops) against the H100's 67 TFLOP/s
// FP32 peak (700 W); bytes do not bind (the bunny's table is 1.4 MB and
// stays in L2).  That peak counts an FMA as two ops; built with -fmad=false
// (every product and sum rounded as in the op-by-op twin) each op is its
// own instruction at one per lane per clock, so half the peak is the
// ceiling.  The first version of this kernel (one CTA of one thread per ray
// per ray block) was held far below it by (1) the slowest ray blocks: a
// bounce block can visit all 171 of the bunny's clusters, 128 x 171 tests in
// a row for each of its threads on one SM, and (2) every test computed q,
// v and t although most warps have no lane with 0 <= u <= 1.
//
// Design: the block sweep of sweep_skeleton.cuh (heaviest ray blocks first,
// a thread block cluster of CTAs per ray block with lane groups per ray,
// one distributed-shared-memory exit vote per visit, double-buffered
// slabs, any ray block), with this slot test:
//  - each slot is staged as (a, b - a, c - a), three float4;
//  - oa, p, det, inv_det and u are computed in the twin's order; if no lane
//    of the warp has 0 <= u <= 1, q, v and t are skipped for that slot (a
//    hit needs u in [0, 1]), and a second vote skips t when no lane also
//    has v >= 0 and u + v <= 1.  Every value that is computed is computed
//    in the same order as before.
// On the 512-ray main path a ray block is 4 CTAs of 128 rays x 4 lane
// groups = 512 threads, 32 slots per thread per visit, so a 171-visit block
// runs 171 x 32 tests in a row per thread instead of 171 x 128.
//
// ptxas (nvcc 12.8, printed by chip_smoke.py's build step) gives registers,
// spills and shared memory (2 x 128 slots x 48 B + the votes) per build.
// Times, and the layouts measured against each other, are in PERF.md.

#include "sweep_skeleton.cuh"

namespace {

constexpr int kClusterRows = 16;  // f32 rows per slab: ax..cz, material, pad

struct MtTest {
  static constexpr int kFetch = 9;  // ax..cz
  static constexpr bool kCounts = false;

  static __device__ void fetch(const float* __restrict__ tris, int c, int l,
                               float (&pf)[kFetch]) {
    const float* slab =
        tris + static_cast<size_t>(c) * kClusterRows * sweep::kClusterTris;
#pragma unroll
    for (int q = 0; q < kFetch; ++q) pf[q] = slab[q * sweep::kClusterTris + l];
  }

  static __device__ sweep::Slot stage(const float (&pf)[kFetch]) {
    return sweep::Slot{
        make_float4(pf[0], pf[1], pf[2], 0.0f),
        make_float4(pf[3] - pf[0], pf[4] - pf[1], pf[5] - pf[2], 0.0f),
        make_float4(pf[6] - pf[0], pf[7] - pf[1], pf[8] - pf[2], 0.0f)};
  }

  template <bool kCount>
  static __device__ void test(const sweep::Slot& s, int l, const sweep::Ray& r,
                              float& tc, int& lc, sweep::Counts&) {
    const float4 a = s.x, e1 = s.y, e2 = s.z;
    // Moller-Trumbore, in ops/intersect.py::_moller_trumbore's order
    const float oax = r.ox - a.x, oay = r.oy - a.y, oaz = r.oz - a.z;
    const float px = r.dy * e2.z - r.dz * e2.y;
    const float py = r.dz * e2.x - r.dx * e2.z;
    const float pz = r.dx * e2.y - r.dy * e2.x;
    const float inv_det = 1.0f / (e1.x * px + e1.y * py + e1.z * pz);
    const float u = (oax * px + oay * py + oaz * pz) * inv_det;
    const bool u_in = (u >= 0.0f) & (u <= 1.0f);
    if (!__any_sync(sweep::kFullWarp, u_in)) return;  // no lane can hit
    const float qx = oay * e1.z - oaz * e1.y;
    const float qy = oaz * e1.x - oax * e1.z;
    const float qz = oax * e1.y - oay * e1.x;
    const float w = r.dx * (qx * inv_det) + r.dy * (qy * inv_det) + r.dz * (qz * inv_det);
    const bool uv_in = u_in & (w >= 0.0f) & (u + w <= 1.0f);
    if (!__any_sync(sweep::kFullWarp, uv_in)) return;
    const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
    if (uv_in && t > 0.0f && t < tc) {
      tc = t;
      lc = l;
    }
  }

  // [t, the winner's 9 coordinates and material, slot id, 0 x 4]
  static __device__ void winner(const float* __restrict__ tris, const float*,
                                int win, float t, float* o) {
    const float* slab = tris + static_cast<size_t>(win / sweep::kClusterTris) *
                                   kClusterRows * sweep::kClusterTris;
    const int l = win % sweep::kClusterTris;
    o[0] = t;
    for (int c = 0; c < 10; ++c) o[1 + c] = slab[c * sweep::kClusterTris + l];
    o[11] = static_cast<float>(win);
    for (int c = 12; c < sweep::kPayloadCols; ++c) o[c] = 0.0f;
  }
};

}  // namespace

// Launch on `stream` (a cudaStream_t) as num_blocks thread block clusters of
// `ctas` CTAs each, `groups` (1, 2, 4 or 8) threads per ray, `passes` passes
// per visit (more than 1 needs `state`, (blocks * ray_block) int2); returns
// the launch's error code (0 on success), so a refused launch is reported
// to the caller.
extern "C" int wc_cluster_sweep(const void* nact, const void* clist,
                                const void* bt0, const void* order,
                                const void* rays, const void* prev,
                                const void* tris, void* out, void* visits,
                                void* state, int num_blocks, int ray_block,
                                int num_clusters, int ctas, int groups,
                                int passes, void* stream) {
  return sweep::launch<MtTest>(nact, clist, bt0, order, rays, prev, tris,
                               nullptr, out, visits, state, nullptr,
                               num_blocks, ray_block, num_clusters, ctas,
                               groups, passes, stream);
}

extern "C" const char* wc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
