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
// Design:
//  1. Heaviest blocks first.  The wrapper passes `order`, the ray blocks by
//     active-cluster count, descending (one device argsort); CTAs take
//     blocks in that order, so long blocks start in the first wave.
//  2. One ray block on several SMs, each ray on several threads.  A thread
//     block cluster of `ctas` CTAs (cudaLaunchKernelEx) shares a ray block,
//     each CTA holding ray_block / ctas of its rays, and each ray is tested
//     by kGroups threads of one warp, lane group g taking slots g,
//     g + kGroups, ...  On the 512-ray main path: 4 CTAs of 128 rays x 4
//     groups = 512 threads, 32 slots per thread per visit, so a 171-visit
//     block runs 171 x 32 tests in a row per thread instead of 171 x 128.
//     Each group keeps its first minimum under strict `<` in ascending slot
//     order; two __shfl_xor_sync steps merge the groups (the smaller t, on
//     equal t the lower slot), which is the one-thread loop's result bit
//     for bit, and the update against t_best stays strict.  After each
//     visit every warp votes (__any_sync) on going on, writes a yes into
//     each CTA's shared memory (distributed shared memory), and the cluster
//     meets at one barrier; all CTAs then read the same block-wide vote.
//  3. Reject whole warps after u.  oa, p, det, inv_det and u are computed
//     as before; if no lane of the warp has 0 <= u <= 1, q, v and t are
//     skipped for that slot (a hit needs u in [0, 1]), and a second vote
//     skips t when no lane also has v >= 0 and u + v <= 1.  Every value
//     that is computed is computed in the same order as before.
//  4. Cheaper staging.  Each slot is staged as one 48-byte struct of three
//     float4 (a, b - a, c - a) behind a pointer hoisted out of the slot
//     loop (unrolled 4 times), so a test reads three broadcast LDS.128 and
//     keeps address arithmetic out of the loop; slabs are double-buffered, the
//     next one loaded into registers while the current one is tested, so
//     a visit needs one barrier.
//
// ptxas (nvcc 12.8, printed by chip_smoke.py's build step): 59 registers,
// 0 spills, 12,300 B of shared memory (2 x 128 slots x 48 B + the votes).
// Times, and the layouts measured against each other, are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterTris = 128;  // triangle slots per cluster
constexpr int kClusterRows = 16;   // f32 rows per slab: ax..cz, material, pad
constexpr int kPayloadCols = 16;   // t, 9 coords, material, slot id, 4 pad
constexpr int kMaxThreads = 1024;  // threads per CTA
constexpr int kMaxCtas = 8;        // CTAs per ray block (portable cluster size)
constexpr unsigned kFullWarp = 0xffffffffu;

struct Slot {  // one staged triangle slot: a, b - a, c - a (w unused)
  float4 a, e1, e2;
};

// kGroups threads per ray: lane = g * (32 / kGroups) + r holds lane group g
// of the warp's ray r and tests slots g, g + kGroups, ...
template <int kGroups>
__global__ void __launch_bounds__(kMaxThreads) cluster_sweep_kernel(
    const int* __restrict__ nact,     // (blocks,) active clusters per block
    const int* __restrict__ clist,    // (blocks, clusters) ids, front first
    const float* __restrict__ bt0,    // (blocks, clusters) entry distances
    const int* __restrict__ order,    // (blocks,) ray blocks, heaviest first
    const float* __restrict__ rays,   // (blocks * ray_block, 16) o, d, t, t_lim
    const float* __restrict__ prev,   // (blocks * ray_block, 16) initial payload
    const float* __restrict__ tris,   // (clusters * 16, 128) slabs
    float* __restrict__ out,          // (blocks * ray_block, 16) payload
    int* __restrict__ visits,         // (blocks,) clusters visited, or null
    int ray_block, int num_clusters) {
  constexpr int kPerWarp = 32 / kGroups;  // rays per warp
  // visit v tests s_slot[v % 2] while slab v + 1 is staged in the other
  __shared__ Slot s_slot[2][kClusterTris];
  __shared__ int s_go[3];  // exit vote after visit v in s_go[v % 3]

  cg::cluster_group group = cg::this_cluster();
  const int ctas = static_cast<int>(group.num_blocks());
  const int rank = static_cast<int>(group.block_rank());
  const int block = order[blockIdx.x / ctas];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32;
  const int g = lane / kPerWarp;
  const int per_cta = (ray_block + ctas - 1) / ctas;
  const int i = (tid / 32) * kPerWarp + lane % kPerWarp;  // ray in this CTA
  const int k = rank * per_cta + i;                        // ray in the block
  const bool valid = i < per_cta && k < ray_block;
  const size_t ray = static_cast<size_t>(block) * ray_block + (valid ? k : 0);

  // A thread without a ray keeps o = d = 0 (every test is NaN, so false)
  // and never votes to go on.
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float t_lim = 0.0f, t_best = 0.0f;
  if (valid) {
    const float* r = rays + ray * kPayloadCols;
    ox = r[0]; oy = r[1]; oz = r[2];
    dx = r[3]; dy = r[4]; dz = r[5];
    t_lim = r[7];
    t_best = prev[ray * kPayloadCols];
  }
  int win = -1;
  const bool warp_live = __any_sync(kFullWarp, valid);

  const int n = nact[block];
  const int* list = clist + static_cast<size_t>(block) * num_clusters;
  const float* entry = bt0 + static_cast<size_t>(block) * num_clusters;
  // threads 0..127 stage one slot each (blockDim >= 128); pf holds the
  // next slab to stage, loaded a visit ahead
  const bool stager = tid < kClusterTris;
  float pf[9];
  auto fetch = [&](int c) {
    const float* slab = tris + static_cast<size_t>(c) * kClusterRows * kClusterTris;
#pragma unroll
    for (int q = 0; q < 9; ++q) pf[q] = slab[q * kClusterTris + tid];
  };
  auto stage = [&](int buf) {
    Slot& sl = s_slot[buf][tid];
    sl.a = make_float4(pf[0], pf[1], pf[2], 0.0f);
    sl.e1 = make_float4(pf[3] - pf[0], pf[4] - pf[1], pf[5] - pf[2], 0.0f);
    sl.e2 = make_float4(pf[6] - pf[0], pf[7] - pf[1], pf[8] - pf[2], 0.0f);
  };
  if (tid < 3) s_go[tid] = 0;
  if (stager && n > 0) {
    fetch(list[0]);
    stage(0);
    if (n > 1) fetch(list[1]);
  }
  group.sync();  // slab 0 staged, votes cleared, every CTA started

  int v = 0;
  bool go = n > 0;  // uniform across the ray block
  while (go) {
    if (warp_live) {
      // this group's first minimum over slots g, g + kGroups, ... under
      // strict `<` (lc = -1: none below t_best)
      float tc = t_best;
      int lc = -1;
      const Slot* sp = &s_slot[v % 2][g];
#pragma unroll 4
      for (int l = g; l < kClusterTris; l += kGroups, sp += kGroups) {
        const float4 a = sp->a, e1 = sp->e1, e2 = sp->e2;
        // Moller-Trumbore, in ops/intersect.py::_moller_trumbore's order
        const float oax = ox - a.x, oay = oy - a.y, oaz = oz - a.z;
        const float px = dy * e2.z - dz * e2.y;
        const float py = dz * e2.x - dx * e2.z;
        const float pz = dx * e2.y - dy * e2.x;
        const float inv_det = 1.0f / (e1.x * px + e1.y * py + e1.z * pz);
        const float u = (oax * px + oay * py + oaz * pz) * inv_det;
        const bool u_in = (u >= 0.0f) & (u <= 1.0f);
        if (!__any_sync(kFullWarp, u_in)) continue;  // no lane can hit
        const float qx = oay * e1.z - oaz * e1.y;
        const float qy = oaz * e1.x - oax * e1.z;
        const float qz = oax * e1.y - oay * e1.x;
        const float w = dx * (qx * inv_det) + dy * (qy * inv_det) + dz * (qz * inv_det);
        const bool uv_in = u_in & (w >= 0.0f) & (u + w <= 1.0f);
        if (!__any_sync(kFullWarp, uv_in)) continue;
        const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
        if (uv_in && t > 0.0f && t < tc) {
          tc = t;
          lc = l;
        }
      }
      // merge the groups of a ray: the smaller t, on equal t the lower slot
      // -- the one-thread loop's first minimum over all 128 slots
#pragma unroll
      for (int off = kPerWarp; off < 32; off <<= 1) {
        const float to = __shfl_xor_sync(kFullWarp, tc, off);
        const int lo = __shfl_xor_sync(kFullWarp, lc, off);
        if (to < tc || (to == tc && lo < lc)) {
          tc = to;
          lc = lo;
        }
      }
      if (lc >= 0) {
        t_best = tc;
        win = list[v] * kClusterTris + lc;
      }
    }
    const float next_entry = entry[v + 1 < n ? v + 1 : n - 1];
    const float eff = t_best < t_lim ? t_best : t_lim;
    // s_go[(v + 1) % 3] was last read after barrier v - 2, before its
    // reader arrived at barrier v - 1; it is next written after barrier v
    if (tid == 0) s_go[(v + 1) % 3] = 0;
    if (__any_sync(kFullWarp, valid && eff > next_entry) && lane == 0) {
      for (int r = 0; r < ctas; ++r) *group.map_shared_rank(&s_go[v % 3], r) = 1;
    }
    // s_slot[(v + 1) % 2] was last read in visit v - 1, before barrier v - 1
    if (stager && v + 1 < n) {
      stage((v + 1) % 2);
      if (v + 2 < n) fetch(list[v + 2]);
    }
    group.sync();  // barrier v: votes and slab v + 1 visible cluster-wide
    go = s_go[v % 3] && v + 1 < n;
    ++v;
  }
  if (visits != nullptr && rank == 0 && tid == 0) visits[block] = v;
  if (!valid || g != 0) return;

  float* o = out + ray * kPayloadCols;
  if (win >= 0) {
    const float* slab =
        tris + static_cast<size_t>(win / kClusterTris) * kClusterRows * kClusterTris;
    const int l = win % kClusterTris;
    o[0] = t_best;
    for (int c = 0; c < 10; ++c) o[1 + c] = slab[c * kClusterTris + l];
    o[11] = static_cast<float>(win);
    for (int c = 12; c < kPayloadCols; ++c) o[c] = 0.0f;
  } else {
    const float* p = prev + ray * kPayloadCols;
    for (int c = 0; c < kPayloadCols; ++c) o[c] = p[c];
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t) as num_blocks thread block clusters of
// `ctas` CTAs each, `groups` (1, 2, 4 or 8) threads per ray; returns the
// launch's error code (0 on success), so a refused launch is reported to the
// caller.
extern "C" int wc_cluster_sweep(const void* nact, const void* clist,
                                const void* bt0, const void* order,
                                const void* rays, const void* prev,
                                const void* tris, void* out, void* visits,
                                int num_blocks, int ray_block,
                                int num_clusters, int ctas, int groups,
                                void* stream) {
  if (ctas < 1 || ctas > kMaxCtas ||
      (groups != 1 && groups != 2 && groups != 4 && groups != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_cta = (ray_block + ctas - 1) / ctas;
  int threads = (per_cta * groups + 31) / 32 * 32;
  if (threads < kClusterTris) threads = kClusterTris;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_blocks * ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto launch = [&](auto kernel) {
    return cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const int*>(nact),
        static_cast<const int*>(clist), static_cast<const float*>(bt0),
        static_cast<const int*>(order), static_cast<const float*>(rays),
        static_cast<const float*>(prev), static_cast<const float*>(tris),
        static_cast<float*>(out), static_cast<int*>(visits), ray_block,
        num_clusters);
  };
  const cudaError_t err = groups == 1   ? launch(cluster_sweep_kernel<1>)
                          : groups == 2 ? launch(cluster_sweep_kernel<2>)
                          : groups == 4 ? launch(cluster_sweep_kernel<4>)
                                        : launch(cluster_sweep_kernel<8>);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
