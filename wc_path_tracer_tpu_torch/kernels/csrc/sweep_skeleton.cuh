// The block sweep both cluster-sweep kernels share (cluster_sweep.cu, B1,
// Moller-Trumbore; cluster_sweep_mxu.cu, B2, the plane form), templated on
// the slot test.  Each source keeps its own note on what bounds it; this
// header holds the layout, the visit loop, the tie rule, the exit vote and
// the launch, written once.
//
//  1. Heaviest blocks first.  The wrapper passes `order`, the ray blocks by
//     active-cluster count, descending (one device argsort); CTAs take
//     blocks in that order, so long blocks start in the first wave.
//  2. One ray block on several SMs, each ray on several threads.  A thread
//     block cluster of `ctas` CTAs (cudaLaunchKernelEx) shares a ray block,
//     each CTA holding ray_block / ctas of its rays, and each ray is tested
//     by kGroups threads of one warp, lane group g taking slots g,
//     g + kGroups, ...  Each group keeps its first minimum under strict `<`
//     in ascending slot order; two __shfl_xor_sync steps merge the groups
//     (the smaller t, on equal t the lower slot), which is the one-thread
//     loop's result bit for bit, and the update against t_best stays
//     strict.  After each visit every warp votes (__any_sync) on going on,
//     writes a yes into each CTA's shared memory (distributed shared
//     memory), and the cluster meets at one barrier; all CTAs then read
//     the same block-wide vote.
//  3. The slot test (the policy P) rejects whole warps as early as its
//     arithmetic allows, and computes every value it does compute in the
//     twin's order.
//  4. Staging.  A slot is one 48-byte record of three float4 that the
//     policy gathers from the cluster's slab, so a test reads three
//     broadcast LDS.128; slabs are double-buffered, the next one loaded into
//     registers while the current one is tested, so a visit needs one
//     barrier.
//  5. Any ray block.  A cluster holds up to 8 CTAs x 1,024 threads; a ray
//     block with more rays than its threads can hold one each (kScratch)
//     takes `passes` passes per visit, each over the next share of the
//     block's rays, with t_best and the winner kept in `state` (allocated
//     by the wrapper) and o, d and t_lim re-read from `rays`.  The exit vote
//     is still one per visit, over every ray of the block.
//
// A policy P provides:
//   kFetch, fetch(table, c, l, pf)  the kFetch floats slot l of cluster c
//                                   needs, loaded from the table
//   stage(pf) -> Slot               the staged record
//   test<kCount>(slot, l, ray, tc, lc, counts)
//                                   test slot l, keep (tc, lc) the first
//                                   minimum under strict `<`
//   winner(table, aux, win, t, o)   the payload row of a winner
//   kCounts                         whether the launcher may count votes

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace sweep {

namespace cg = cooperative_groups;

constexpr int kClusterTris = 128;  // triangle slots per cluster
constexpr int kPayloadCols = 16;   // t, 9 coords, material, slot id, 4 pad
constexpr int kMaxThreads = 1024;  // threads per CTA
constexpr int kMaxCtas = 8;        // CTAs per ray block (portable cluster size)
constexpr unsigned kFullWarp = 0xffffffffu;

struct Slot {  // one staged triangle slot; the policy gives it its meaning
  float4 x, y, z;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Per-thread vote counts (every lane of a warp counts the same): slot steps
// the warp tested, and those that passed the policy's first and second vote.
struct Counts {
  unsigned tested, vote1, vote2;
};

// kGroups threads per ray: lane = g * (32 / kGroups) + r holds lane group g
// of the warp's ray r and tests slots g, g + kGroups, ...
template <class P, int kGroups, bool kScratch, bool kCount>
__global__ void __launch_bounds__(kMaxThreads) sweep_kernel(
    const int* __restrict__ nact,     // (blocks,) active clusters per block
    const int* __restrict__ clist,    // (blocks, clusters) ids, front first
    const float* __restrict__ bt0,    // (blocks, clusters) entry distances
    const int* __restrict__ order,    // (blocks,) ray blocks, heaviest first
    const float* __restrict__ rays,   // (blocks * ray_block, 16) o, d, t, t_lim
    const float* __restrict__ prev,   // (blocks * ray_block, 16) initial payload
    const float* __restrict__ table,  // the policy's slab table
    const float* __restrict__ aux,    // the policy's second table, or null
    float* __restrict__ out,          // (blocks * ray_block, 16) payload
    int* __restrict__ visits,         // (blocks,) clusters visited, or null
    int2* state,                      // kScratch: (blocks * ray_block,) t_best, win
    unsigned long long* counts,       // kCount: (3,) slot steps, votes 1 and 2
    int ray_block, int num_clusters, int passes) {
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
  if (!kScratch) passes = 1;
  const int per_cta = (ray_block + ctas * passes - 1) / (ctas * passes);
  const int i = (tid / 32) * kPerWarp + lane % kPerWarp;  // ray in this CTA
  // the ray of this thread in pass p; a thread without one reads ray 0
  bool valid;
  auto ray_of = [&](int p) {
    const int k = (p * ctas + rank) * per_cta + i;  // ray in the block
    valid = i < per_cta && k < ray_block;
    return static_cast<size_t>(block) * ray_block + (valid ? k : 0);
  };

  // A thread without a ray keeps o = d = 0 (every test is NaN, so false)
  // and never votes to go on.
  Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float t_lim = 0.0f, t_best = 0.0f;
  int win = -1;
  auto load = [&](size_t ray) {
    const float* q = rays + ray * kPayloadCols;
    r = Ray{q[0], q[1], q[2], q[3], q[4], q[5]};
    t_lim = q[7];
  };
  size_t ray = ray_of(0);
  if (!kScratch && valid) {
    load(ray);
    t_best = prev[ray * kPayloadCols];
  }
  bool warp_live = __any_sync(kFullWarp, valid);
  if (kScratch) {
    for (int p = 0; p < passes; ++p) {
      ray = ray_of(p);
      if (valid && g == 0)
        state[ray] = make_int2(__float_as_int(prev[ray * kPayloadCols]), -1);
    }
  }

  const int n = nact[block];
  const int* list = clist + static_cast<size_t>(block) * num_clusters;
  const float* entry = bt0 + static_cast<size_t>(block) * num_clusters;
  // threads 0..127 stage one slot each (blockDim >= 128); pf holds the
  // next slab's records, loaded a visit ahead
  const bool stager = tid < kClusterTris;
  float pf[P::kFetch];
  auto stage = [&](int buf) { s_slot[buf][tid] = P::stage(pf); };
  if (tid < 3) s_go[tid] = 0;
  if (stager && n > 0) {
    P::fetch(table, list[0], tid, pf);
    stage(0);
    if (n > 1) P::fetch(table, list[1], tid, pf);
  }
  group.sync();  // slab 0 staged, votes and state set, every CTA started

  Counts cnt = {0u, 0u, 0u};
  int v = 0;
  bool go = n > 0;  // uniform across the ray block
  while (go) {
    const float next_entry = entry[v + 1 < n ? v + 1 : n - 1];
    bool more = false;
    for (int p = 0; p < passes; ++p) {
      if (kScratch) {
        ray = ray_of(p);
        r = Ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        t_lim = t_best = 0.0f;
        if (valid) {
          load(ray);
          const int2 s = state[ray];
          t_best = __int_as_float(s.x);
          win = s.y;
        }
        warp_live = __any_sync(kFullWarp, valid);
      }
      bool upd = false;
      if (warp_live) {
        // this group's first minimum over slots g, g + kGroups, ... under
        // strict `<` (lc = -1: none below t_best)
        float tc = t_best;
        int lc = -1;
        const Slot* sp = &s_slot[v % 2][g];
#pragma unroll 4
        for (int l = g; l < kClusterTris; l += kGroups, sp += kGroups)
          P::template test<kCount>(*sp, l, r, tc, lc, cnt);
        // merge the groups of a ray: the smaller t, on equal t the lower
        // slot -- the one-thread loop's first minimum over all 128 slots
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
          upd = true;
        }
      }
      const float eff = t_best < t_lim ? t_best : t_lim;
      more = more || (valid && eff > next_entry);
      if (kScratch && upd && valid && g == 0)
        state[ray] = make_int2(__float_as_int(t_best), win);
    }
    // s_go[(v + 1) % 3] was last read after barrier v - 2, before its
    // reader arrived at barrier v - 1; it is next written after barrier v
    if (tid == 0) s_go[(v + 1) % 3] = 0;
    if (__any_sync(kFullWarp, more) && lane == 0) {
      for (int c = 0; c < ctas; ++c) *group.map_shared_rank(&s_go[v % 3], c) = 1;
    }
    // s_slot[(v + 1) % 2] was last read in visit v - 1, before barrier v - 1
    if (stager && v + 1 < n) {
      stage((v + 1) % 2);
      if (v + 2 < n) P::fetch(table, list[v + 2], tid, pf);
    }
    group.sync();  // barrier v: votes and slab v + 1 visible cluster-wide
    go = s_go[v % 3] && v + 1 < n;
    ++v;
  }
  if (visits != nullptr && rank == 0 && tid == 0) visits[block] = v;
  if (kCount && lane == 0 && warp_live) {
    atomicAdd(&counts[0], static_cast<unsigned long long>(cnt.tested));
    atomicAdd(&counts[1], static_cast<unsigned long long>(cnt.vote1));
    atomicAdd(&counts[2], static_cast<unsigned long long>(cnt.vote2));
  }

  for (int p = 0; p < passes; ++p) {
    if (kScratch) {
      ray = ray_of(p);
      if (valid) {
        const int2 s = state[ray];
        t_best = __int_as_float(s.x);
        win = s.y;
      }
    }
    if (!valid || g != 0) continue;
    float* o = out + ray * kPayloadCols;
    if (win >= 0) {
      P::winner(table, aux, win, t_best, o);
    } else {
      const float* q = prev + ray * kPayloadCols;
      for (int c = 0; c < kPayloadCols; ++c) o[c] = q[c];
    }
  }
}

// Launch num_blocks thread block clusters of `ctas` CTAs each, `groups`
// (1, 2, 4 or 8) threads per ray and `passes` passes over each ray block per
// visit (more than 1 needs `state`), on `stream`; `counts` (or null) needs
// P::kCounts and one pass.  Returns the launch's error code (0 on
// success), so a refused launch is reported to the caller.
template <class P>
int launch(const void* nact, const void* clist, const void* bt0,
           const void* order, const void* rays, const void* prev,
           const void* table, const void* aux, void* out, void* visits,
           void* state, void* counts, int num_blocks, int ray_block,
           int num_clusters, int ctas, int groups, int passes, void* stream) {
  const bool scratch = passes > 1;
  if (ctas < 1 || ctas > kMaxCtas || passes < 1 ||
      (groups != 1 && groups != 2 && groups != 4 && groups != 8) ||
      (scratch && state == nullptr) ||
      (counts != nullptr && (!P::kCounts || scratch)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_cta = (ray_block + ctas * passes - 1) / (ctas * passes);
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
  auto run = [&](auto kernel) {
    return cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const int*>(nact),
        static_cast<const int*>(clist), static_cast<const float*>(bt0),
        static_cast<const int*>(order), static_cast<const float*>(rays),
        static_cast<const float*>(prev), static_cast<const float*>(table),
        static_cast<const float*>(aux), static_cast<float*>(out),
        static_cast<int*>(visits), static_cast<int2*>(state),
        static_cast<unsigned long long*>(counts), ray_block, num_clusters,
        passes);
  };
  auto by_mode = [&](auto one, auto many, auto counted) {
    if (counts != nullptr) return run(counted);
    return scratch ? run(many) : run(one);
  };
  cudaError_t err;
  // counting builds exist only for policies that count
  constexpr bool kC = P::kCounts;
  switch (groups) {
    case 1:
      err = by_mode(sweep_kernel<P, 1, false, false>, sweep_kernel<P, 1, true, false>,
                    sweep_kernel<P, 1, false, kC>);
      break;
    case 2:
      err = by_mode(sweep_kernel<P, 2, false, false>, sweep_kernel<P, 2, true, false>,
                    sweep_kernel<P, 2, false, kC>);
      break;
    case 4:
      err = by_mode(sweep_kernel<P, 4, false, false>, sweep_kernel<P, 4, true, false>,
                    sweep_kernel<P, 4, false, kC>);
      break;
    default:
      err = by_mode(sweep_kernel<P, 8, false, false>, sweep_kernel<P, 8, true, false>,
                    sweep_kernel<P, 8, false, kC>);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sweep
