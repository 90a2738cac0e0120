// Cluster cull and per-block cluster order for NVIDIA Hopper (sm_90a): C1.
//
// Replaces no TPU kernel.  In the JAX package the cull of
// wc_path_tracer_tpu/kernels/cluster.py::cluster_sweep (its slab test, the
// per-block reductions, the argsort and the packing before the Pallas
// sweep) is jnp code that XLA fuses.  In eager PyTorch each of its ~47
// kernel launches a query writes a (rays x clusters) tensor to device
// memory: 262,144 x 160 elements for a 512^2 bunny query, ~4.5 ms.  This
// kernel does all of it in one launch and keeps every (rays x clusters)
// value on chip.  Its plain twin is
// wc_path_tracer_tpu_torch/kernels/cluster.py::cull_order_plain (padding,
// ``_cull``, ``nact``, the stable argsort of each block's entry distances,
// their gather and the packing of the sweep's `rays` and `prev`), and the
// two agree in every output: nact, the cluster lists and `prev` bit for
// bit, the entry distances and `rays` as floats (a zero's sign aside, see
// below).
//
// Per ray block, one CTA:
//  1. Rays.  Thread j takes rays j, j + threads, ... of the block; a row
//     past the query's last ray repeats ray 0 (the twin's padding), read in
//     place.
//  2. Cull.  inv = 1 / d (IEEE division); per axis x, y, z in
//     ops/intersect.py::ray_box_sweep's order tb = (bmin - o) * inv, tt =
//     (bmax - o) * inv, tmin = minimum(tb, tt), tmax = maximum(tb, tt),
//     t0 = maximum(t0, tmin), t1 = minimum(t1, tmax), with torch's
//     minimum / maximum, which propagate NaN (a 0 x inf on a box face makes
//     the ray not enter; fminf / fmaxf would drop the NaN).  A ray enters a
//     cluster where t0 <= t1, t1 >= 0, t0 < its bound and the box is live
//     (min <= max on every axis: an all-dead cluster's (+KINF, -KINF) box
//     is entered by no ray; it is staged with a NaN corner, which makes t0
//     and t1 NaN).  The boxes are staged in shared memory a tile at a time;
//     every thread reads the same box (a broadcast).
//  3. Reductions.  t_lim, a ray's farthest exit, is a running maximum in
//     its thread (-KINF where it enters nothing).  bt0, the block's least
//     entry per cluster (KINF where no ray enters), is one 64-bit key a
//     cluster: the entry's order-preserving 32-bit code above the cluster
//     id.  A warp that has a ray entering reduces its codes with
//     __reduce_min_sync and its lane 0 takes an atomicMin.  Nothing of size
//     rays x clusters reaches device memory.
//  4. Order.  A bitonic sort of the keys (padded to a power of two).  Keys compare as (entry, cluster id), which is
//     torch.argsort(bt0, dim=1, stable=True): equal entries keep their
//     cluster order, so the sweep's tie rule (the first-visited cluster
//     wins an exact t tie) is the twin's.  -0.0 is coded as +0.0, since
//     the two compare equal; a block's list therefore holds the entry
//     distance +0.0 where the twin may hold -0.0 (equal as floats).
//     nact is the count of keys below KINF's code.
//  5. Packing.  Each thread writes its rays' rows of `rays` (o, d, t_init,
//     t_lim, 0 x 8) and `prev` (t_init, 0 x 10, -1, 0 x 4); once sorted,
//     the CTA writes its block's clist (int32), entry distances and nact.
//
// What bounds it: operations, barely.  A 512^2 bunny query is 262,144 x
// 160 slab tests of ~25 FP32 operations, ~1 GFLOP, ~0.016 ms at 67
// TFLOP/s; it reads ~4 MB of rays and writes ~34 MB of `rays` / `prev` and
// ~0.7 MB of lists, ~0.012 ms at 3.35 TB/s.  The per-cluster warp
// reduction, the shared atomic and the sort's barriers are what it adds.
//
// Any ray block: a CTA has up to 512 threads and loops over the block's
// rays.  Any number of clusters: up to kSharedClusters the keys live in
// shared memory, 8 bytes a cluster (64 KB at 8,192, opted in above 48 KB);
// above that each CTA keeps its block's keys in its row of a (blocks, keys)
// scratch in device memory, which the caller allocates, of size blocks x
// clusters and not rays x clusters.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 4;              // CTAs an SM holds: 2,048 threads
constexpr int kTile = 256;                 // cluster boxes staged per tile
constexpr int kSharedClusters = 8192;      // cluster.CULL_SHARED_CLUSTERS
constexpr int kCols = 16;                  // columns of `rays` and `prev`
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kInf = 0x1.fffffep+127f;   // cluster.KINF, float32 max
constexpr int kStaticSmem = 48 * 1024;

struct Params {
  const float* o;        // (rays_in, 3), or one row read by every ray
  const float* d;        // (rays_in, 3)
  const float* t_init;   // (rays_in,) search bound, -KINF disables a ray
  const float* cmin;     // (clusters, 3) box corners
  const float* cmax;
  int* nact;             // (blocks,) active clusters
  int* clist;            // (blocks, clusters) ids, front to back
  float* bt0;            // (blocks, clusters) entry distances, sorted
  float* rays;           // (blocks, ray_block, 16)
  float* prev;           // (blocks, ray_block, 16)
  unsigned long long* scratch;  // (blocks, keys) above kSharedClusters
  int rays_in, o_stride, ray_block, clusters, keys;  // keys: 2^k >= clusters
};

// An order-preserving code of a float that is not NaN, -0.0 coded as +0.0.
__device__ __forceinline__ unsigned order_code(float x) {
  const unsigned u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_code(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// torch.minimum / torch.maximum: NaN if either operand is NaN (one
// instruction each, sm_80 and later)
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// kGlobalKeys: the block's sort keys in its row of q.scratch, else in
// shared memory after the staged boxes.  __syncthreads orders a CTA's
// device-memory accesses as it does its shared ones.
template <bool kGlobalKeys>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    cluster_cull(const Params q) {
  extern __shared__ float4 smem[];
  float4* box = smem;                                        // 2 x kTile
  unsigned long long* key =
      kGlobalKeys
          ? q.scratch + static_cast<size_t>(blockIdx.x) * q.keys
          : reinterpret_cast<unsigned long long*>(smem + 2 * kTile);

  const int C = q.clusters;
  const int block = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned none = order_code(kInf);
  for (int c = threadIdx.x; c < q.keys; c += blockDim.x)
    key[c] = c < C ? (static_cast<unsigned long long>(none) << 32) | c
                   : ~0ull;

  for (int base = 0; base < q.ray_block; base += blockDim.x) {
    // threads past the block's last ray test ray 0 and enter nothing: every
    // thread stays in the barriers and the warp reductions
    const int j = base + threadIdx.x;
    const bool mine = j < q.ray_block;
    const size_t r = static_cast<size_t>(block) * q.ray_block + (mine ? j : 0);
    const size_t src = r < static_cast<size_t>(q.rays_in) ? r : 0;
    const float* op = q.o + static_cast<size_t>(q.o_stride) * src;
    const float o[3] = {op[0], op[1], op[2]};
    const float d[3] = {q.d[3 * src], q.d[3 * src + 1], q.d[3 * src + 2]};
    const float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
    const float bound = q.t_init[src];
    float t_lim = -kInf;

    for (int tile = 0; tile < C; tile += kTile) {
      const int n = min(kTile, C - tile);
      __syncthreads();  // the previous tile's reads are done
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        const float* mn = q.cmin + 3 * static_cast<size_t>(tile + c);
        const float* mx = q.cmax + 3 * static_cast<size_t>(tile + c);
        // a dead box is staged with a NaN corner: its slab distances, and
        // so t0 and t1, are NaN, and no ray enters it
        const bool live = (mn[0] <= mx[0]) & (mn[1] <= mx[1]) &
                          (mn[2] <= mx[2]);
        box[2 * c] = make_float4(live ? mn[0] : __int_as_float(0x7fc00000),
                                 mn[1], mn[2], 0.0f);
        box[2 * c + 1] = make_float4(mx[0], mx[1], mx[2], 0.0f);
      }
      __syncthreads();
      for (int c = 0; c < n; ++c) {
        const float4 lo = box[2 * c], hi = box[2 * c + 1];
        const float bmin[3] = {lo.x, lo.y, lo.z};
        const float bmax[3] = {hi.x, hi.y, hi.z};
        float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float tb = (bmin[k] - o[k]) * inv[k];
          const float tt = (bmax[k] - o[k]) * inv[k];
          const float tmin = nan_min(tb, tt);
          const float tmax = nan_max(tb, tt);
          t0 = k == 0 ? tmin : nan_max(t0, tmin);
          t1 = k == 0 ? tmax : nan_min(t1, tmax);
        }
        const bool enter = mine & (t0 <= t1) & (t1 >= 0.0f) & (t0 < bound);
        if (!__any_sync(kFullWarp, enter)) continue;
        if (enter && t1 > t_lim) t_lim = t1;
        const unsigned m = __reduce_min_sync(kFullWarp,
                                             enter ? order_code(t0) : none);
        if (lane == 0 && m < none)
          atomicMin(&key[tile + c],
                    (static_cast<unsigned long long>(m) << 32) | (tile + c));
      }
    }

    if (mine) {
      float4* rw = reinterpret_cast<float4*>(q.rays + kCols * r);
      float4* pw = reinterpret_cast<float4*>(q.prev + kCols * r);
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      rw[0] = make_float4(o[0], o[1], o[2], d[0]);
      rw[1] = make_float4(d[1], d[2], bound, t_lim);
      rw[2] = z;
      rw[3] = z;
      pw[0] = make_float4(bound, 0.0f, 0.0f, 0.0f);
      pw[1] = z;
      pw[2] = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
      pw[3] = z;
    }
  }
  __syncthreads();

  // bitonic sort of the keys, ascending
  const int half = q.keys >> 1;
  for (int k = 2; k <= q.keys; k <<= 1) {
    for (int s = k >> 1; s > 0; s >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = 2 * s * (p / s) + p % s;
        const int l = i + s;
        const unsigned long long a = key[i], b = key[l];
        if ((a > b) == ((i & k) == 0)) {
          key[i] = b;
          key[l] = a;
        }
      }
      __syncthreads();
    }
  }

  const size_t row = static_cast<size_t>(block) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const unsigned long long k = key[c];
    const unsigned code = static_cast<unsigned>(k >> 32);
    q.clist[row + c] = static_cast<int>(k & 0xffffffffu);
    q.bt0[row + c] = from_code(code);
    const bool active = code < none;
    const bool next =
        c + 1 < C && static_cast<unsigned>(key[c + 1] >> 32) < none;
    if (active && !next) q.nact[block] = c + 1;
    if (c == 0 && !active) q.nact[block] = 0;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t), one CTA per ray block of
// `ray_block` rays over `clusters` clusters (1 or more); the query has
// `rays_in` rays, the last block padded with ray 0.  `o_stride` is the row
// stride of `o` in floats (3, or 0 for one origin shared by every ray).
// Above kSharedClusters clusters `scratch` holds blocks x keys 64-bit
// words, keys the least power of two >= clusters; else it may be null.
// Returns the launch's error code (0 on success), so a refused launch is
// reported to the caller.
extern "C" int wc_cluster_cull(const void* o, const void* d,
                               const void* t_init, const void* cmin,
                               const void* cmax, void* nact, void* clist,
                               void* bt0, void* rays, void* prev,
                               void* scratch, int rays_in, int o_stride,
                               int ray_block, int clusters, void* stream) {
  if (rays_in <= 0) return cudaSuccess;
  const bool global_keys = clusters > kSharedClusters;
  if (ray_block <= 0 || clusters <= 0 || (global_keys && scratch == nullptr))
    return cudaErrorInvalidValue;
  int keys = 1;
  while (keys < clusters) keys <<= 1;
  const Params q{static_cast<const float*>(o),
                 static_cast<const float*>(d),
                 static_cast<const float*>(t_init),
                 static_cast<const float*>(cmin),
                 static_cast<const float*>(cmax),
                 static_cast<int*>(nact),
                 static_cast<int*>(clist),
                 static_cast<float*>(bt0),
                 static_cast<float*>(rays),
                 static_cast<float*>(prev),
                 static_cast<unsigned long long*>(scratch),
                 rays_in,
                 o_stride,
                 ray_block,
                 clusters,
                 keys};
  const int blocks = (rays_in + ray_block - 1) / ray_block;
  const int threads = min(kMaxThreads, (ray_block + 31) / 32 * 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t boxes = sizeof(float4) * 2 * kTile;
  if (global_keys) {
    cluster_cull<true><<<blocks, threads, boxes, s>>>(q);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = boxes + sizeof(unsigned long long) * keys;
  if (smem > kStaticSmem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        cluster_cull<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cluster_cull<false><<<blocks, threads, smem, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
