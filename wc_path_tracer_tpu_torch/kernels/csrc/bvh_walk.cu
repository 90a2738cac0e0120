// BVH walk closest hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wc_path_tracer_tpu/kernels/traversal.py
// ::_traversal_kernel (Pallas, launched by packet_bvh_intersect and, per
// SMEM-sized chunk, by packet_bvh_intersect_chunked).  Same contract: per
// ray the closest triangle hit over every draw's BVH, pruned by t_init, as
// (t, first-index offset into mesh.indices or -1).  The plain PyTorch twin
// is wc_path_tracer_tpu_torch/kernels/traversal.py::bvh_walk_plain; kernel
// and twin agree bit for bit in (t, off) and in the per-ray counters.
//
// Order (the reference shader's per-thread walk, pathTracer.comp:151-201,
// not the TPU's 1024-ray packet with one shared stack): draws in order with
// t carried across them; a node is entered iff t0 <= t1 && t1 >= 0 &&
// t0 <= t_best (slab test in ops/intersect.py::ray_box's order, NaN
// propagating through min/max as in torch.minimum, so a 0 * inf lane never
// enters); near child first by t0 > 0 ? t0 : t1; leaf triangles in
// ops/intersect.py::ray_triangle's order with a strict `<` update.  Built
// with -fmad=false so every product and sum is rounded separately, as in
// the twin.
//
// What bounds it.  Not the bytes or the operations (the bound, 0.0033 ms
// on a 512^2 bunny frame's queries, is the bytes of the rays and tables):
// each ray is a chain of dependent steps -- load a node, test, choose, load
// the next -- of very different lengths (up to ~110 inner nodes entered on
// that cell, ~10x the mean), and a warp's lanes diverge in control and in
// addresses.  Measured on an H100 (PERF.md): one warp walking one ray in
// all 32 lanes takes 0.38-0.47 of the time of 32 different rays, and an
// order that evens a warp's work but breaks the pixel order's coherence is
// 1.4-1.8 times slower.  The first port spent ~470 scattered scalar
// loads and local-stack accesses per primary ray: every box fetched and
// tested twice (at its parent, to pick the near child, and at its own pop),
// 6 scalar loads per box plus the node's left/count, two rounds of loads
// per triangle (indices, then vertices).
//
// What this design does about it (traversal.walk_tables packs the bank
// once, from bitwise copies of its boxes and vertices):
// - Child-pair node records, 64 B = 4 float4 per inner node: both
//   children's boxes, references as the walk carries them (record id, or
//   -2 - the first index of a leaf) and index counts.  An entered inner
//   node costs 4 independent 16-byte ld.global.nc loads (the counts are not
//   read); a leaf child needs no fetch of its own.
// - Carried entry distances: both children are tested once, from the
//   parent's record; a child is pushed as (ref, t0) only if its interval is
//   non-empty and not behind the ray, and a pop re-checks only
//   t0 <= t_best: the twin's enter test, on the same floats.  A child not
//   pushed still counts as popped, so the counters equal the twin's.  The
//   near child is held in registers (the twin pushes it last and pops it
//   next), so the stack holds only far children: at most depth - 1.
// - Triangle records, 48 B = 3 float4 per slot (a, b, c, rebased by the
//   draw's vertex offset; the first pad word holds how many triangles of
//   the leaf remain), addressed by first index / 3: one round of 3 loads.
// - NaN-propagating min/max in one instruction each (min.NaN, max.NaN),
//   and the draw records in shared memory, so a step is ~75 instructions.
// - While-while order (Aila & Laine, HPG 2009): a thread descends inner
//   nodes until it holds a leaf or nothing, and only then tests triangles.
//   Nothing is speculative: each ray's order is the twin's.
// - Persistent warps (as many CTAs as fit on the SMs) take 32 lanes at a
//   time from a global counter with atomicAdd, in the rays' given order,
//   and refill a lane whose ray is done once kRefillIdle lanes of the warp
//   are idle (Aila & Laine's dynamic fetch); the stack lives in local
//   memory, which leaves L1 to the records.  Chosen on the card (PERF.md)
//   over one thread per ray in blockIdx order, warps walking 32-ray
//   batches to their ends, the stack in shared memory, the top levels of
//   records staged in shared memory and the rays sorted by a Morton key.
// - Live lanes only: with the transport's alive mask, a persistent warp
//   queues the live lanes it takes in shared memory (ballot and popc) and
//   walks only them; a dead lane gets (t_init, -1) and zero counters from
//   the warp that took it.  No host sync, no pass before the launch.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;     // threads per CTA (4 warps)
constexpr int kLocalStack = 64;   // traversal.STACK_DEPTH
constexpr int kCountCols = 3;     // nodes popped, inner entered, tris tested
constexpr int kNone = -1;         // carried child: >= 0 record, <= -2 leaf
constexpr int kSharedDraws = 32;  // draw records each CTA keeps in shared
constexpr int kRefillIdle = 8;    // refill once this many lanes of a warp idle

struct Params {
  const float* origin;     // (R, 3)
  const float* direction;  // (R, 3)
  const float* t_init;     // (R,)
  const float4* nodes;     // (NR, 4) child-pair records
  const float4* tris;      // (T, 3) triangle records
  const float4* draws;     // (D, 2) per-draw root records
  const bool* alive;       // (R,) rays to walk, or null (every ray)
  int* counter;            // lanes taken so far (zeroed)
  float* t_out;            // (R,)
  int* off_out;            // (R,)
  int* counts;             // (R, 3) or null
  int num_rays, num_draws;
};

// torch.minimum / torch.maximum: NaN if either operand is NaN, in one
// instruction (min.NaN / max.NaN, sm_80 and later)
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

struct Box {
  float t0, t1;
};

// ops/intersect.py::ray_box: t0 = max over axes of min(top, bot),
// t1 = min over axes of max(top, bot)
__device__ __forceinline__ Box slab(float lx, float ly, float lz, float hx,
                                    float hy, float hz, float ox, float oy,
                                    float oz, float ix, float iy, float iz) {
  const float bx = (lx - ox) * ix, tx = (hx - ox) * ix;
  const float by = (ly - oy) * iy, ty = (hy - oy) * iy;
  const float bz = (lz - oz) * iz, tz = (hz - oz) * iz;
  Box b;
  b.t0 = nan_max(nan_max(nan_min(tx, bx), nan_min(ty, by)), nan_min(tz, bz));
  b.t1 = nan_min(nan_min(nan_max(tx, bx), nan_max(ty, by)), nan_max(tz, bz));
  return b;
}

__device__ __forceinline__ bool nonempty_ahead(Box b) {
  return (b.t0 <= b.t1) & (b.t1 >= 0.0f);
}

// this thread's (ref, t0) stack
struct LocalStack {
  int2 e[kLocalStack];
  __device__ __forceinline__ void put(int i, int2 v) { e[i] = v; }
  __device__ __forceinline__ int2 get(int i) const { return e[i]; }
};

// One lane's walk of one ray, as state, so the warp can interleave the
// steps of different rays on its lanes without changing any ray's order:
// begin(), then next_draw() until it is false, each draw stepped by inner()
// and leaf() until cur is kNone, then finish().
template <bool kCount>
struct Walker {
  const Params& p;
  LocalStack& st;
  const float4* s_draws;    // the first kSharedDraws draw records
  int r, best, popped, entered, tested;
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t_best;
  int di, cur, sp;

  __device__ __forceinline__ void begin(int ray) {
    r = ray;
    ox = p.origin[3 * r];
    oy = p.origin[3 * r + 1];
    oz = p.origin[3 * r + 2];
    dx = p.direction[3 * r];
    dy = p.direction[3 * r + 1];
    dz = p.direction[3 * r + 2];
    ix = 1.0f / dx;
    iy = 1.0f / dy;
    iz = 1.0f / dz;
    t_best = p.t_init[r];
    best = -1;
    popped = entered = tested = 0;
    di = -1;
    cur = kNone;
  }

  // Pop the draws' roots in order until one is entered (cur >= 0 or a
  // leaf); false when no draw is left.
  __device__ __forceinline__ bool next_draw() {
    while (++di < p.num_draws) {
      float4 d0, d1;
      if (di < kSharedDraws) {
        d0 = s_draws[2 * di];
        d1 = s_draws[2 * di + 1];
      } else {
        d0 = __ldg(p.draws + 2 * di);
        d1 = __ldg(p.draws + 2 * di + 1);
      }
      ++popped;
      sp = 0;
      const Box b = slab(d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, ox, oy, oz, ix,
                         iy, iz);
      if (nonempty_ahead(b) && b.t0 <= t_best) {
        cur = __float_as_int(d1.z);
        return true;
      }
    }
    return false;
  }

  // the next stacked child still entered at the current t_best
  __device__ __forceinline__ int pop() {
    while (sp > 0) {
      const int2 e = st.get(--sp);
      if (__int_as_float(e.y) <= t_best) return e.x;
    }
    return kNone;
  }

  // Entered inner nodes, each from its one record, until cur is a leaf or
  // kNone.
  __device__ __forceinline__ void inner() {
    while (cur >= 0) {
      ++entered;
      popped += 2;
      const float4* q = p.nodes + 4 * static_cast<size_t>(cur);
      const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2),
                   q3 = __ldg(q + 3);
      const Box lb = slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ox, oy, oz, ix,
                          iy, iz);
      const Box rb = slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, ox, oy, oz, ix,
                          iy, iz);
      // both children as the walk carries them (record id, or -2 - the
      // first index of a leaf), packed so
      const int lc = __float_as_int(q3.x), rc = __float_as_int(q3.y);
      const float ldist = lb.t0 > 0.0f ? lb.t0 : lb.t1;
      const float rdist = rb.t0 > 0.0f ? rb.t0 : rb.t1;
      const bool near_left = ldist < rdist;
      const int near = near_left ? lc : rc, far = near_left ? rc : lc;
      const Box nb = near_left ? lb : rb, fb = near_left ? rb : lb;
      // the twin pushes far then near and pops near next: near is entered
      // at the t_best of now, far waits on the stack
      if (nonempty_ahead(nb) && nb.t0 <= t_best) {
        if (nonempty_ahead(fb) && sp < kLocalStack)  // always: depth checked
          st.put(sp++, make_int2(far, __float_as_int(fb.t0)));
        cur = near;
      } else if (nonempty_ahead(fb) && fb.t0 <= t_best) {
        cur = far;
      } else {
        cur = pop();
      }
    }
  }

  // The leaf cur: its triangles from the triangle records, in order; then
  // the next stacked child.
  __device__ __forceinline__ void leaf() {
    const int i0 = -2 - cur;
    const float4* tr = p.tris + 3 * static_cast<size_t>(i0 / 3);
    int n = 1;
    for (int k = 0; k < n; ++k) {
      const float4 a = __ldg(tr + 3 * k);
      const float4 b = __ldg(tr + 3 * k + 1);
      const float4 c = __ldg(tr + 3 * k + 2);
      if (k == 0) n = __float_as_int(a.w);
      ++tested;
      const float e1x = b.x - a.x, e1y = b.y - a.y, e1z = b.z - a.z;
      const float e2x = c.x - a.x, e2y = c.y - a.y, e2z = c.z - a.z;
      const float oax = ox - a.x, oay = oy - a.y, oaz = oz - a.z;
      // Moller-Trumbore, in ops/intersect.py::ray_triangle's order
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float inv_det = 1.0f / (e1x * px + e1y * py + e1z * pz);
      const float qx = oay * e1z - oaz * e1y;
      const float qy = oaz * e1x - oax * e1z;
      const float qz = oax * e1y - oay * e1x;
      const float u = (oax * px + oay * py + oaz * pz) * inv_det;
      const float v =
          dx * (qx * inv_det) + dy * (qy * inv_det) + dz * (qz * inv_det);
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const bool hit = (t > 0.0f) & (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) &
                       (u + v <= 1.0f);
      if (hit && t < t_best) {
        t_best = t;
        best = i0 + 3 * k;
      }
    }
    cur = pop();
  }

  __device__ __forceinline__ void finish() {
    p.t_out[r] = t_best;
    p.off_out[r] = best;
    if (kCount) {
      p.counts[kCountCols * r] = popped;
      p.counts[kCountCols * r + 1] = entered;
      p.counts[kCountCols * r + 2] = tested;
    }
  }
};

// A ray the caller marked dead gets (t_init, -1) and zero counters.
template <bool kCount>
__device__ __forceinline__ void dead_ray(const Params& p, int r) {
  p.t_out[r] = p.t_init[r];
  p.off_out[r] = -1;
  if (kCount) {
    p.counts[kCountCols * r] = 0;
    p.counts[kCountCols * r + 1] = 0;
    p.counts[kCountCols * r + 2] = 0;
  }
}

// Take 32 lanes from the global counter, write the dead ones' results, and
// queue the live ones (ballot + popc) in the warp's shared-memory queue
// until it holds `want` rays or the lanes run out.
template <bool kCount>
__device__ __forceinline__ void fill_queue(const Params& p, int* queue,
                                           int& queued, bool& drained,
                                           int want) {
  const int lane = threadIdx.x & 31;
  while (queued < want && !drained) {
    int base = 0;
    if (lane == 0) base = atomicAdd(p.counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= p.num_rays) {
      drained = true;
      break;
    }
    const int r = base + lane < p.num_rays ? base + lane : -1;
    const bool live = r >= 0 && (p.alive == nullptr || p.alive[r]);
    if (r >= 0 && !live) dead_ray<kCount>(p, r);
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) queue[queued + __popc(mask & ((1u << lane) - 1u))] = r;
    queued += __popc(mask);
    __syncwarp();
  }
}

// Hand the first `take` queued rays to the lanes of `to` (in lane order)
// and shift the rest down -> this lane's ray or -1.
__device__ __forceinline__ int take_queue(int* queue, int& queued,
                                          unsigned to, int take) {
  const int lane = threadIdx.x & 31;
  const int rank = __popc(to & ((1u << lane) - 1u));
  const int r = ((to >> lane) & 1u) && rank < take ? queue[rank] : -1;
  const int rest = lane + take < queued ? queue[lane + take] : -1;
  __syncwarp();
  if (rest >= 0) queue[lane] = rest;
  __syncwarp();
  queued -= take;
  return r;
}

// A lane whose ray is done takes the next queued ray once kRefillIdle lanes
// of its warp are idle (Aila & Laine's dynamic fetch), so a long ray no
// longer holds 31 idle lanes.  Each loop runs one while-while round per
// busy lane: inner nodes until a leaf, the leaf, and at a draw's end the
// next draw's root.  Dead lanes take no walk slot.
template <bool kCount>
__global__ void __launch_bounds__(kThreads) bvh_walk_kernel(const Params p) {
  __shared__ float4 s_draws[2 * kSharedDraws];
  __shared__ int s_queue[kThreads / 32][64];
  for (int i = threadIdx.x; i < 2 * min(p.num_draws, kSharedDraws);
       i += kThreads)
    s_draws[i] = __ldg(p.draws + i);
  __syncthreads();
  LocalStack st;
  Walker<kCount> w{p, st, s_draws};
  int* queue = s_queue[threadIdx.x >> 5];
  int queued = 0;  // warp-uniform
  bool drained = false, busy = false;
  while (true) {
    const unsigned idle = __ballot_sync(0xffffffffu, !busy);
    if (idle == 0xffffffffu ||
        (__popc(idle) >= kRefillIdle && !(drained && queued == 0))) {
      fill_queue<kCount>(p, queue, queued, drained, __popc(idle));
      const int r = take_queue(queue, queued, idle,
                               min(queued, __popc(idle)));
      if (r >= 0) {
        w.begin(r);
        busy = w.next_draw();
        if (!busy) w.finish();
      }
      if (__ballot_sync(0xffffffffu, busy) == 0) {
        if (drained && queued == 0) break;
        continue;
      }
    }
    if (busy) {
      w.inner();
      if (w.cur != kNone) w.leaf();
      if (w.cur == kNone && !w.next_draw()) {
        w.finish();
        busy = false;
      }
    }
  }
}

// As many CTAs as fit on the card at once, at most one per 128 rays.
template <bool kCount>
int launch(const Params& p, cudaStream_t stream) {
  // per instantiation: the CTAs per SM on the last device asked
  static int device = -1, sms = 0, per_sm = 0;
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (dev != device) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bvh_walk_kernel<kCount>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    device = dev;
  }
  const int blocks = std::min((p.num_rays + kThreads - 1) / kThreads,
                              std::max(per_sm, 1) * sms);
  bvh_walk_kernel<kCount><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.  `counter` is one
// zeroed int; `alive` and `counts` may be null.
extern "C" int wc_bvh_walk(const void* origin, const void* direction,
                           const void* t_init, const void* nodes,
                           const void* tris, const void* draws,
                           const void* alive, void* counter, void* t_out,
                           void* off_out, void* counts, int num_rays,
                           int num_draws, void* stream) {
  if (num_rays <= 0) return cudaSuccess;
  if (counter == nullptr) return cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(origin),
                 static_cast<const float*>(direction),
                 static_cast<const float*>(t_init),
                 static_cast<const float4*>(nodes),
                 static_cast<const float4*>(tris),
                 static_cast<const float4*>(draws),
                 static_cast<const bool*>(alive),
                 static_cast<int*>(counter),
                 static_cast<float*>(t_out),
                 static_cast<int*>(off_out),
                 static_cast<int*>(counts),
                 num_rays,
                 num_draws};
  const auto s = static_cast<cudaStream_t>(stream);
  return counts != nullptr ? launch<true>(p, s) : launch<false>(p, s);
}

extern "C" const char* wc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
