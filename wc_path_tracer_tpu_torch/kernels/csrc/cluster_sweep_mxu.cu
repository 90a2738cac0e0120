// Plane-form cluster-sweep closest hit for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wc_path_tracer_tpu/kernels/cluster.py
// ::_make_sweep_kernel_mxu (Pallas, launched by _sweep_chunk under
// cluster_sweep(variant="mxu")).  Same inputs, same payload, same visit
// order, tie rule and early exit; the plain PyTorch twin is
// wc_path_tracer_tpu_torch/kernels/cluster.py::cluster_sweep_mxu_plain, and
// the two agree bit for bit (payload and visits).
//
// The function.  Per (ray, slot) the twin forms six dot products of
// X = [o, d, 1, 0] with the slot's columns of the cluster's (8, 768) slab,
// Q = n.d, P = n.o + d0, Bu = au.d, Au = au.o + bu, Bv = av.d,
// Av = av.o + bv (kernels/cluster.py::mxu_tables_from_coords), summed term
// by term from k = 0 to 7, then t = -P * (1 / Q), u = Au + t Bu,
// v = Av + t Bv, a hit where t > 0, u >= 0, v >= 0, u + v <= 1, kept under
// strict `<`.  The payload row of a winner is [t, 0 x 9, material, slot id,
// 0 x 4]: the re-shade fetches vertices by slot id.
//
// Bound: operations.  The function needs 46 FP32 ops per ray x slot (Q, Bu,
// Bv 3 multiplies + 2 adds each; P, Au, Av 3 + 3 each with the constant
// term; t 3; u, v 2 each; u + v 1; 5 compares) against 67 TFLOP/s FP32
// (H100 SXM, 700 W), of which -fmad=false leaves half within reach (an FMA
// counts two ops there, and this build runs every multiply and add as an
// instruction of its own).  The slabs (24 KiB per cluster) stay in L2.
//
// Design: the block sweep of sweep_skeleton.cuh (heaviest ray blocks first,
// a thread block cluster of CTAs per ray block with lane groups per ray,
// one distributed-shared-memory exit vote per visit, double-buffered slabs,
// any ray block), with this slot test:
//  - Only the needed operations.  Of a slot's 48 slab entries 12 are
//    distinct and not structurally zero: n, d0, au, bu, av, bv.  The
//    stagers gather them into three float4 -- (n, d0) from Q's rows 3-5 and
//    P's row 6, (au, bu) from Bu's rows 3-5 and Au's row 6, (av, bv) from
//    Bv's rows 3-5 and Av's row 6 -- so a test reads three broadcast
//    LDS.128 instead of 48 scalar loads, and 6 KiB per cluster is staged
//    instead of 24 KiB.  Each field is then summed over its non-zero terms
//    in the twin's order: Q = (d0 n0 + d1 n1) + d2 n2,
//    P = ((o0 n0 + o1 n1) + o2 n2) + d0, and so for Bu, Au, Bv, Av.
//  - Why that is bitwise the twin.  The twin's other terms are products
//    with a structural zero (x * 0 = +-0 for finite x) and 1 * d0 = d0.
//    Adding an exact +-0 to a non-zero partial sum returns that sum
//    exactly, so each field equals the twin's except possibly in the sign
//    of an exact zero.  A zero P gives t = +-0, which fails t > 0.  A zero
//    Q gives t = +-inf or NaN: +inf is never < t_best (at most +inf), and
//    -inf and NaN fail t > 0, so that slot misses under either sign.  A +-0
//    in Bu, Au, Bv or Av changes no comparison (u, v and u + v are compared
//    with >= 0 and <= 1, which do not see the sign of zero).  A ray whose o
//    is not finite makes the twin's Q NaN (inf * 0); here P is then inf or
//    NaN and t is never both > 0 and < t_best.  So hits, t, slot ids,
//    visits and the payload are the twin's.  The wrapper checks once per
//    table that the structural entries are zero and the duplicated n, au,
//    av equal their copies (kernels/cluster.py::check_mxu_form), so the
//    kernel never computes another function quietly.
//  - Exact warp rejection in two votes.  A slot can only win with t > 0 and
//    t < tc (the group's running best), and t needs only Q and P (11 ops
//    and a reciprocal): when no lane of the warp has both, Bu, Au, Bv, Av,
//    u and v are skipped.  A hit also needs 0 <= u <= 1 (u + v <= 1 with
//    v >= 0 cannot hold for u > 1): when no lane also has that, Bv, Av and v
//    are skipped.  1 / Q is __frcp_rn, the IEEE reciprocal rounded to
//    nearest, as the twin's 1.0 / Q.
//
// ptxas (printed by chip_smoke.py's build step) gives registers, spills and
// shared memory (2 x 128 slots x 48 B + the votes) per build.  Times, the
// layouts measured against each other and the vote shares are in PERF.md.

#include "sweep_skeleton.cuh"

namespace {

constexpr int kRows = 8;                                 // o (3), d (3), 1, pad
constexpr int kFields = 6;                               // Q, P, Bu, Au, Bv, Av
constexpr int kCols = kFields * sweep::kClusterTris;     // 768 slab columns

struct PlaneTest {
  static constexpr int kFetch = 12;  // n, d0, au, bu, av, bv
  static constexpr bool kCounts = true;

  // Field f of slot l is column f * 128 + l of the cluster's slab; the
  // d-fields Q, Bu, Bv hold n, au, av in rows 3-5, the o-fields P, Au, Av
  // their constants d0, bu, bv in row 6.
  static __device__ void fetch(const float* __restrict__ trisW, int c, int l,
                               float (&pf)[kFetch]) {
    const float* w = trisW + static_cast<size_t>(c) * kRows * kCols + l;
#pragma unroll
    for (int f = 0; f < kFields; f += 2) {
      const float* d_field = w + f * sweep::kClusterTris;
      pf[2 * f + 0] = d_field[3 * kCols];
      pf[2 * f + 1] = d_field[4 * kCols];
      pf[2 * f + 2] = d_field[5 * kCols];
      pf[2 * f + 3] = d_field[6 * kCols + sweep::kClusterTris];
    }
  }

  static __device__ sweep::Slot stage(const float (&pf)[kFetch]) {
    return sweep::Slot{make_float4(pf[0], pf[1], pf[2], pf[3]),
                       make_float4(pf[4], pf[5], pf[6], pf[7]),
                       make_float4(pf[8], pf[9], pf[10], pf[11])};
  }

  template <bool kCount>
  static __device__ void test(const sweep::Slot& s, int l, const sweep::Ray& r,
                              float& tc, int& lc, sweep::Counts& n) {
    if (kCount) ++n.tested;
    const float4 nd = s.x;
    const float q = (r.dx * nd.x + r.dy * nd.y) + r.dz * nd.z;
    const float p = ((r.ox * nd.x + r.oy * nd.y) + r.oz * nd.z) + nd.w;
    const float t = -p * __frcp_rn(q);
    const bool t_in = (t > 0.0f) & (t < tc);
    if (!__any_sync(sweep::kFullWarp, t_in)) return;  // no lane can win
    if (kCount) ++n.vote1;
    const float4 uu = s.y;
    const float bu = (r.dx * uu.x + r.dy * uu.y) + r.dz * uu.z;
    const float au = ((r.ox * uu.x + r.oy * uu.y) + r.oz * uu.z) + uu.w;
    const float u = au + t * bu;
    const bool u_in = t_in & (u >= 0.0f) & (u <= 1.0f);
    if (!__any_sync(sweep::kFullWarp, u_in)) return;
    if (kCount) ++n.vote2;
    const float4 vv = s.z;
    const float bv = (r.dx * vv.x + r.dy * vv.y) + r.dz * vv.z;
    const float av = ((r.ox * vv.x + r.oy * vv.y) + r.oz * vv.z) + vv.w;
    const float v = av + t * bv;
    if (u_in && v >= 0.0f && u + v <= 1.0f) {
      tc = t;
      lc = l;
    }
  }

  // [t, 0 x 9, material, slot id, 0 x 4]
  static __device__ void winner(const float*, const float* __restrict__ mat_tbl,
                                int win, float t, float* o) {
    o[0] = t;
    for (int c = 1; c < 10; ++c) o[c] = 0.0f;
    o[10] = mat_tbl[win];
    o[11] = static_cast<float>(win);
    for (int c = 12; c < sweep::kPayloadCols; ++c) o[c] = 0.0f;
  }
};

}  // namespace

// Launch on `stream` (a cudaStream_t) as num_blocks thread block clusters of
// `ctas` CTAs each, `groups` (1, 2, 4 or 8) threads per ray, `passes` passes
// per visit (more than 1 needs `state`, (blocks * ray_block) int2).
// `counts` (3 uint64, or null; one pass only) receives the (warp, slot
// step) pairs tested and those that passed the t vote and the u vote.
// Returns the launch's error code (0 on success), so a refused launch is
// reported to the caller.
extern "C" int wc_cluster_sweep_mxu(const void* nact, const void* clist,
                                    const void* bt0, const void* order,
                                    const void* rays, const void* prev,
                                    const void* trisW, const void* mat_tbl,
                                    void* out, void* visits, void* state,
                                    void* counts, int num_blocks,
                                    int ray_block, int num_clusters, int ctas,
                                    int groups, int passes, void* stream) {
  return sweep::launch<PlaneTest>(nact, clist, bt0, order, rays, prev, trisW,
                                  mat_tbl, out, visits, state, counts,
                                  num_blocks, ray_block, num_clusters, ctas,
                                  groups, passes, stream);
}

extern "C" const char* wc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
