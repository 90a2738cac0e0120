// Shading of one transport bounce segment for NVIDIA Hopper (sm_90a): T1.
//
// Replaces no TPU kernel.  The JAX package's transport is one jitted
// program, whose elementwise chains XLA fuses; in eager PyTorch every op of
// wc_path_tracer_tpu_torch/render/golden.py::_bounce after the closest-hit
// query is a launch of its own, about 470 per segment, and the host cannot
// issue them as fast as the card runs them.  This kernel does that work for
// every lane of one segment in one launch, on the no-grad path with NEE off
// (golden._fused_materials decides); _bounce stays its plain twin, and the
// two agree bit for bit in every field of the next PathState.
//
// Per lane, in _bounce's order: the sky term on a miss (black or gradient);
// the material row of _gather_material (the (M, 14) table of
// kernels/shade.py::pack_materials and the type id); emission; the
// dielectric's Fresnel and refraction; the masked PCG draws (1 for the
// dielectric unless under total internal reflection, 2 for GGX, the 6 of
// random_direction for every other type, then 1 for Russian roulette), so
// every lane's stream advances as in the plain path; the four lobes
// (metal, dielectric with Beer absorption, Lambertian, GGX); throughput,
// the GGX kill and Russian roulette; the next origin and direction.
//
// Bit for bit with PyTorch's op-by-op arithmetic: built with -fmad=false,
// so no product and sum fuse where PyTorch ran two launches; the terms of
// every dot and cross product in ops/intersect.py's order; sqrtf, logf,
// cosf, sinf, expf and IEEE division, as PyTorch's kernels call them; every
// Python scalar as the float32 that PyTorch rounds it to (hex literals
// below); torch.maximum / minimum / clamp's NaN propagation (tmax, tmin,
// tclamp), where fmaxf alone would drop a NaN; `1.0 / x` as PyTorch's
// reciprocal(x) * 1.0; the PCG in uint32, the int64-masked twin's values.
//
// What bounds it: bytes.  A lane reads its state and hit record (91 B) and
// writes its next state (57 B), about 150 B, a 1024^2 segment ~0.05 ms of
// HBM at 3.35 TB/s; the operations (a few hundred, four transcendentals and
// a dozen divisions) take less.  One thread per lane, no shared memory: the
// material table is a few hundred bytes and stays in L1.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 14;  // pack_materials' columns

// float32 values of the transport's Python scalars, rounded as PyTorch
// rounds them (np.float32 of the double)
constexpr float kBias = 0x1.4f8b58p-17f;      // golden.BIAS, 1e-5
constexpr float kTwoPi = 0x1.921fb6p+2f;      // f32(2) * f32(pi)
constexpr float kInv2Pow32 = 0x1p-32f;        // rng._INV_2_32
constexpr float kNormGuard = 0x1p-126f;       // ix.normalize's eps=1e-20 guard
constexpr float k1em4 = 0x1.a36e2ep-14f;
constexpr float k1em6 = 0x1.0c6f7ap-20f;
constexpr float k1em8 = 0x1.5798eep-27f;
constexpr float k1em12 = 0x1.197998p-40f;
constexpr float k0p04 = 0x1.47ae14p-5f;
constexpr float k0p05 = 0x1.99999ap-5f;
constexpr float k0p7 = 0x1.666666p-1f;
constexpr float kU1Max = 0x1.fffffcp-1f;      // f32(1 - 1e-7)

constexpr int kMetal = 0, kDielectric = 1, kLambertian = 2, kGgx = 3;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ a, size_t i) {
  return V3{a[3 * i], a[3 * i + 1], a[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* __restrict__ a, size_t i, V3 v) {
  a[3 * i] = v.x;
  a[3 * i + 1] = v.y;
  a[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// ops/intersect.py::dot3, left to right
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// torch.maximum / torch.minimum: a NaN in either argument is the result
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp and torch.clamp_min: a NaN passes through
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tclamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// torch.amax's reduction step: NaN wins, else the larger
__device__ __forceinline__ float amax_step(float a, float b) {
  return (a != a || a > b) ? a : b;
}
// ops/intersect.py::safe_sqrt
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}
// torch.sign: 0 for zeros and NaN
__device__ __forceinline__ float tsign(float a) {
  return static_cast<float>((0.0f < a) - (a < 0.0f));
}
// torch `1.0 / x`: Tensor.__rtruediv__ is reciprocal(x) * 1.0
__device__ __forceinline__ float rdiv(float num, float x) {
  return (1.0f / x) * num;
}

// ix.normalize(v, eps=1e-20)
__device__ __forceinline__ V3 normalize(V3 v) {
  const float s = sqrtf(tmax(dot3(v, v), kNormGuard));
  return V3{v.x / s, v.y / s, v.z / s};
}

// `a + k * b` per component, k a per-lane scalar: (R, 1) * (R, 3), then add
__device__ __forceinline__ V3 add_scaled(V3 a, float k, V3 b) {
  return V3{a.x + k * b.x, a.y + k * b.y, a.z + k * b.z};
}

// ops/rng.py: the PCG output permutation, on the uint32 state
__device__ __forceinline__ uint32_t pcg_permute(uint32_t s) {
  const uint32_t w = ((s >> ((s >> 28) + 4u)) ^ s) * 277803737u;
  return (w >> 22) ^ w;
}

// rng.rand_masked: the draw from the current state; the state advances
// only where `mask`
__device__ __forceinline__ float draw(uint32_t& state, bool mask) {
  const uint32_t x = pcg_permute(state);
  if (mask) state = x;
  return static_cast<float>(x) * kInv2Pow32;
}

// rng.random_normal: Box-Muller from 2 masked draws
__device__ __forceinline__ float random_normal(uint32_t& state, bool mask) {
  const float u1 = draw(state, mask);
  const float u2 = draw(state, mask);
  const float theta = u1 * kTwoPi;
  const float rho = sqrtf(logf(u2) * -2.0f);
  return rho * cosf(theta);
}

// golden._fresnel_reflectance
__device__ __forceinline__ float fresnel(V3 d, V3 n, float ior_a,
                                         float ior_b) {
  const float ratio = ior_a / ior_b;
  const float cos_in = -dot3(d, n);
  const float sin_sqr = ratio * ratio * (1.0f - cos_in * cos_in);
  const bool tir = sin_sqr >= 1.0f;
  const float cos_refr = safe_sqrt(1.0f - sin_sqr);
  const float denom_perp = ior_a * cos_in + ior_b * cos_refr;
  const float denom_par = ior_b * cos_in + ior_a * cos_refr;
  const bool degenerate = tmin(denom_perp, denom_par) < k1em8;
  const float safe_perp = fabsf(denom_perp) < k1em8 ? 1.0f : denom_perp;
  const float safe_par = fabsf(denom_par) < k1em8 ? 1.0f : denom_par;
  float r_perp = (ior_a * cos_in - ior_b * cos_refr) / safe_perp;
  r_perp = r_perp * r_perp;
  float r_par = (ior_b * cos_in - ior_a * cos_refr) / safe_par;
  r_par = r_par * r_par;
  const float refl = (r_perp + r_par) * 0.5f;
  return (tir || degenerate) ? 1.0f : refl;
}

// ops/bsdf.py::smith_g1
__device__ __forceinline__ float smith_g1(float cos_v, float rough) {
  const float alpha = tmax(rough * rough, k1em4);
  const float c = tmin(tmax(cos_v, k1em6), 1.0f);
  const float tan2 = (1.0f - c * c) / (c * c);
  return rdiv(2.0f, 1.0f + sqrtf(1.0f + alpha * alpha * tan2));
}

// ops/bsdf.py::ggx_sample, then ix.normalize of its direction -> (wi,
// weight, valid)
__device__ __forceinline__ void ggx_sample(V3 n, V3 wo, V3 albedo,
                                           float rough, float metallic,
                                           float u1, float u2, V3& wi_n,
                                           V3& weight, bool& valid) {
  // ggx_sample_half
  const float alpha = tmax(rough * rough, k1em4);
  const float u1c = tmin(tmax(u1, 0.0f), kU1Max);
  const float tan2 = alpha * alpha * u1c / (1.0f - u1c);
  const float cos_h = rdiv(1.0f, sqrtf(1.0f + tan2));
  const float sin_h = safe_sqrt(1.0f - cos_h * cos_h);
  const float phi = u2 * kTwoPi;
  // orthonormal_basis
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = rdiv(-1.0f, sign + n.z);
  const float bb = n.x * n.y * a;
  const V3 t{1.0f + sign * (n.x * n.x) * a, sign * bb, -sign * n.x};
  const V3 b{bb, sign + (n.y * n.y) * a, -n.y};
  const float st = sin_h * cosf(phi), sb = sin_h * sinf(phi);
  const V3 h{t.x * st + b.x * sb + n.x * cos_h,
             t.y * st + b.y * sb + n.y * cos_h,
             t.z * st + b.z * sb + n.z * cos_h};
  // ggx_sample
  const float cos_oh = dot3(wo, h);
  const float k = 2.0f * cos_oh;
  const V3 wi{k * h.x - wo.x, k * h.y - wo.y, k * h.z - wo.z};
  const float cos_o = dot3(wo, n);
  const float cos_i = dot3(wi, n);
  const float cos_hn = dot3(h, n);
  const float m0 = (1.0f - metallic) * k0p04;
  const V3 f0{m0 + albedo.x * metallic, m0 + albedo.y * metallic,
              m0 + albedo.z * metallic};
  // schlick_fresnel
  const float c = tmin(tmax(cos_oh, 0.0f), 1.0f);
  const float x = 1.0f - c;
  const float x5 = x * ((x * x) * (x * x));
  const V3 F{f0.x + (1.0f - f0.x) * x5, f0.y + (1.0f - f0.y) * x5,
             f0.z + (1.0f - f0.z) * x5};
  const float G = smith_g1(cos_o, rough) * smith_g1(cos_i, rough);
  const float denom = tmax(cos_o * cos_hn, k1em6);
  const float w = G * tmax(cos_oh, 0.0f) / denom;
  valid = (cos_i > 0.0f) && (cos_o > 0.0f) && (cos_oh > 0.0f);
  weight = valid ? V3{F.x * w, F.y * w, F.z * w} : V3{0.0f, 0.0f, 0.0f};
  wi_n = normalize(wi);
}

struct Params {
  const float* o;  // (R, 3), row stride o_stride (0: one origin for all)
  const float* d;
  const float* total;
  const float* trans;
  const int64_t* seed;  // PCG state in [0, 2^32)
  const bool* alive;
  const float* t;       // the HitRecord
  const float* p;
  const float* normal;
  const bool* hit;
  const bool* front;
  const int* material;
  const float* table;   // (M, kCols)
  const int* mtype;     // (M,)
  float* o_out;
  float* d_out;
  float* total_out;
  float* trans_out;
  int64_t* seed_out;
  bool* alive_out;
  int lanes;
  int o_stride;
  bool sky_gradient;
  bool rr;  // Russian roulette in this segment
};

__global__ void __launch_bounds__(kThreads) shade_segment(const Params q) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<size_t>(q.lanes)) return;
  const float* op = q.o + i * q.o_stride;
  const V3 o{op[0], op[1], op[2]};
  const V3 d = load3(q.d, i);
  V3 total = load3(q.total, i);
  V3 trans = load3(q.trans, i);
  uint32_t state = static_cast<uint32_t>(q.seed[i]);
  const bool alive = q.alive[i];
  const bool hit = alive && q.hit[i];

  // miss -> sky * throughput (golden.sky_color)
  const bool miss = alive && !hit;
  V3 sky{0.0f, 0.0f, 0.0f};
  if (q.sky_gradient) {
    const float a = (d.y + 1.0f) * 0.5f;
    const float b = 1.0f - a;
    sky = V3{0.5f * b + a, k0p7 * b + a, 1.0f * b + a};
  }
  total.x = total.x + (miss ? sky.x * trans.x : 0.0f);
  total.y = total.y + (miss ? sky.y * trans.y : 0.0f);
  total.z = total.z + (miss ? sky.z * trans.z : 0.0f);

  if (!hit) {  // nothing more changes but the emission term's + 0
    store3(q.total_out, i,
           V3{total.x + 0.0f, total.y + 0.0f, total.z + 0.0f});
    store3(q.o_out, i, o);
    store3(q.d_out, i, d);
    store3(q.trans_out, i, trans);
    q.seed_out[i] = state;
    q.alive_out[i] = false;
    return;
  }

  // the material (golden._gather_material)
  const int mid = q.material[i];
  const float* row = q.table + static_cast<size_t>(mid) * kCols;
  const V3 albedo{row[0], row[1], row[2]};
  const V3 emission{row[3], row[4], row[5]};
  const float strength = row[6], rough = row[7], metallic = row[8];
  const V3 absorption{row[9], row[10], row[11]};
  const float absorption_strength = row[12], ior = row[13];
  const int mt = q.mtype[mid];
  const bool is_dielectric = mt == kDielectric, is_metal = mt == kMetal;
  const bool is_lambert = mt == kLambertian, is_ggx = mt == kGgx;

  // emission (NEE off: in full)
  total.x = total.x + emission.x * strength * trans.x;
  total.y = total.y + emission.y * strength * trans.y;
  total.z = total.z + emission.z * strength * trans.z;

  const float t = q.t[i];
  const V3 p = load3(q.p, i);
  const V3 n = load3(q.normal, i);
  const bool front = q.front[i];

  // dielectric pre-draw
  const float eta_i = front ? 1.0f : ior;
  const float eta_t = front ? ior : 1.0f;
  const float reflect_prob = fresnel(d, n, eta_i, eta_t);
  // ix.refract(d, n, eta_i / eta_t)
  const float eta = eta_i / eta_t;
  const float cos_i = dot3(n, d);
  const float kr = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  const bool tir = kr < 0.0f;
  const float sr = eta * cos_i + safe_sqrt(kr);
  const V3 refr = tir ? V3{0.0f, 0.0f, 0.0f}
                      : V3{eta * d.x - sr * n.x, eta * d.y - sr * n.y,
                           eta * d.z - sr * n.z};
  const float u_refl = draw(state, is_dielectric && !tir);

  // GGX's 2 draws, then random_direction's 6
  const float u_g1 = draw(state, is_ggx);
  const float u_g2 = draw(state, is_ggx);
  const float rx = random_normal(state, !is_ggx);
  const float ry = random_normal(state, !is_ggx);
  const float rz = random_normal(state, !is_ggx);
  const float rnorm = sqrtf(rx * rx + ry * ry + rz * rz);
  const V3 rdir{rx / rnorm, ry / rnorm, rz / rnorm};

  // ix.reflect
  const float dn2 = 2.0f * dot3(d, n);
  const V3 refl{d.x - dn2 * n.x, d.y - dn2 * n.y, d.z - dn2 * n.z};
  const V3 o_surf{p.x + n.x * kBias, p.y + n.y * kBias, p.z + n.z * kBias};

  // METAL
  const V3 d_metal = normalize(add_scaled(refl, rough, rdir));

  // DIELECTRIC
  const bool follow_reflect = tir || (u_refl <= reflect_prob);
  const V3 d_diel =
      normalize(add_scaled(sel(follow_reflect, refl, refr), rough, rdir));
  const bool absorb = !follow_reflect && !front;
  const float sg = tsign(dot3(d_diel, n));
  const V3 o_diel{p.x + n.x * kBias * sg, p.y + n.y * kBias * sg,
                  p.z + n.z * kBias * sg};

  // LAMBERTIAN
  const V3 dl{n.x + rdir.x, n.y + rdir.y, n.z + rdir.z};
  const float lam_len = sqrtf(tclamp_min(dot3(dl, dl), k1em12));
  const V3 d_lam = lam_len < k1em6
                       ? n
                       : V3{dl.x / lam_len, dl.y / lam_len, dl.z / lam_len};

  // GGX
  V3 d_ggx, w_ggx;
  bool ggx_valid;
  ggx_sample(n, V3{-d.x, -d.y, -d.z}, albedo, rough, metallic, u_g1, u_g2,
             d_ggx, w_ggx, ggx_valid);

  const V3 new_d = sel(is_dielectric, d_diel,
                       sel(is_lambert, d_lam, sel(is_ggx, d_ggx, d_metal)));
  const V3 new_o = is_dielectric ? o_diel : o_surf;
  V3 tput;
  if (is_metal || is_lambert) {
    tput = albedo;
  } else if (is_ggx) {
    tput = w_ggx;
  } else if (absorb) {
    const float na = -absorption.x, nb = -absorption.y, nc = -absorption.z;
    tput = V3{expf(na * absorption_strength * t),
              expf(nb * absorption_strength * t),
              expf(nc * absorption_strength * t)};
  } else {
    tput = V3{1.0f, 1.0f, 1.0f};
  }
  trans = V3{trans.x * tput.x, trans.y * tput.y, trans.z * tput.z};
  bool live = !is_ggx || ggx_valid;

  // Russian roulette: 1 masked draw per eligible lane
  if (q.rr) {
    const float p_survive =
        tclamp(amax_step(amax_step(trans.x, trans.y), trans.z), k0p05, 1.0f);
    const float u_rr = draw(state, live);
    const bool keep = live && !(u_rr > p_survive);
    live = keep;
    if (keep)
      trans = V3{trans.x / p_survive, trans.y / p_survive,
                 trans.z / p_survive};
  }

  store3(q.total_out, i, total);
  store3(q.trans_out, i, trans);
  store3(q.o_out, i, live ? new_o : o);
  store3(q.d_out, i, live ? new_d : d);
  q.seed_out[i] = state;
  q.alive_out[i] = live;
}

}  // namespace

// Launch on `stream` (a cudaStream_t), one thread per lane; returns the
// launch's error code (0 on success), so a refused launch is reported to
// the caller.  `o_stride` is the row stride of `o` in floats (3, or 0 for
// one origin shared by every lane).
extern "C" int wc_shade_segment(const void* o, const void* d,
                                const void* total, const void* trans,
                                const void* seed, const void* alive,
                                const void* t, const void* p,
                                const void* normal, const void* hit,
                                const void* front, const void* material,
                                const void* table, const void* mtype,
                                void* o_out, void* d_out, void* total_out,
                                void* trans_out, void* seed_out,
                                void* alive_out, int lanes, int o_stride,
                                int sky_gradient, int rr, void* stream) {
  if (lanes <= 0) return cudaSuccess;
  const Params q{static_cast<const float*>(o),
                 static_cast<const float*>(d),
                 static_cast<const float*>(total),
                 static_cast<const float*>(trans),
                 static_cast<const int64_t*>(seed),
                 static_cast<const bool*>(alive),
                 static_cast<const float*>(t),
                 static_cast<const float*>(p),
                 static_cast<const float*>(normal),
                 static_cast<const bool*>(hit),
                 static_cast<const bool*>(front),
                 static_cast<const int*>(material),
                 static_cast<const float*>(table),
                 static_cast<const int*>(mtype),
                 static_cast<float*>(o_out),
                 static_cast<float*>(d_out),
                 static_cast<float*>(total_out),
                 static_cast<float*>(trans_out),
                 static_cast<int64_t*>(seed_out),
                 static_cast<bool*>(alive_out),
                 lanes,
                 o_stride,
                 sky_gradient != 0,
                 rr != 0};
  const int blocks = (lanes + kThreads - 1) / kThreads;
  shade_segment<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
