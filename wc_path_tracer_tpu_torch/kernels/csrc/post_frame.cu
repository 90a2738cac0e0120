// Post-processing of a served frame for NVIDIA Hopper (sm_90a): P1.
//
// Replaces no TPU kernel.  The JAX package's bloom and tonemaps
// (ops/bloom.py, ops/tonemap.py) are jnp code that XLA fuses; in eager
// PyTorch render/renderer.py::_finalize is about 850 launches at 1024^2
// (the bloom pyramid's strided slices, edge pads and stacks, then the
// tonemap, the gamma and the cast), each a few microseconds of work on a
// 512^2-or-smaller texture, and the host cannot enqueue them as fast as
// they run.  These kernels do the same work in 2L launches for an L-level
// pyramid (16 at 1024^2, 14 at 512^2; 1 without bloom), and _finalize is
// their plain twin: the uint8 image agrees bit for bit.
//
// Stages, one launch each, one thread per output texel:
//  - down: ops/bloom.py::downsample_box13, the 4x4 stencil around each 2x2
//    block read with clamp-to-edge addressing (the edge pad of an odd size
//    and the stencil's pad, composed); the first level applies prefilter
//    (clamp at 20, then the quadratic threshold) to its result;
//  - up: u[k] = chain[k] + upsample_tent9(u[k + 1]), written over chain[k]:
//    the tent-3 convolution on the extended grid (_tent3_ext), then the 2x
//    bilinear row pass and the column pass (_upsample2x_from_ext);
//  - composite: _upsample2x_bilinear of u[0] to full size, img + strength *
//    bloom, the tonemap selected by id (ops/tonemap.TONEMAPS, in its order),
//    pow(clamp_min(x, 0), 1 / gamma) as torch.pow dispatches on its
//    exponent, clamp(0, 1) * 255 and the cast through int64 to uint8.
//
// Bit for bit with PyTorch's op-by-op arithmetic: built with -fmad=false;
// every sum left to right in the Python expression's order, each op
// rounded to float32; every Python scalar as the float32 PyTorch computes
// with, passed by the wrapper (kernels/post.py) where the chain derives it;
// `s / x` as Tensor.__rtruediv__'s reciprocal(x) * s, and `x / s` for a
// Python scalar s as PyTorch's CUDA division by a CPU scalar, x * (1 / s);
// powf, expf, sqrtf and IEEE division, as PyTorch's kernels call them;
// clamp / maximum / amax's NaN propagation, where fminf and fmaxf alone
// would drop a NaN.
//
// What bounds it: launch latency, then bytes.  At 1024^2 a frame reads the
// 12 MB HDR image and writes the 3 MB uint8 image; the pyramid's levels
// (3 MB at 512^2, a third of that below) are each written once, read once
// by the next level down, then read and written once more by the way up:
// ~24 MB counted once each, ~7 us at 3.35 TB/s.  The 16 dependent launches cost more than
// that (a few us each, the smallest levels one block), and their enqueue
// from the host more again.  So the design keeps the launches few and
// each one a single pass: no padded copies (addresses are clamped), no
// shared-memory staging (a thread's 4x4 stencil overlaps its neighbours'
// and stays in L1), and each level's texels read and written once a
// launch.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kConsts = 16;

// what one launch does (kernels/post.py: DOWN, DOWN_PREFILTER, UP,
// COMPOSITE)
constexpr int kDown = 0, kDownPrefilter = 1, kUp = 2, kComposite = 3;

// ops/tonemap.TONEMAPS, in its order (kernels/post.py::TONEMAP_IDS)
enum Tonemap {
  kNone = 0,
  kAces = 1,
  kPbrNeutral = 2,
  kUnreal = 3,
  kFilmic = 4,
  kLottes = 5,
  kReinhard = 6,
  kReinhard2 = 7,
  kUchimura = 8,
  kUncharted2 = 9,
  kSrgb = 10,
};

// torch.pow(tensor, e)'s dispatch on a scalar exponent e, for the display
// gamma (kernels/post.py::POW_MODES): none (gamma 1: no clamp, no pow),
// e == 0 fills 1, e == 1 copies, .5 / -.5 / -1 are sqrt / rsqrt /
// reciprocal; then on float32(e): 2, 3, -2 are products; else powf
enum PowMode {
  kNoGamma = 0,
  kFill1 = 1,
  kCopy = 2,
  kSqrt = 3,
  kRsqrt = 4,
  kRecip = 5,
  kSquare = 6,
  kCube = 7,
  kInvSquare = 8,
  kPowf = 9,
};

// The Python scalars of one frame's chain as float32 (kernels/post.py::
// constants): [0] bloom strength; [1..4] prefilter's threshold - knee,
// 2 knee, 0.25 / max(knee, 1e-5) and threshold; [5] the gamma exponent;
// [6..] the tonemap's constants, in the order its function below reads
// them
struct Consts {
  float v[kConsts];
};
constexpr int kTm = 6;

// torch.clamp / clamp_min / clamp_max / maximum: a NaN passes through
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tclamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float tclamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.amax / amin over RGB: the reduction's step, NaN wins
__device__ __forceinline__ float amax3(const float c[3]) {
  float m = c[0];
  m = (m != m || m > c[1]) ? m : c[1];
  return (m != m || m > c[2]) ? m : c[2];
}
__device__ __forceinline__ float amin3(const float c[3]) {
  float m = c[0];
  m = (m != m || m < c[1]) ? m : c[1];
  return (m != m || m < c[2]) ? m : c[2];
}

__device__ __forceinline__ int clampi(int i, int n) {
  return min(max(i, 0), n - 1);
}

// the three channels of texel (y, x) of an (h, w, 3) image, clamp-to-edge
__device__ __forceinline__ void texel(const float* __restrict__ img, int h,
                                      int w, int y, int x, float out[3]) {
  const size_t i = (static_cast<size_t>(clampi(y, h)) * w + clampi(x, w)) * 3;
  out[0] = img[i];
  out[1] = img[i + 1];
  out[2] = img[i + 2];
}

// bloom.py::_axis_up2's taps: an output texel 2k + p reads extended samples
// k + p (weight 0.25, or 0.75 for p = 1) then k + p + 1; the sum in that
// order (`0.25 * lo + 0.75 * mid`, `0.75 * mid + 0.25 * hi`)
__device__ __forceinline__ float lerp_tap(float lo, float hi, int p) {
  return p ? 0.75f * lo + 0.25f * hi : 0.25f * lo + 0.75f * hi;
}

// ---- down: downsample_box13, and prefilter on the first level ----------

__device__ __forceinline__ float corner(const float s[4][4], int dy, int dx) {
  // s[dy + 1][dx + 1] is the texel at block origin + (dy, dx)
  return (((s[dy][dx] + s[dy][dx + 1]) + s[dy + 1][dx]) + s[dy + 1][dx + 1]) *
         0.25f;
}

__device__ __forceinline__ float box13(const float s[4][4]) {
  const float inner = ((s[1][1] + s[1][2]) + s[2][1]) + s[2][2];
  const float out = 0.5f * (corner(s, 1, 1) + inner) +
                    0.25f * corner(s, 0, 0) + 0.25f * corner(s, 1, 0) +
                    0.125f * corner(s, 2, 1) + 0.375f * corner(s, 2, 2) +
                    0.25f * corner(s, 1, 2) + 0.25f * corner(s, 0, 1);
  return out * 0.25f;
}

// bloom.py::prefilter: clamp_max(20), then quadratic_threshold
__device__ __forceinline__ void prefilter(float c[3], const Consts& k) {
  for (int ch = 0; ch < 3; ++ch) c[ch] = tclamp_max(c[ch], 20.0f);
  const float brightness = amax3(c);
  float rq = tclamp(brightness - k.v[1], 0.0f, k.v[2]);
  rq = (rq * rq) * k.v[3];
  const float scale = tmax(rq, brightness - k.v[4]) /
                      tclamp_min(brightness, 0x1.a36e2ep-14f);  // f32(1e-4)
  for (int ch = 0; ch < 3; ++ch) c[ch] = c[ch] * scale;
}

__global__ void __launch_bounds__(kThreads) post_down(
    const float* __restrict__ src, float* __restrict__ dst, int hs, int ws,
    int hd, int wd, bool first, Consts k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= hd * wd) return;
  const int y = i / wd, x = i - y * wd;
  float t[4][4][3];
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b)
      texel(src, hs, ws, 2 * y + a - 1, 2 * x + b - 1, t[a][b]);
  float c[3];
  for (int ch = 0; ch < 3; ++ch) {
    float s[4][4];
    for (int a = 0; a < 4; ++a)
      for (int b = 0; b < 4; ++b) s[a][b] = t[a][b][ch];
    c[ch] = box13(s);
  }
  if (first) prefilter(c, k);
  for (int ch = 0; ch < 3; ++ch) dst[3 * static_cast<size_t>(i) + ch] = c[ch];
}

// ---- up: chain[k] + upsample_tent9(u[k + 1]) ----------------------------

// _tent3_ext at extended sample (r, c), r in -1..h, c in -1..w, of the taps
// t[dy + 1][dx + 1] around it
__device__ __forceinline__ float tent3(const float t[3][3]) {
  const float row = (t[0][0] + 2.0f * t[0][1]) + t[0][2];
  const float mid = (t[1][0] + 2.0f * t[1][1]) + t[1][2];
  const float bot = (t[2][0] + 2.0f * t[2][1]) + t[2][2];
  return ((row + 2.0f * mid) + bot) * 0.0625f;  // * (1.0 / 16.0)
}

__global__ void __launch_bounds__(kThreads) post_up(
    const float* __restrict__ src, float* __restrict__ dst, int hs, int ws,
    int hd, int wd) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= hd * wd) return;
  const int y = i / wd, x = i - y * wd;
  const int py = y & 1, px = x & 1;
  // extended samples (r0 + a, c0 + b), a, b in {0, 1}, at source rows and
  // columns r0 + a - 1 + dy, dy in -1..1: source texels r0 - 2 .. r0 + 1
  const int r0 = (y >> 1) + py - 1, c0 = (x >> 1) + px - 1;
  float t[4][4][3];
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b)
      texel(src, hs, ws, r0 + a - 1, c0 + b - 1, t[a][b]);
  for (int ch = 0; ch < 3; ++ch) {
    float e[2][2];
    for (int a = 0; a < 2; ++a)
      for (int b = 0; b < 2; ++b) {
        float tap[3][3];
        for (int dy = 0; dy < 3; ++dy)
          for (int dx = 0; dx < 3; ++dx) tap[dy][dx] = t[a + dy][b + dx][ch];
        e[a][b] = tent3(tap);
      }
    // the row pass on both extended columns, then the column pass
    const float left = lerp_tap(e[0][0], e[1][0], py);
    const float right = lerp_tap(e[0][1], e[1][1], py);
    const size_t o = 3 * static_cast<size_t>(i) + ch;
    dst[o] = dst[o] + lerp_tap(left, right, px);
  }
}

// ---- composite: bloom's full-size tap, tonemap, gamma, uint8 ------------

__device__ __forceinline__ float aces(float x, const float* k) {
  return (x * (k[0] * x + k[1])) / (x * (k[2] * x + k[3]) + k[4]);
}

// k: start_compression, desaturation, d * d, d, f32(0.08), f32(6.25),
// f32(0.04)
__device__ __forceinline__ void pbr_neutral(float c[3], const float* k) {
  const float x = amin3(c);
  const float offset = x < k[4] ? x - (k[5] * x) * x : k[6];
  for (int ch = 0; ch < 3; ++ch) c[ch] = c[ch] - offset;
  const float peak = amax3(c);
  const float new_peak = 1.0f - (1.0f / ((peak + k[3]) - k[0])) * k[2];
  const float g =
      1.0f - (1.0f / (k[1] * (peak - new_peak) + 1.0f)) * 1.0f;
  if (peak < k[0]) return;
  for (int ch = 0; ch < 3; ++ch) {
    const float scaled = (c[ch] * new_peak) / peak;
    c[ch] = scaled * (1.0f - g) + new_peak * g;
  }
}

__device__ __forceinline__ float unreal(float x, const float* k) {
  return (x / (x + k[0])) * k[1];
}

// k: f32(0.004), f32(6.2), f32(1.7), f32(0.06), f32(2.2)
__device__ __forceinline__ float filmic(float x, const float* k) {
  const float X = tclamp_min(x - k[0], 0.0f);
  const float r = (X * (k[1] * X + 0.5f)) / (X * (k[1] * X + k[2]) + k[3]);
  return powf(r, k[4]);
}

// k: a, a * d, b, c of the Lottes curve
__device__ __forceinline__ float lottes(float x, const float* k) {
  const float xs = tclamp_min(x, 0.0f);
  return powf(xs, k[0]) / (powf(xs, k[1]) * k[2] + k[3]);
}

__device__ __forceinline__ float reinhard(float x) { return x / (x + 1.0f); }

// k: 1 / l_white^2 (x / 16.0 as x * (1 / 16))
__device__ __forceinline__ float reinhard2(float x, const float* k) {
  return (x * (x * k[0] + 1.0f)) / (x + 1.0f);
}

// k: m, 1 / m, c, b, S0, P - S1, CP, P, a, m + l0
__device__ __forceinline__ float uchimura(float x, const float* k) {
  const float t = tclamp((x - 0.0f) * k[1], 0.0f, 1.0f);  // _smoothstep(0, m)
  const float w0 = 1.0f - (t * t) * (3.0f - 2.0f * t);
  const float w2 = x >= k[9] ? 1.0f : 0.0f;
  const float w1 = (1.0f - w0) - w2;
  const float T = k[0] * powf(tclamp_min(x, 0.0f) * k[1], k[2]) + k[3];
  const float S = k[7] - k[5] * expf(k[6] * (x - k[4]));
  const float L = k[0] + k[8] * (x - k[0]);
  return (T * w0 + L * w1) + S * w2;
}

// k: A, C * B, D * E, B, D * F, E / F, 1 / white
__device__ __forceinline__ float uncharted2(float c, const float* k) {
  const float x = 2.0f * c;
  const float num = x * (k[0] * x + k[1]) + k[2];
  const float den = x * (k[0] * x + k[3]) + k[4];
  return (num / den - k[5]) * k[6];
}

// k: f32(0.0031308), f32(12.92), f32(1 / 2.4), f32(1.055), f32(0.055)
__device__ __forceinline__ float srgb(float v, const float* k) {
  const float x = tclamp_min(v, 0.0f);
  return x <= k[0] ? x * k[1] : powf(x, k[2]) * k[3] - k[4];
}

__device__ __forceinline__ void tonemap(int id, float c[3], const float* k) {
  if (id == kPbrNeutral) {
    pbr_neutral(c, k);
    return;
  }
  for (int ch = 0; ch < 3; ++ch) {
    const float x = c[ch];
    switch (id) {
      case kAces: c[ch] = aces(x, k); break;
      case kUnreal: c[ch] = unreal(x, k); break;
      case kFilmic: c[ch] = filmic(x, k); break;
      case kLottes: c[ch] = lottes(x, k); break;
      case kReinhard: c[ch] = reinhard(x); break;
      case kReinhard2: c[ch] = reinhard2(x, k); break;
      case kUchimura: c[ch] = uchimura(x, k); break;
      case kUncharted2: c[ch] = uncharted2(x, k); break;
      case kSrgb: c[ch] = srgb(x, k); break;
      default: break;  // kNone
    }
  }
}

__device__ __forceinline__ float gamma_pow(float v, int mode, float e) {
  switch (mode) {
    case kFill1: return 1.0f;
    case kCopy: return v;
    case kSqrt: return sqrtf(v);
    case kRsqrt: return rsqrtf(v);
    case kRecip: return 1.0f / v;
    case kSquare: return v * v;
    case kCube: return (v * v) * v;
    case kInvSquare:  // `1.0 / (base * base)`: a double quotient
      return static_cast<float>(1.0 / static_cast<double>(v * v));
    default: return powf(v, e);
  }
}

__global__ void __launch_bounds__(kThreads) post_composite(
    const float* __restrict__ bloom, const float* __restrict__ img,
    uint8_t* __restrict__ out, int hb, int wb, int h, int w, int tm,
    int pow_mode, Consts k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= h * w) return;
  float c[3];
  for (int ch = 0; ch < 3; ++ch) c[ch] = img[3 * static_cast<size_t>(i) + ch];
  if (bloom != nullptr) {
    // _upsample2x_bilinear: extended sample (r, c) is texel (r - 1, c - 1)
    // of the clamp-padded half-size texture
    const int y = i / w, x = i - y * w;
    const int py = y & 1, px = x & 1;
    const int r0 = (y >> 1) + py - 1, c0 = (x >> 1) + px - 1;
    float t[2][2][3];
    for (int a = 0; a < 2; ++a)
      for (int b = 0; b < 2; ++b) texel(bloom, hb, wb, r0 + a, c0 + b, t[a][b]);
    for (int ch = 0; ch < 3; ++ch) {
      const float left = lerp_tap(t[0][0][ch], t[1][0][ch], py);
      const float right = lerp_tap(t[0][1][ch], t[1][1][ch], py);
      c[ch] = c[ch] + k.v[0] * lerp_tap(left, right, px);
    }
  }
  tonemap(tm, c, k.v + kTm);
  for (int ch = 0; ch < 3; ++ch) {
    float v = c[ch];
    if (pow_mode != kNoGamma)
      v = gamma_pow(tclamp_min(v, 0.0f), pow_mode, k.v[5]);
    v = tclamp(v, 0.0f, 1.0f) * 255.0f;
    out[3 * static_cast<size_t>(i) + ch] =
        static_cast<uint8_t>(static_cast<int64_t>(v));
  }
}

}  // namespace

// One stage of the post chain on `stream`.  down: a (ha, wa, 3) -> b (hb,
// wb, 3); up: b (hb, wb, 3) += upsample_tent9(a (ha, wa, 3)); composite:
// a the half-size bloom texture (ha, wa, 3) or null, b the HDR image (hb,
// wb, 3), out (hb, wb, 3) uint8.  consts: kConsts floats in host memory.
extern "C" int wc_post_frame(const void* a, void* b, void* out,
                             const void* consts, int stage, int ha, int wa,
                             int hb, int wb, int tonemap_id, int pow_mode,
                             void* stream) {
  Consts k;
  std::memcpy(k.v, consts, sizeof(k.v));
  const int blocks = (hb * wb + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(a);
  float* dst = static_cast<float*>(b);
  if (blocks == 0) return 0;
  switch (stage) {
    case kDown:
    case kDownPrefilter:
      post_down<<<blocks, kThreads, 0, s>>>(src, dst, ha, wa, hb, wb,
                                            stage == kDownPrefilter, k);
      break;
    case kUp:
      post_up<<<blocks, kThreads, 0, s>>>(src, dst, ha, wa, hb, wb);
      break;
    case kComposite:
      post_composite<<<blocks, kThreads, 0, s>>>(
          src, dst, static_cast<uint8_t*>(out), ha, wa, hb, wb, tonemap_id,
          pow_mode, k);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
