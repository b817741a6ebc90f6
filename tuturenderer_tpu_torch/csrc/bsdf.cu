// The BSDF on Hopper: Material::BxDF, sampleDirection and Material::pdf
// (materials.py::bxdf_eval, ::bxdf_sample, ::bxdf_pdf), one launch a call,
// one lane a thread, each lane computing only its own material's branch.
//
// Replaces no TPU kernel. The JAX package's BSDF (tuturenderer_tpu/
// materials.py) is plain jnp masked arithmetic, which XLA fuses into a few
// kernels. PyTorch runs it eagerly: the plain version computes every
// material branch present on every lane and selects per lane through chains
// of torch.where, ~550 elementwise launches an eval, each reading and
// writing whole columns. These kernels are that fusion, and more: a switch
// on the lane's material type, so a Lambertian lane never computes GGX.
//
// Arithmetic: float32, in the plain version's order, one rounding an
// operation (built with --fmad=false, as every kernel here), with the
// device functions PyTorch's own kernels call: IEEE division and sqrtf,
// rsqrtf for Vec3.normalized's rsqrt, sinf and cosf. Where PyTorch rewrites
// an expression the kernels follow the rewrite: a division by the Python
// float PI is a multiply by its float32 reciprocal (kInvPi), 2.0 / x is
// 1 / x times 2 (Tensor.__rtruediv__), x ** 2 is x * x, torch.clamp passes
// NaN through (clampf), torch.sign is (0 < x) - (x < 0), and a bool mask
// multiplies as 1.0 or 0.0. The kernels equal the plain version bit for bit.
//
// Operands: BsdfCol columns, each a device column read at lane * stride
// (stride 0: one value for every lane, a 0-d tensor) or, with a null
// pointer, a constant passed by value (a Python float eta). Offsets are
// 64-bit: BDPT's stacked calls run 27 wavefronts of lanes in one launch.
// The material type is an int32 or int64 column, the TIR mask a bool
// column (null: all false). `types` is a bitmask of the branches admitted;
// a lane outside it takes what the plain version's final select gives it:
// eval 0, pdf 1, sample the Lambertian direction with success true (false
// for UNLIT), as UNLIT and any other type do.
//
// What bounds it: bytes. An eval lane reads up to 21 float columns and
// writes 3 floats (~105 bytes on a GGX lane), a pdf lane ~56 bytes, a
// sample lane ~66: at 3.35 TB/s, 4,194,304 lanes are ~0.13 ms an eval. The
// arithmetic, a few hundred flops on the GGX branches, is of the same
// order on 132 SMs. So a lane loads only the columns its branch reads
// (a Lambertian eval skips roughness, metallic and both etas), every load
// of a dense column is coalesced across the warp, and nothing is staged or
// synchronised: no shared memory, nothing allocated (the wrapper allocates
// the outputs). Divergence between the branches costs issue slots within a
// warp, not bytes.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

// One operand as the wrapper passes it (materials.py::_Col). Outside the
// unnamed namespace: the exported functions take it.
struct BsdfCol {
  const void* ptr;                   // device column, or null: `value`
  long long stride;                  // elements from one lane to the next
  float value;                       // the constant of a null column
  int kind;                          // kFloat, kInt32, kInt64, kBool
};

namespace {

constexpr int kBlock = 256;
constexpr int kMaxCols = 24;

enum Kind : int { kFloat = 0, kInt32 = 1, kInt64 = 2, kBool = 3 };

// scene/data.py's material types
enum Type : int {
  kLambertian = 0, kPerfectReflective = 1, kPerfectRefractive = 2,
  kMicrofacetR = 3, kMicrofacetT = 4, kUnlit = 5
};

// Column order of each call (materials.py::_EVAL, _SAMPLE, _PDF).
enum EvalCol : int {
  E_MTYPE = 0, E_DIFF = 1, E_METALLIC = 4, E_ROUGH = 5, E_ETA = 6,
  E_WI = 7, E_WO = 10, E_NG = 13, E_NS = 16, E_ETA_SCENE = 19, E_TIR = 20,
  E_COUNT = 21
};
enum SampleCol : int {
  S_MTYPE = 0, S_ALPHA = 1, S_ETA = 2, S_ROUGH = 3, S_WO = 4, S_N = 7,
  S_R0 = 10, S_R1 = 11, S_LOTTERY = 12, S_ETA_SCENE = 13, S_COUNT = 14
};
enum PdfCol : int {
  P_MTYPE = 0, P_ROUGH = 1, P_ETA_MAT = 2, P_WI = 3, P_WO = 6, P_N = 9,
  P_ETA_SCENE = 12, P_COUNT = 13
};

struct Cols {
  BsdfCol c[kMaxCols];
};

// float32 pi (materials.py::PI), its reciprocal as PyTorch rounds a
// division by it (1.0f / pi in float), and 2 pi
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kInvPi = 0x1.45f306p-2f;
constexpr float kTwoPi = 0x1.921fb6p+2f;
constexpr float kFeq = 1e-4f;        // FEQ

struct V {
  float x, y, z;
};

__device__ __forceinline__ float ld(const BsdfCol& c, long long i) {
  return c.ptr ? __ldg(static_cast<const float*>(c.ptr) + i * c.stride)
               : c.value;
}

__device__ __forceinline__ V ld3(const Cols& a, int k, long long i) {
  return {ld(a.c[k], i), ld(a.c[k + 1], i), ld(a.c[k + 2], i)};
}

__device__ __forceinline__ bool ld_bool(const BsdfCol& c, long long i) {
  return c.ptr &&
         __ldg(static_cast<const unsigned char*>(c.ptr) + i * c.stride) != 0;
}

// The lane's material type; -1 for a value that is no type.
__device__ __forceinline__ int ld_type(const BsdfCol& c, long long i) {
  long long t = c.kind == kInt32
      ? __ldg(static_cast<const int*>(c.ptr) + i * c.stride)
      : __ldg(static_cast<const long long*>(c.ptr) + i * c.stride);
  return t >= 0 && t < 32 ? static_cast<int>(t) : -1;
}

__device__ __forceinline__ bool admits(unsigned types, int t) {
  return t >= 0 && ((types >> t) & 1u);
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ V add(V a, V b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ V neg(V a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V scale(V a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}

__device__ __forceinline__ float dot(V a, V b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V cross(V a, V b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// Vec3.normalized(1e-20): the floor 1e-40 is below float32's normal range,
// so it clamps at 0
__device__ __forceinline__ V normalized(V v) {
  return scale(v, rsqrtf(clamp_min(dot(v, v), 0.0f)));
}

// materials.py::_safe_div
__device__ __forceinline__ float safe_div(float a, float b) {
  return a / (b == 0.0f ? 1.0f : b) * (b != 0.0f ? 1.0f : 0.0f);
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

// utils/vec.py::reflect: n * (2 n.i) - i
__device__ __forceinline__ V reflect(V i, V n) {
  const float d = dot(n, i) * 2.0f;
  return {n.x * d - i.x, n.y * d - i.y, n.z * d - i.z};
}

// utils/vec.py::refract: the direction, zero where `tir`
__device__ __forceinline__ V refract(V i, V n, float eta_i, float eta_t,
                                     bool& tir) {
  float cos_i = clampf(dot(n, i), -1.0f, 1.0f);
  if (cos_i < 0.0f) n = neg(n);
  cos_i = fabsf(cos_i);
  const float sin_i = sqrtf(clamp_min(1.0f - cos_i * cos_i, 0.0f));
  const float sin_t = (eta_i / eta_t) * sin_i;
  tir = sin_i > (eta_t / eta_i);
  const float cos_t = sqrtf(clamp_min(1.0f - sin_t * sin_t, 0.0f));
  const float r = eta_i / eta_t;
  if (tir) return {0.0f, 0.0f, 0.0f};
  return {-n.x * cos_t + (n.x * cos_i - i.x) * r,
          -n.y * cos_t + (n.y * cos_i - i.y) * r,
          -n.z * cos_t + (n.z * cos_i - i.z) * r};
}

// utils/vec.py::local_to_world
__device__ __forceinline__ V local_to_world(V n, V l) {
  const bool big = fabsf(n.x) > 0.9f;
  const V a = {big ? 0.0f : 1.0f, big ? 1.0f : 0.0f, 0.0f};
  const V s = normalized(cross(n, a));
  const V t = cross(n, s);
  return normalized({s.x * l.x + t.x * l.y + n.x * l.z,
                     s.y * l.x + t.y * l.y + n.y * l.z,
                     s.z * l.x + t.z * l.y + n.z * l.z});
}

// materials.py::fresnel_ior
__device__ __forceinline__ float fresnel_ior(V i, V n, float eta_i,
                                             float eta_t) {
  const float c = fabsf(dot(i, n));
  const float q = (eta_t - eta_i) / (eta_t + eta_i);
  const float f0 = q * q;
  return f0 + (1.0f - f0) * pow5(clampf(1.0f - c, 0.0f, 1.0f));
}

// materials.py::d_ndf
__device__ __forceinline__ float d_ndf(V h, V n, float roughness) {
  const float a = clamp_min(roughness * roughness, 1e-3f);
  const float nh = dot(n, h);
  const float cos2 = nh * nh;
  const float sin2 = 1.0f - cos2;
  const float s = a * a * cos2 + sin2;
  const float res = s == 0.0f
      ? 1.0f : (a * a) / (clamp_min(s * s, 1e-30f) * kPi);
  return nh < 0.0f ? 0.0f : res;
}

// materials.py::g_smith's g1
__device__ __forceinline__ float g1(V w, V n, V h, float a) {
  const float c = dot(w, n);
  const float c2 = c * c;
  const float tan2 = c2 > 0.0f ? (1.0f - c2) / c2 : 1e30f;
  const float sign = static_cast<float>((0.0f < c) - (c < 0.0f));
  const bool sign_ok = dot(w, h) * sign >= 0.0f;
  const float g =
      1.0f / (1.0f + sqrtf(1.0f + a * a * clampf(tan2, 0.0f, 1e30f))) * 2.0f;
  return (sign_ok ? g : 0.0f) * (c2 > 0.0f ? 1.0f : 0.0f);
}

__device__ __forceinline__ float g_smith(V wi, V wo, V n, float roughness,
                                         V h) {
  const float a = clamp_min(roughness * roughness, 1e-3f);
  return g1(wi, n, h, a) * g1(wo, n, h, a);
}

// materials.py::_ggx_half_vector
__device__ __forceinline__ V ggx_half_vector(V n, float r0, float r1,
                                             float a2) {
  const float phi = r1 * kTwoPi;
  const float cos_t =
      sqrtf(clampf((1.0f - r0) / (r0 * (a2 - 1.0f) + 1.0f), 0.0f, 1.0f));
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  return local_to_world(n, {sin_t * cosf(phi), sin_t * sinf(phi), cos_t});
}

// ------------------------------------------------------------------ eval

// The scalar value of the MICROFACET_T branch before the cosine correction.
__device__ __forceinline__ float microfacet_t(V wi, V wo, V ns, float eta,
                                             float eta_scene, float rough,
                                             bool tir) {
  const bool flip = dot(wo, ns) < 0.0f;
  const V n = flip ? neg(ns) : ns;
  const float eta_i = flip ? eta : eta_scene;
  const float eta_t = flip ? eta_scene : eta;
  if (dot(wi, n) >= 0.0f) {            // reflection
    const V h = normalized(add(wo, wi));
    const float f = tir ? 1.0f : fresnel_ior(wi, h, eta_i, eta_t);
    const float d = d_ndf(h, n, rough);
    const float g = g_smith(wi, wo, n, rough, h);
    const float denom = 4.0f * dot(wi, n) * dot(wo, n);
    return safe_div(f * g * d, denom);
  }
  V h = neg(normalized(add(scale(wo, eta_i), scale(wi, eta_t))));
  if (dot(h, n) < 0.0f) h = neg(h);
  const float cos_ih = dot(wi, h);
  const float cos_oh = dot(wo, h);
  const float cos_in = dot(wi, n);
  const float cos_on = dot(wo, n);
  const float f = fresnel_ior(wi, h, eta_i, eta_t);
  const float d = d_ndf(h, n, rough);
  const float g = g_smith(wi, wo, n, rough, h);
  const float numer = fabsf(cos_ih) * fabsf(cos_oh) * eta_t * eta_t *
                      (1.0f - f) * g * d;
  const float q = eta_i * cos_ih + eta_t * cos_oh;
  const float denom = fabsf(cos_in) * fabsf(cos_on) * (q * q);
  return safe_div(numer, denom);
}

// The scalar value of the PERFECT_REFRACTIVE branch.
__device__ __forceinline__ float perfect_refractive(V wi, V wo, V ns,
                                                    float eta,
                                                    float eta_scene,
                                                    float correct, bool tir) {
  const bool flip = dot(wo, ns) < 0.0f;
  const V n = flip ? neg(ns) : ns;
  const float eta_i = flip ? eta : eta_scene;
  const float eta_t = flip ? eta_scene : eta;
  const float f = fresnel_ior(wi, n, eta_i, eta_t);
  const V ref_dir = normalized(reflect(wo, ns));
  bool tir_r;
  const V trans_dir = normalized(refract(wo, n, eta_i, eta_t, tir_r));
  const V n2 = dot(n, wi) < 0.0f ? neg(n) : n;
  const float c = dot(n2, wi);
  const float inv_cos = 1.0f / (c == 0.0f ? 1e-20f : c);
  if (tir) return inv_cos * correct;
  if (fabsf(dot(wi, ref_dir) - 1.0f) < kFeq) return f * inv_cos * correct;
  if (fabsf(dot(wi, trans_dir) - 1.0f) < kFeq)
    return (1.0f - f) * inv_cos * correct;
  return 0.0f;
}

__global__ void __launch_bounds__(kBlock)
bsdf_eval_kernel(Cols a, long long n, unsigned types, int adjoint,
                 float* __restrict__ out_x, float* __restrict__ out_y,
                 float* __restrict__ out_z) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (i >= n) return;
  const int t = ld_type(a.c[E_MTYPE], i);
  float rx = 0.0f, ry = 0.0f, rz = 0.0f;
  if (admits(types, t) && t != kUnlit) {
    const V wi_in = ld3(a, E_WI, i);
    const V wo_in = ld3(a, E_WO, i);
    const V ng = ld3(a, E_NG, i);
    const V ns = ld3(a, E_NS, i);
    const V wi = adjoint ? wo_in : wi_in;
    const V wo = adjoint ? wi_in : wo_in;
    // sidedness rejection of the reflective kinds, on the original order
    const bool reject = dot(wi_in, ng) * dot(wi_in, ns) <= 0.0f ||
                        dot(wo_in, ng) * dot(wo_in, ns) <= 0.0f;
    const float correct =
        fabsf(dot(wi, ns)) / clamp_min(fabsf(dot(wi, ng)), 1e-20f);
    switch (t) {
      case kLambertian:
        if (!reject && dot(wi, ns) >= 0.0f) {
          const V d = ld3(a, E_DIFF, i);
          const float s = correct * kInvPi;
          rx = d.x * s; ry = d.y * s; rz = d.z * s;
        }
        break;
      case kMicrofacetR:
        if (!reject) {
          const V h = normalized(add(wi, wo));
          const V d = ld3(a, E_DIFF, i);
          const float m = ld(a.c[E_METALLIC], i);
          const float rough = ld(a.c[E_ROUGH], i);
          const V f0 = {0.04f + (d.x - 0.04f) * m, 0.04f + (d.y - 0.04f) * m,
                        0.04f + (d.z - 0.04f) * m};
          const float p = pow5(clampf(1.0f - dot(h, wi), 0.0f, 1.0f));
          const V f = {f0.x + (1.0f - f0.x) * p, f0.y + (1.0f - f0.y) * p,
                       f0.z + (1.0f - f0.z) * p};
          const float gd = g_smith(wi, wo, ns, rough, h) * d_ndf(h, ns, rough);
          const float denom = 4.0f * dot(wi, ns) * dot(wo, ns);
          const bool ok = denom != 0.0f;
          const float inv = 1.0f / (ok ? denom : 1.0f) * (ok ? 1.0f : 0.0f);
          rx = (f.x * gd * inv + (1.0f - f.x) * d.x * kInvPi) * correct;
          ry = (f.y * gd * inv + (1.0f - f.y) * d.y * kInvPi) * correct;
          rz = (f.z * gd * inv + (1.0f - f.z) * d.z * kInvPi) * correct;
        }
        break;
      case kMicrofacetT: {
        const bool tir = ld_bool(a.c[E_TIR], i);
        rx = ry = rz = microfacet_t(wi, wo, ns, ld(a.c[E_ETA], i),
                                    ld(a.c[E_ETA_SCENE], i),
                                    ld(a.c[E_ROUGH], i), tir) * correct;
        break;
      }
      case kPerfectReflective:
        if (!reject) {
          const V h = normalized(add(wi, wo));
          if (fabsf(dot(h, ns) - 1.0f) < kFeq)
            rx = ry = rz = correct / clamp_min(fabsf(dot(ns, wi)), 1e-20f);
        }
        break;
      case kPerfectRefractive:
        rx = ry = rz = perfect_refractive(
            wi, wo, ns, ld(a.c[E_ETA], i), ld(a.c[E_ETA_SCENE], i), correct,
            ld_bool(a.c[E_TIR], i));
        break;
      default:
        break;
    }
  }
  out_x[i] = rx;
  out_y[i] = ry;
  out_z[i] = rz;
}

// ---------------------------------------------------------------- sample

__global__ void __launch_bounds__(kBlock)
bsdf_sample_kernel(Cols a, long long n, unsigned types, int ggx_sample_bug,
                   float* __restrict__ out_x, float* __restrict__ out_y,
                   float* __restrict__ out_z, bool* __restrict__ success,
                   bool* __restrict__ tir_out) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (i >= n) return;
  const int t = ld_type(a.c[S_MTYPE], i);
  const V wo = ld3(a, S_WO, i);
  const V nn = ld3(a, S_N, i);
  const float r0 = ld(a.c[S_R0], i);
  const float r1 = ld(a.c[S_R1], i);
  const float won = dot(wo, nn);
  const bool in = admits(types, t);
  V wi;
  bool ok = t != kUnlit;               // the default's success
  bool tir = false;
  if (in && t == kMicrofacetR) {
    const float rough = ld(a.c[S_ROUGH], i);
    const float r2 = rough * rough;
    float a2;
    if (ggx_sample_bug) {
      a2 = r2 * clamp_min(ld(a.c[S_ALPHA], i), 1e-3f);
    } else {
      const float c = clamp_min(r2, 1e-3f);
      a2 = c * c;
    }
    wi = normalized(reflect(wo, ggx_half_vector(nn, r0, r1, a2)));
    ok = won > 0.0f && dot(wi, nn) > 0.0f;
  } else if (in && (t == kMicrofacetT || t == kPerfectRefractive)) {
    const float eta = ld(a.c[S_ETA], i);
    const float eta_scene = ld(a.c[S_ETA_SCENE], i);
    const bool flip = won < 0.0f;
    const V n_t = flip ? neg(nn) : nn;
    const float eta_i = flip ? eta : eta_scene;
    const float eta_t = flip ? eta_scene : eta;
    V m = n_t;                         // the facet normal
    if (t == kMicrofacetT) {
      const float rough = ld(a.c[S_ROUGH], i);
      const float c = clamp_min(rough * rough, 1e-3f);
      m = ggx_half_vector(n_t, r0, r1, c * c);
    }
    const V refr = refract(wo, m, eta_i, eta_t, tir);
    const float f = fresnel_ior(wo, m, eta_i, eta_t);
    wi = ld(a.c[S_LOTTERY], i) < f ? reflect(wo, m) : refr;
  } else if (in && t == kPerfectReflective) {
    wi = reflect(wo, nn);
  }
  const bool own = in && t >= kPerfectReflective && t <= kMicrofacetT;
  if (!own || tir) {
    // the cosine-weighted hemisphere: the Lambertian branch, the default
    // of every other lane, and (times 0) the direction of a TIR lane
    const float cos_l = sqrtf(clamp_min(r0, 1e-12f));
    const float sin_l = sqrtf(clamp_min(1.0f - r0, 1e-12f));
    const float phi = r1 * kTwoPi;
    const V wl = local_to_world(nn, {cosf(phi) * sin_l, sinf(phi) * sin_l,
                                     cos_l});
    wi = tir ? scale(wl, 0.0f) : wl;
    if (t == kLambertian) ok = won > 0.0f && dot(wl, nn) >= 0.0f;
  }
  wi = normalized(wi);
  out_x[i] = wi.x;
  out_y[i] = wi.y;
  out_z[i] = wi.z;
  success[i] = ok;
  tir_out[i] = tir;
}

// ------------------------------------------------------------------- pdf

__global__ void __launch_bounds__(kBlock)
bsdf_pdf_kernel(Cols a, long long n, unsigned types,
                float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (i >= n) return;
  const int t = ld_type(a.c[P_MTYPE], i);
  float r = 1.0f;                      // the default case
  if (admits(types, t) && t != kUnlit && t <= kMicrofacetT) {
    const V wi = ld3(a, P_WI, i);
    const V wo = ld3(a, P_WO, i);
    const V nn = ld3(a, P_N, i);
    if (t == kLambertian) {
      const float c = dot(wi, nn);
      r = c > 0.0f ? clamp_min(c, 0.0f) * kInvPi : 0.0f;
    } else if (t == kMicrofacetR) {
      const V h = normalized(add(wo, wi));
      const float cos_r = clamp_min(dot(nn, h), 0.0f);
      r = safe_div(d_ndf(h, nn, ld(a.c[P_ROUGH], i)) * cos_r,
                   4.0f * dot(wo, h));
    } else if (t == kPerfectReflective) {
      const V h = normalized(add(wo, wi));
      r = fabsf(dot(h, nn) - 1.0f) < kFeq ? 1.0f : 0.0f;
    } else {
      const float eta = ld(a.c[P_ETA_MAT], i);
      const float eta_scene = ld(a.c[P_ETA_SCENE], i);
      const bool flip = dot(wo, nn) < 0.0f;
      const V n_t = flip ? neg(nn) : nn;
      const float eta_i = flip ? eta : eta_scene;
      const float eta_t = flip ? eta_scene : eta;
      const float f = fresnel_ior(wo, n_t, eta_i, eta_t);
      if (t == kMicrofacetT) {
        const float rough = ld(a.c[P_ROUGH], i);
        if (dot(wi, n_t) >= 0.0f) {
          const V h = normalized(add(wo, wi));
          r = safe_div(f * d_ndf(h, n_t, rough) * fabsf(dot(n_t, h)),
                       4.0f * dot(wo, h));
        } else {
          V h = neg(normalized(add(scale(wo, eta_i), scale(wi, eta_t))));
          float cos_t = dot(n_t, h);
          if (cos_t < 0.0f) h = neg(h);
          cos_t = fabsf(cos_t);
          const float dsq = eta_i * dot(wi, h) + eta_t * dot(wo, h);
          const float jac = safe_div(eta_t * eta_t * fabsf(dot(wo, h)),
                                     dsq * dsq);
          r = (1.0f - f) * d_ndf(h, n_t, rough) * cos_t * jac;
        }
      } else {                         // PERFECT_REFRACTIVE
        const V ref_dir = normalized(reflect(wo, nn));
        bool tir;
        const V trans_dir = normalized(refract(wo, n_t, eta_i, eta_t, tir));
        if (fabsf(dot(wi, ref_dir) - 1.0f) < kFeq)
          r = f;
        else if (fabsf(dot(wi, trans_dir) - 1.0f) < kFeq)
          r = 1.0f - f;
        else
          r = 0.0f;
      }
    }
  }
  out[i] = r;
}

bool load(const BsdfCol* cols, int n_cols, int want, Cols& a) {
  if (n_cols != want || n_cols > kMaxCols) return false;
  a = {};
  for (int k = 0; k < n_cols; ++k) {
    if (cols[k].kind < kFloat || cols[k].kind > kBool) return false;
    a.c[k] = cols[k];
  }
  return true;
}

unsigned grid(long long n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

bool grid_ok(long long n) { return (n + kBlock - 1) / kBlock <= INT_MAX; }

}  // namespace

// Each function launches its kernel over lanes 0 .. n - 1 on `stream` and
// returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue for a column count other than the call's, a column
// kind it does not know or a grid too large. The outputs are float32 rows
// of n (eval: 3, one a component; sample: 3, then `success` and `tir`,
// bool), allocated by the caller.
extern "C" int bsdf_eval(const BsdfCol* cols, int n_cols, unsigned types,
                         int adjoint, long long n, float* out, void* stream) {
  Cols a;
  if (!load(cols, n_cols, E_COUNT, a) || a.c[E_MTYPE].ptr == nullptr ||
      !grid_ok(n))
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  bsdf_eval_kernel<<<grid(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      a, n, types, adjoint, out, out + n, out + 2 * n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bsdf_sample(const BsdfCol* cols, int n_cols, unsigned types,
                           int ggx_sample_bug, long long n, float* wi,
                           bool* success, bool* tir, void* stream) {
  Cols a;
  if (!load(cols, n_cols, S_COUNT, a) || a.c[S_MTYPE].ptr == nullptr ||
      !grid_ok(n))
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  bsdf_sample_kernel<<<grid(n), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, n, types, ggx_sample_bug, wi, wi + n, wi + 2 * n, success, tir);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bsdf_pdf(const BsdfCol* cols, int n_cols, unsigned types,
                        long long n, float* out, void* stream) {
  Cols a;
  if (!load(cols, n_cols, P_COUNT, a) || a.c[P_MTYPE].ptr == nullptr ||
      !grid_ok(n))
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  bsdf_pdf_kernel<<<grid(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      a, n, types, out);
  return static_cast<int>(cudaGetLastError());
}
