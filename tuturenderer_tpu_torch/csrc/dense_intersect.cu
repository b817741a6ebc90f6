// Dense ray/triangle intersection on Hopper: nearest hit and any hit, in
// the Woop form and in the Moller-Trumbore (MT) form.
//
// Replaces the four Pallas TPU kernels of the dense path tracer,
// tuturenderer_tpu/ops/pallas/intersect.py::_kernel_woop (nearest hit),
// ::_kernel_woop_anyhit (shadow-ray any hit), and their MT forms ::_kernel
// and ::_kernel_anyhit (PALLAS_IMPL = "mt"). Same contracts, same
// arithmetic in the same order of operations (reciprocal then multiply,
// 1 - u - v): built with --fmad=false, so no multiply-add is contracted and
// each result is the one the plain PyTorch version
// (ops/cuda/intersect.py) computes.
//
// Woop triangle table: flat float32 [T * 13], per triangle
//   r1(3) c1 r2(3) c2 r3(3) c3 nlen
// the rows of the inverse [e1 e2 n] basis, c_k = r_k . v0 and |n|,
// factorised in float64 on the host. MT table: flat float32 [T * 12],
//   v0(3) e1(3) e2(3) n_hat(3)
// computed in float32 on the device, 48 bytes a triangle, starting on a
// 16-byte boundary (the wrapper checks). Rays: six float32 [N] columns.
//
// K1, K2 and K4: one thread per ray, a loop over the T triangles in index
// order. Triangle i is read with 12 (13) uniform-index __ldg loads; every
// thread of a warp reads the same address, so each is a broadcast served
// from L1. The any-hit thread returns at its first accepted triangle.
//
// K3 (mt_nearest_kernel): the block stages the table in shared memory in
// tiles of 256 triangles (12 KB), copied as 16-byte cp.async with the next
// tile in flight while the current one is tested; each test reads its
// triangle as three float4, a broadcast (every lane the same address, no
// bank conflict); each thread traces two rays (i and i + 256 of its
// block's 512), so one triangle read serves two tests and the two chains
// hide the division's latency. Ray columns and outputs stay coalesced.
//
// Every nearest hit keeps its best in registers and updates on a strict
// t < best in index order, so an exact t tie keeps the lowest index.
//
// What bounds them: at simple_box's 12 triangles a launch reads 24 bytes
// (28 with dist) and writes 16 (4) per ray, ~40 MB for 1M rays, 0.0125 ms
// at 3.35 TB/s. A test costs ~35 fp32 operations in the Woop form and ~55
// in the MT form, unfused under --fmad=false, plus the division, compares
// and selects; issuing those, not the bytes, sets the time (on an H100,
// K3 at 4095 triangles takes ~119 issue slots per test at the card's peak
// clock, PERF.md).
// K3's design takes the triangle loads off that issue (3 shared-memory
// reads per two tests, in place of 12 scalar loads per test), leaving the
// test's own arithmetic. K1, K2 and K4 still read scalars, and the any
// hits have no per-block early exit (__syncthreads_and): later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kF32Max = 3.4e38f;
constexpr float kParallelEps = 1e-4f;   // FLOAT_EQUAL, global.hpp:134-136
constexpr int kBlock = 256;

struct Hit {
  float t, u, v;
  bool ok;    // accepted by Triangle.hpp:39-49; comparisons with NaN fail
};

// Woop test of one ray against triangle `tri`: t = -w_o * (1 / w_d),
// u = (o.r1 - c1) + t (d.r1), v likewise, dn = w_d |n| = dir . n_hat.
// Accepted when not near-parallel and t, u, v, 1 - u - v > 0.
struct Woop {
  static constexpr int kFloats = 13;
  __device__ __forceinline__ static Hit test(const float* __restrict__ tri,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz) {
    const float r1x = __ldg(tri + 0), r1y = __ldg(tri + 1), r1z = __ldg(tri + 2);
    const float c1 = __ldg(tri + 3);
    const float r2x = __ldg(tri + 4), r2y = __ldg(tri + 5), r2z = __ldg(tri + 6);
    const float c2 = __ldg(tri + 7);
    const float r3x = __ldg(tri + 8), r3y = __ldg(tri + 9), r3z = __ldg(tri + 10);
    const float c3 = __ldg(tri + 11);
    const float nlen = __ldg(tri + 12);
    const float w_o = ox * r3x + oy * r3y + oz * r3z - c3;
    const float w_d = dx * r3x + dy * r3y + dz * r3z;
    const float inv = 1.0f / w_d;     // w_d == 0 -> inf/NaN, rejected below
    Hit h;
    h.t = -w_o * inv;
    h.u = (ox * r1x + oy * r1y + oz * r1z - c1) + h.t * (dx * r1x + dy * r1y + dz * r1z);
    h.v = (ox * r2x + oy * r2y + oz * r2z - c2) + h.t * (dx * r2x + dy * r2y + dz * r2z);
    const float dn = w_d * nlen;
    h.ok = fabsf(dn) >= kParallelEps && h.t > 0.0f && h.u > 0.0f &&
           h.v > 0.0f && 1.0f - h.u - h.v > 0.0f;
    return h;
  }
};

// Moller-Trumbore test in the order of _kernel: s = o - v0, s1 = d x e2,
// s2 = s x e1, det = s1 . e1, dn = d . n_hat, inv = 1 / det (unguarded:
// det == 0 gives inf/NaN), t, u, v as products with inv. Accepted as the
// Woop form, and det != 0.
struct MollerTrumbore {
  static constexpr int kFloats = 12;
  __device__ __forceinline__ static Hit eval(
      float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
      float e2x, float e2y, float e2z, float nux, float nuy, float nuz,
      float ox, float oy, float oz, float dx, float dy, float dz) {
    const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
    const float s1x = dy * e2z - dz * e2y;
    const float s1y = dz * e2x - dx * e2z;
    const float s1z = dx * e2y - dy * e2x;
    const float s2x = sy * e1z - sz * e1y;
    const float s2y = sz * e1x - sx * e1z;
    const float s2z = sx * e1y - sy * e1x;
    const float det = s1x * e1x + s1y * e1y + s1z * e1z;
    const float dn = dx * nux + dy * nuy + dz * nuz;
    const float inv = 1.0f / det;
    Hit h;
    h.t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv;
    h.u = (s1x * sx + s1y * sy + s1z * sz) * inv;
    h.v = (s2x * dx + s2y * dy + s2z * dz) * inv;
    h.ok = fabsf(dn) >= kParallelEps && det != 0.0f && h.t > 0.0f &&
           h.u > 0.0f && h.v > 0.0f && 1.0f - h.u - h.v > 0.0f;
    return h;
  }
  // triangle `tri` of the flat table, 12 scalar loads (K4)
  __device__ __forceinline__ static Hit test(const float* __restrict__ tri,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz) {
    return eval(__ldg(tri + 0), __ldg(tri + 1), __ldg(tri + 2),
                __ldg(tri + 3), __ldg(tri + 4), __ldg(tri + 5),
                __ldg(tri + 6), __ldg(tri + 7), __ldg(tri + 8),
                __ldg(tri + 9), __ldg(tri + 10), __ldg(tri + 11), ox, oy, oz,
                dx, dy, dz);
  }
  // a triangle as three float4: v0x v0y v0z e1x | e1y e1z e2x e2y |
  // e2z nux nuy nuz (K3, from shared memory)
  __device__ __forceinline__ static Hit test(const float4& a, const float4& b,
                                             const float4& c, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz) {
    return eval(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w,
                ox, oy, oz, dx, dy, dz);
  }
};

template <typename Form>
__global__ void __launch_bounds__(kBlock)
nearest_kernel(const float* __restrict__ tris, int n_tris,
               const float* __restrict__ ox, const float* __restrict__ oy,
               const float* __restrict__ oz, const float* __restrict__ dx,
               const float* __restrict__ dy, const float* __restrict__ dz,
               int n, float* __restrict__ t_out, int* __restrict__ idx_out,
               float* __restrict__ bu_out, float* __restrict__ bv_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float rox = ox[i], roy = oy[i], roz = oz[i];
  const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
  float t_best = kF32Max, bu = 0.0f, bv = 0.0f;
  int idx_best = -1;
  for (int k = 0; k < n_tris; ++k) {
    const Hit h = Form::test(tris + k * Form::kFloats, rox, roy, roz, rdx,
                             rdy, rdz);
    if (h.ok && h.t < t_best) {
      t_best = h.t;
      idx_best = k;
      bu = h.u;
      bv = h.v;
    }
  }
  t_out[i] = t_best;
  idx_out[i] = idx_best;
  bu_out[i] = bu;
  bv_out[i] = bv;
}

template <typename Form>
__global__ void __launch_bounds__(kBlock)
anyhit_kernel(const float* __restrict__ tris, int n_tris,
              const float* __restrict__ ox, const float* __restrict__ oy,
              const float* __restrict__ oz, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const float* __restrict__ dist, int n,
              int* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float rox = ox[i], roy = oy[i], roz = oz[i];
  const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
  const float rdist = dist[i];
  int blocked = 0;
  for (int k = 0; k < n_tris; ++k) {
    const Hit h = Form::test(tris + k * Form::kFloats, rox, roy, roz, rdx,
                             rdy, rdz);
    // t < dist with the FLOAT_EQUAL endpoint guard (BVH.hpp:184)
    if (h.ok && h.t < rdist && fabsf(h.t - rdist) >= kParallelEps) {
      blocked = 1;
      break;
    }
  }
  hit_out[i] = blocked;
}

constexpr int kMtTile = 256;            // triangles per shared-memory tile
constexpr int kMtTileF4 = 3 * kMtTile;  // float4 per tile
constexpr int kMtRays = 2;              // rays per thread

// Copies tile `tile` of the MT table (at most kMtTile triangles; none past
// the last) into `dst` as 16-byte cp.async, and commits them as one group.
__device__ __forceinline__ void stage_tile(float4* dst,
                                           const float4* __restrict__ tris,
                                           int tile, int n_tris) {
  const int first = tile * kMtTile;
  const int n_f4 = 3 * max(0, min(kMtTile, n_tris - first));
  const float4* src = tris + 3 * static_cast<size_t>(first);
  for (int j = threadIdx.x; j < n_f4; j += kBlock) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + j));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + j));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

struct Best {
  float t = kF32Max, u = 0.0f, v = 0.0f;
  int idx = -1;
  __device__ __forceinline__ void update(const Hit& h, int k) {
    if (h.ok && h.t < t) {
      t = h.t;
      idx = k;
      u = h.u;
      v = h.v;
    }
  }
};

// K3: the MT nearest hit, two rays per thread against triangle tiles in
// shared memory (see the head of this file).
__global__ void __launch_bounds__(kBlock)
mt_nearest_kernel(const float4* __restrict__ tris, int n_tris,
                  const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  int n, float* __restrict__ t_out, int* __restrict__ idx_out,
                  float* __restrict__ bu_out, float* __restrict__ bv_out) {
  __shared__ float4 tile[2][kMtTileF4];
  // every thread stages tiles and meets the barriers; a ray past n is
  // traced as zeros and not written
  const int i0 = blockIdx.x * (kMtRays * kBlock) + threadIdx.x;
  const int i1 = i0 + kBlock;
  const bool live0 = i0 < n, live1 = i1 < n;
  const float ox0 = live0 ? ox[i0] : 0.0f, ox1 = live1 ? ox[i1] : 0.0f;
  const float oy0 = live0 ? oy[i0] : 0.0f, oy1 = live1 ? oy[i1] : 0.0f;
  const float oz0 = live0 ? oz[i0] : 0.0f, oz1 = live1 ? oz[i1] : 0.0f;
  const float dx0 = live0 ? dx[i0] : 0.0f, dx1 = live1 ? dx[i1] : 0.0f;
  const float dy0 = live0 ? dy[i0] : 0.0f, dy1 = live1 ? dy[i1] : 0.0f;
  const float dz0 = live0 ? dz[i0] : 0.0f, dz1 = live1 ? dz[i1] : 0.0f;
  Best b0, b1;
  const int n_tiles = (n_tris + kMtTile - 1) / kMtTile;
  stage_tile(tile[0], tris, 0, n_tris);
  for (int t = 0; t < n_tiles; ++t) {
    // the next tile in flight (an empty group past the last); tile t's
    // group is then the only one that must have landed
    stage_tile(tile[(t + 1) & 1], tris, t + 1, n_tris);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float4* s = tile[t & 1];
    const int base = t * kMtTile;
    const int count = min(kMtTile, n_tris - base);
    for (int k = 0; k < count; ++k) {
      const float4 a = s[3 * k], b = s[3 * k + 1], c = s[3 * k + 2];
      b0.update(MollerTrumbore::test(a, b, c, ox0, oy0, oz0, dx0, dy0, dz0),
                base + k);
      b1.update(MollerTrumbore::test(a, b, c, ox1, oy1, oz1, dx1, dy1, dz1),
                base + k);
    }
    // every thread is done with tile t before the next stage overwrites it
    __syncthreads();
  }
  if (live0) {
    t_out[i0] = b0.t;
    idx_out[i0] = b0.idx;
    bu_out[i0] = b0.u;
    bv_out[i0] = b0.v;
  }
  if (live1) {
    t_out[i1] = b1.t;
    idx_out[i1] = b1.idx;
    bu_out[i1] = b1.u;
    bv_out[i1] = b1.v;
  }
}

template <typename Form>
int launch_nearest(const float* tris, int n_tris, const float* ox,
                   const float* oy, const float* oz, const float* dx,
                   const float* dy, const float* dz, int n, float* t_out,
                   int* idx_out, float* bu_out, float* bv_out, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  nearest_kernel<Form><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tris, n_tris, ox, oy, oz, dx, dy, dz, n, t_out, idx_out, bu_out, bv_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Form>
int launch_anyhit(const float* tris, int n_tris, const float* ox,
                  const float* oy, const float* oz, const float* dx,
                  const float* dy, const float* dz, const float* dist, int n,
                  int* hit_out, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  anyhit_kernel<Form><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tris, n_tris, ox, oy, oz, dx, dy, dz, dist, n, hit_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int woop_nearest(const float* tris, int n_tris, const float* ox,
                            const float* oy, const float* oz, const float* dx,
                            const float* dy, const float* dz, int n, float* t_out,
                            int* idx_out, float* bu_out, float* bv_out,
                            void* stream) {
  return launch_nearest<Woop>(tris, n_tris, ox, oy, oz, dx, dy, dz, n, t_out,
                              idx_out, bu_out, bv_out, stream);
}

extern "C" int woop_anyhit(const float* tris, int n_tris, const float* ox,
                           const float* oy, const float* oz, const float* dx,
                           const float* dy, const float* dz, const float* dist,
                           int n, int* hit_out, void* stream) {
  return launch_anyhit<Woop>(tris, n_tris, ox, oy, oz, dx, dy, dz, dist, n,
                             hit_out, stream);
}

extern "C" int mt_nearest(const float* tris, int n_tris, const float* ox,
                          const float* oy, const float* oz, const float* dx,
                          const float* dy, const float* dz, int n, float* t_out,
                          int* idx_out, float* bu_out, float* bv_out,
                          void* stream) {
  const int grid = (n + kMtRays * kBlock - 1) / (kMtRays * kBlock);
  mt_nearest_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tris), n_tris, ox, oy, oz, dx, dy, dz,
      n, t_out, idx_out, bu_out, bv_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mt_anyhit(const float* tris, int n_tris, const float* ox,
                         const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz, const float* dist,
                         int n, int* hit_out, void* stream) {
  return launch_anyhit<MollerTrumbore>(tris, n_tris, ox, oy, oz, dx, dy, dz,
                                       dist, n, hit_out, stream);
}
