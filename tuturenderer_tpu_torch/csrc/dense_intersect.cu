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
// 16-byte boundary (the wrappers check). Rays: six float32 [N] columns.
//
// K1-K4 (woop_nearest_kernel, woop_anyhit_kernel, mt_nearest_kernel,
// mt_anyhit_kernel): the block stages the table in shared memory in tiles
// of 256 triangles, the next tile in flight by cp.async while the current
// one is tested; each test reads its triangle as broadcast float4s (every
// lane the same address, no bank conflict); each thread traces two rays
// (i and i + 256 of its block's 512), so one triangle read and one trip of
// the loop serve two tests, and the two rays' tests are independent
// chains the scheduler interleaves (for K2, two rays per thread against
// one was chosen by measurement, PERF.md). Ray columns and outputs stay
// coalesced. An MT tile is 3 float4 a triangle, copied 16 bytes at a time.
// A Woop row is 13 floats (52 bytes), so it cannot be read in place as
// float4s: its tile (K1, K2) is copied 4 bytes at a time into rows padded
// to 16 floats, read as three float4 and one float, and the table needs no
// alignment beyond a float.
//
// Every nearest hit keeps its best in registers and updates on a strict
// t < best in index order, so an exact t tie keeps the lowest index.
//
// What bounds them: at simple_box's 12 triangles a launch reads 24 bytes
// (28 with dist) and writes 16 (4) per ray, ~40 MB for 1M rays, 0.0125 ms
// at 3.35 TB/s. A test costs ~35 fp32 operations in the Woop form and ~55
// in the MT form, unfused under --fmad=false, plus the IEEE reciprocal
// (its range check, MUFU.RCP and two refinement steps), compares and
// selects; issuing those, not the bytes, sets the time (on an H100, K1 and
// K3 take ~90 and ~104 warp-instruction slots per test at 1M rays,
// PERF.md). Staging takes the triangle loads off that stream; the rest is
// the test's own arithmetic, so the tiled loops are branch-free and
// unrolled by 4: at the 4095-triangle soup's 65,536 rays a launch has 8
// warps per SM, and the time is the latency of each test's dependent
// chain, which only independent tests in flight (two rays, four
// triangles) hide. Measured on an H100 (PERF.md): a test that returns as
// soon as a conjunct of its acceptance fails, or skips the division on a
// sign test, is slower at both shapes (a warp executes the union of its
// lanes' paths, and the branches serialise the chains), so the tests are
// not cut short.
//
// The any hits (K2, K4) stop at the first blocker only where that saves
// instructions: a warp leaves the loop once all of its rays are settled
// (blocked, or past n; __all_sync), and after each tile the block votes
// (__syncthreads_and) and stops staging tiles once every ray in it is
// settled. A thread alone that stopped would save nothing: its warp runs
// its lanes all the same.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kF32Max = 3.4e38f;
constexpr float kParallelEps = 1e-4f;   // FLOAT_EQUAL, global.hpp:134-136
constexpr int kBlock = 256;
constexpr int kTile = 256;              // triangles per shared-memory tile
constexpr int kMtTileF4 = 3 * kTile;    // float4 per MT tile
constexpr int kWoopFloats = 13;         // a Woop table row
constexpr int kWoopRowF = 16;           // a staged Woop row, padded
constexpr int kRays = 2;                // rays per thread of a tiled kernel
constexpr int kVoteEvery = 4;           // K2's triangles per warp vote

struct Hit {
  float t, u, v;
  bool ok;    // accepted by Triangle.hpp:39-49; comparisons with NaN fail
};

// Woop test of one ray against one triangle: t = -w_o * (1 / w_d),
// u = (o.r1 - c1) + t (d.r1), v likewise, dn = w_d |n| = dir . n_hat.
// Accepted when not near-parallel and t, u, v, 1 - u - v > 0.
__device__ __forceinline__ Hit woop_test(
    float r1x, float r1y, float r1z, float c1, float r2x, float r2y,
    float r2z, float c2, float r3x, float r3y, float r3z, float c3,
    float nlen, float ox, float oy, float oz, float dx, float dy, float dz) {
  const float w_o = ox * r3x + oy * r3y + oz * r3z - c3;
  const float w_d = dx * r3x + dy * r3y + dz * r3z;
  const float inv = 1.0f / w_d;     // w_d == 0 -> inf/NaN, rejected below
  Hit h;
  h.t = -w_o * inv;
  h.u = (ox * r1x + oy * r1y + oz * r1z - c1) + h.t * (dx * r1x + dy * r1y + dz * r1z);
  h.v = (ox * r2x + oy * r2y + oz * r2z - c2) + h.t * (dx * r2x + dy * r2y + dz * r2z);
  const float dn = w_d * nlen;
  h.ok = (fabsf(dn) >= kParallelEps) & (h.t > 0.0f) & (h.u > 0.0f) &
         (h.v > 0.0f) & (1.0f - h.u - h.v > 0.0f);
  return h;
}

// Moller-Trumbore test in the order of _kernel: s = o - v0, s1 = d x e2,
// s2 = s x e1, det = s1 . e1, dn = d . n_hat, inv = 1 / det (unguarded:
// det == 0 gives inf/NaN), t, u, v as products with inv. Accepted as the
// Woop form, and det != 0. A triangle as three float4: v0x v0y v0z e1x |
// e1y e1z e2x e2y | e2z nux nuy nuz (K3, from shared memory).
__device__ __forceinline__ Hit mt_test(const float4& a, const float4& b,
                                       const float4& c, float ox, float oy,
                                       float oz, float dx, float dy,
                                       float dz) {
  const float v0x = a.x, v0y = a.y, v0z = a.z, e1x = a.w;
  const float e1y = b.x, e1z = b.y, e2x = b.z, e2y = b.w;
  const float e2z = c.x, nux = c.y, nuy = c.z, nuz = c.w;
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

// One ray of a tiled kernel; a ray past n is traced as zeros and not
// written.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  __device__ __forceinline__ static Ray load(
      bool live, int i, const float* __restrict__ ox,
      const float* __restrict__ oy, const float* __restrict__ oz,
      const float* __restrict__ dx, const float* __restrict__ dy,
      const float* __restrict__ dz) {
    if (!live) return Ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    return Ray{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
  }
};

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies tile `tile` of the MT table (at most kTile triangles; none past
// the last) into `dst` as 16-byte cp.async, and commits them as one group.
__device__ __forceinline__ void stage_tile(float4* dst,
                                           const float4* __restrict__ tris,
                                           int tile, int n_tris) {
  const int first = tile * kTile;
  const int n_f4 = 3 * max(0, min(kTile, n_tris - first));
  const float4* src = tris + 3 * static_cast<size_t>(first);
  for (int j = threadIdx.x; j < n_f4; j += kBlock) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     shared_addr(dst + j)),
                 "l"(src + j));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Copies tile `tile` of the Woop table into `dst` as 4-byte cp.async,
// float j of the flat tile to row j / 13, column j % 13 of rows of
// kWoopRowF floats (the padding is never read), and commits one group.
__device__ __forceinline__ void stage_woop_tile(float* dst,
                                                const float* __restrict__ tris,
                                                int tile, int n_tris) {
  const int first = tile * kTile;
  const int n_f = kWoopFloats * max(0, min(kTile, n_tris - first));
  const float* src = tris + kWoopFloats * static_cast<size_t>(first);
  for (int j = threadIdx.x; j < n_f; j += kBlock) {
    const int row = j / kWoopFloats;
    const int col = j - row * kWoopFloats;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     shared_addr(dst + row * kWoopRowF + col)),
                 "l"(src + j));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until every group but the newest has landed, then for the block.
__device__ __forceinline__ void wait_tile() {
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();
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
  __device__ __forceinline__ void store(int i, float* __restrict__ t_out,
                                        int* __restrict__ idx_out,
                                        float* __restrict__ bu_out,
                                        float* __restrict__ bv_out) const {
    t_out[i] = t;
    idx_out[i] = idx;
    bu_out[i] = u;
    bv_out[i] = v;
  }
};

// K1's test of `r` against a staged row: r1 c1 | r2 c2 | r3 c3 as float4,
// then nlen.
__device__ __forceinline__ Hit woop_row_test(const float* row, const Ray& r) {
  const float4 p1 = *reinterpret_cast<const float4*>(row);
  const float4 p2 = *reinterpret_cast<const float4*>(row + 4);
  const float4 p3 = *reinterpret_cast<const float4*>(row + 8);
  return woop_test(p1.x, p1.y, p1.z, p1.w, p2.x, p2.y, p2.z, p2.w, p3.x,
                   p3.y, p3.z, p3.w, row[12], r.ox, r.oy, r.oz, r.dx, r.dy,
                   r.dz);
}

// The any hits' test: does triangle (a, b, c), or a staged Woop row, block
// `r` short of `dist`? The form's acceptance, t < dist and the FLOAT_EQUAL
// endpoint guard (BVH.hpp:184).
__device__ __forceinline__ bool mt_blocks(const float4& a, const float4& b,
                                          const float4& c, const Ray& r,
                                          float dist) {
  const Hit h = mt_test(a, b, c, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
  return h.ok & (h.t < dist) & (fabsf(h.t - dist) >= kParallelEps);
}

__device__ __forceinline__ bool woop_blocks(const float* row, const Ray& r,
                                            float dist) {
  const Hit h = woop_row_test(row, r);
  return h.ok & (h.t < dist) & (fabsf(h.t - dist) >= kParallelEps);
}

// K1: the Woop nearest hit, two rays per thread against padded Woop tiles
// in shared memory (see the head of this file).
__global__ void __launch_bounds__(kBlock)
woop_nearest_kernel(const float* __restrict__ tris, int n_tris,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    int n, float* __restrict__ t_out,
                    int* __restrict__ idx_out, float* __restrict__ bu_out,
                    float* __restrict__ bv_out) {
  __shared__ __align__(16) float tile[2][kTile * kWoopRowF];
  const int i0 = blockIdx.x * (kRays * kBlock) + threadIdx.x;
  const int i1 = i0 + kBlock;
  const bool live0 = i0 < n, live1 = i1 < n;
  const Ray r0 = Ray::load(live0, i0, ox, oy, oz, dx, dy, dz);
  const Ray r1 = Ray::load(live1, i1, ox, oy, oz, dx, dy, dz);
  Best b0, b1;
  const int n_tiles = (n_tris + kTile - 1) / kTile;
  stage_woop_tile(tile[0], tris, 0, n_tris);
  for (int t = 0; t < n_tiles; ++t) {
    stage_woop_tile(tile[(t + 1) & 1], tris, t + 1, n_tris);
    wait_tile();
    const float* s = tile[t & 1];
    const int base = t * kTile;
    const int count = min(kTile, n_tris - base);
#pragma unroll 4
    for (int k = 0; k < count; ++k) {
      const float* row = s + k * kWoopRowF;
      b0.update(woop_row_test(row, r0), base + k);
      b1.update(woop_row_test(row, r1), base + k);
    }
    __syncthreads();
  }
  if (live0) b0.store(i0, t_out, idx_out, bu_out, bv_out);
  if (live1) b1.store(i1, t_out, idx_out, bu_out, bv_out);
}

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
  // every thread stages tiles and meets the barriers
  const int i0 = blockIdx.x * (kRays * kBlock) + threadIdx.x;
  const int i1 = i0 + kBlock;
  const bool live0 = i0 < n, live1 = i1 < n;
  const Ray r0 = Ray::load(live0, i0, ox, oy, oz, dx, dy, dz);
  const Ray r1 = Ray::load(live1, i1, ox, oy, oz, dx, dy, dz);
  Best b0, b1;
  const int n_tiles = (n_tris + kTile - 1) / kTile;
  stage_tile(tile[0], tris, 0, n_tris);
  for (int t = 0; t < n_tiles; ++t) {
    // the next tile in flight (an empty group past the last); tile t's
    // group is then the only one that must have landed
    stage_tile(tile[(t + 1) & 1], tris, t + 1, n_tris);
    wait_tile();
    const float4* s = tile[t & 1];
    const int base = t * kTile;
    const int count = min(kTile, n_tris - base);
    for (int k = 0; k < count; ++k) {
      const float4 a = s[3 * k], b = s[3 * k + 1], c = s[3 * k + 2];
      b0.update(mt_test(a, b, c, r0.ox, r0.oy, r0.oz, r0.dx, r0.dy, r0.dz),
                base + k);
      b1.update(mt_test(a, b, c, r1.ox, r1.oy, r1.oz, r1.dx, r1.dy, r1.dz),
                base + k);
    }
    // every thread is done with tile t before the next stage overwrites it
    __syncthreads();
  }
  if (live0) b0.store(i0, t_out, idx_out, bu_out, bv_out);
  if (live1) b1.store(i1, t_out, idx_out, bu_out, bv_out);
}

// K4: the MT any hit, two rays per thread against triangle tiles in shared
// memory, with the per-warp and per-block exits (see the head of this
// file).
__global__ void __launch_bounds__(kBlock)
mt_anyhit_kernel(const float4* __restrict__ tris, int n_tris,
                 const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const float* __restrict__ dist, int n,
                 int* __restrict__ hit_out) {
  __shared__ float4 tile[2][kMtTileF4];
  const int i0 = blockIdx.x * (kRays * kBlock) + threadIdx.x;
  const int i1 = i0 + kBlock;
  const bool live0 = i0 < n, live1 = i1 < n;
  const Ray r0 = Ray::load(live0, i0, ox, oy, oz, dx, dy, dz);
  const Ray r1 = Ray::load(live1, i1, ox, oy, oz, dx, dy, dz);
  const float dist0 = live0 ? dist[i0] : 0.0f;
  const float dist1 = live1 ? dist[i1] : 0.0f;
  // settled: blocked, or past n
  bool done0 = !live0, done1 = !live1;
  const int n_tiles = (n_tris + kTile - 1) / kTile;
  stage_tile(tile[0], tris, 0, n_tris);
  for (int t = 0; t < n_tiles; ++t) {
    stage_tile(tile[(t + 1) & 1], tris, t + 1, n_tris);
    wait_tile();
    const float4* s = tile[t & 1];
    const int count = min(kTile, n_tris - t * kTile);
#pragma unroll 4
    for (int k = 0; k < count; ++k) {
      if (__all_sync(0xffffffffu, done0 & done1)) break;
      const float4 a = s[3 * k], b = s[3 * k + 1], c = s[3 * k + 2];
      done0 |= mt_blocks(a, b, c, r0, dist0);
      done1 |= mt_blocks(a, b, c, r1, dist1);
    }
    // the barrier before the next stage overwrites tile t, and the vote:
    // once every ray of the block is settled, no further tile is staged
    if (__syncthreads_and(done0 & done1)) break;
  }
  // an exit leaves the next tile's group in flight: let it land first
  asm volatile("cp.async.wait_all;\n" ::);
  if (live0) hit_out[i0] = done0;
  if (live1) hit_out[i1] = done1;
}

// K2: the Woop any hit, two rays per thread (i and i + 256 of its block's
// 512) against K1's padded Woop tiles, with K4's per-warp and per-block
// exits (see the head of this file), the warp's vote taken once per
// kVoteEvery triangles.
__global__ void __launch_bounds__(kBlock)
woop_anyhit_kernel(const float* __restrict__ tris, int n_tris,
                   const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ dist, int n,
                   int* __restrict__ hit_out) {
  __shared__ __align__(16) float tile[2][kTile * kWoopRowF];
  const int first = blockIdx.x * (kRays * kBlock) + threadIdx.x;
  Ray r[kRays];
  float d[kRays];
  bool done[kRays];    // settled: blocked, or past n
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = first + j * kBlock;
    r[j] = Ray::load(i < n, i, ox, oy, oz, dx, dy, dz);
    d[j] = i < n ? dist[i] : 0.0f;
    done[j] = i >= n;
  }
  const int n_tiles = (n_tris + kTile - 1) / kTile;
  stage_woop_tile(tile[0], tris, 0, n_tris);
  for (int t = 0; t < n_tiles; ++t) {
    stage_woop_tile(tile[(t + 1) & 1], tris, t + 1, n_tris);
    wait_tile();
    const float* s = tile[t & 1];
    const int count = min(kTile, n_tris - t * kTile);
    bool settled = false;
    // the warp votes once per kVoteEvery triangles; a step past the
    // tile's last triangle tests the last one again, which changes no
    // any hit
#pragma unroll 1
    for (int k = 0; k < count; k += kVoteEvery) {
      settled = true;
#pragma unroll
      for (int j = 0; j < kRays; ++j) settled &= done[j];
      if (__all_sync(0xffffffffu, settled)) break;
#pragma unroll
      for (int u = 0; u < kVoteEvery; ++u) {
        const float* row = s + min(k + u, count - 1) * kWoopRowF;
#pragma unroll
        for (int j = 0; j < kRays; ++j)
          done[j] |= woop_blocks(row, r[j], d[j]);
      }
    }
    settled = true;
#pragma unroll
    for (int j = 0; j < kRays; ++j) settled &= done[j];
    // the barrier before the next stage overwrites tile t, and the vote
    if (__syncthreads_and(settled)) break;
  }
  // an exit leaves the next tile's group in flight: let it land first
  asm volatile("cp.async.wait_all;\n" ::);
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = first + j * kBlock;
    if (i < n) hit_out[i] = done[j];
  }
}

int tiled_grid(int n) { return (n + kRays * kBlock - 1) / (kRays * kBlock); }

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int woop_nearest(const float* tris, int n_tris, const float* ox,
                            const float* oy, const float* oz, const float* dx,
                            const float* dy, const float* dz, int n, float* t_out,
                            int* idx_out, float* bu_out, float* bv_out,
                            void* stream) {
  woop_nearest_kernel<<<tiled_grid(n), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tris, n_tris, ox, oy, oz, dx, dy, dz, n, t_out, idx_out, bu_out,
      bv_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int woop_anyhit(const float* tris, int n_tris, const float* ox,
                           const float* oy, const float* oz, const float* dx,
                           const float* dy, const float* dz, const float* dist,
                           int n, int* hit_out, void* stream) {
  woop_anyhit_kernel<<<tiled_grid(n), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      tris, n_tris, ox, oy, oz, dx, dy, dz, dist, n, hit_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mt_nearest(const float* tris, int n_tris, const float* ox,
                          const float* oy, const float* oz, const float* dx,
                          const float* dy, const float* dz, int n, float* t_out,
                          int* idx_out, float* bu_out, float* bv_out,
                          void* stream) {
  mt_nearest_kernel<<<tiled_grid(n), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tris), n_tris, ox, oy, oz, dx, dy, dz,
      n, t_out, idx_out, bu_out, bv_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mt_anyhit(const float* tris, int n_tris, const float* ox,
                         const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz, const float* dist,
                         int n, int* hit_out, void* stream) {
  mt_anyhit_kernel<<<tiled_grid(n), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tris), n_tris, ox, oy, oz, dx, dy, dz,
      dist, n, hit_out);
  return static_cast<int>(cudaGetLastError());
}
