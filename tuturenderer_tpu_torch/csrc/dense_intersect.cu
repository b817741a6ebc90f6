// Dense ray/triangle intersection on Hopper: nearest hit and any hit.
//
// Replaces the two Pallas TPU kernels of the dense path tracer,
// tuturenderer_tpu/ops/pallas/intersect.py::_kernel_woop (nearest hit) and
// ::_kernel_woop_anyhit (shadow-ray any hit). Same contract, same Woop
// arithmetic in the same order of operations (reciprocal then multiply,
// 1 - u - v): built with --fmad=false, so no multiply-add is contracted and
// each result is the one the plain PyTorch version
// (ops/cuda/intersect.py) computes.
//
// Triangle table: flat float32 [T * 13], per triangle
//   r1(3) c1 r2(3) c2 r3(3) c3 nlen
// the rows of the inverse [e1 e2 n] basis, c_k = r_k . v0 and |n|,
// factorised in float64 on the host. Rays: six float32 [N] columns.
//
// Design: one thread per ray, a loop over the T triangles in index order.
// Triangle i is read with uniform-index __ldg loads; every thread of a warp
// reads the same address, so each is a broadcast served from L1. The best
// hit lives in registers and updates on a strict t < best, so an exact t
// tie keeps the lowest index. The any-hit thread returns at its first
// accepted triangle.
//
// What bounds it: at simple_box's 12 triangles a launch reads 24 bytes
// (28 with dist) and writes 16 (4) per ray for ~35 flops per triangle, so
// it is bound by ray I/O: ~45 MB for 1M rays. Near the dense limit of 4095
// triangles it is bound by fp32 instruction throughput. Triangle tiles in
// shared memory and a per-block early exit (__syncthreads_and) are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr float kF32Max = 3.4e38f;
constexpr float kParallelEps = 1e-4f;   // FLOAT_EQUAL, global.hpp:134-136
constexpr int kTriFloats = 13;
constexpr int kBlock = 256;

struct WoopHit {
  float t, u, v, dn;
};

// Woop test of one ray against triangle `tri`: t = -w_o * (1 / w_d),
// u = (o.r1 - c1) + t (d.r1), v likewise, dn = w_d |n| = dir . n_hat.
__device__ __forceinline__ WoopHit woop_test(const float* __restrict__ tri,
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
  WoopHit h;
  h.t = -w_o * inv;
  h.u = (ox * r1x + oy * r1y + oz * r1z - c1) + h.t * (dx * r1x + dy * r1y + dz * r1z);
  h.v = (ox * r2x + oy * r2y + oz * r2z - c2) + h.t * (dx * r2x + dy * r2y + dz * r2z);
  h.dn = w_d * nlen;
  return h;
}

// Acceptance of Triangle.hpp:39-49: not near-parallel, t, u, v and
// 1 - u - v strictly positive. Comparisons with NaN are false.
__device__ __forceinline__ bool accepted(const WoopHit& h) {
  return fabsf(h.dn) >= kParallelEps && h.t > 0.0f && h.u > 0.0f &&
         h.v > 0.0f && 1.0f - h.u - h.v > 0.0f;
}

__global__ void __launch_bounds__(kBlock)
woop_nearest_kernel(const float* __restrict__ tris, int n_tris,
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
    const WoopHit h = woop_test(tris + k * kTriFloats, rox, roy, roz, rdx, rdy, rdz);
    if (accepted(h) && h.t < t_best) {
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

__global__ void __launch_bounds__(kBlock)
woop_anyhit_kernel(const float* __restrict__ tris, int n_tris,
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
    const WoopHit h = woop_test(tris + k * kTriFloats, rox, roy, roz, rdx, rdy, rdz);
    // t < dist with the FLOAT_EQUAL endpoint guard (BVH.hpp:184)
    if (accepted(h) && h.t < rdist && fabsf(h.t - rdist) >= kParallelEps) {
      blocked = 1;
      break;
    }
  }
  hit_out[i] = blocked;
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int woop_nearest(const float* tris, int n_tris, const float* ox,
                            const float* oy, const float* oz, const float* dx,
                            const float* dy, const float* dz, int n, float* t_out,
                            int* idx_out, float* bu_out, float* bv_out,
                            void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  woop_nearest_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tris, n_tris, ox, oy, oz, dx, dy, dz, n, t_out, idx_out, bu_out, bv_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int woop_anyhit(const float* tris, int n_tris, const float* ox,
                           const float* oy, const float* oz, const float* dx,
                           const float* dy, const float* dz, const float* dist,
                           int n, int* hit_out, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  woop_anyhit_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tris, n_tris, ox, oy, oz, dx, dy, dz, dist, n, hit_out);
  return static_cast<int>(cudaGetLastError());
}
