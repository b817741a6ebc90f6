// The visit-list walk probe on Hopper.
//
// Replaces the Pallas TPU prototype tools/proto_visit.py::kernel, a feature
// probe of the mechanisms a redesigned cluster intersector needs: per-tile
// visit lists of clusters, cluster rows staged in fast memory one group at
// a time, and a tile-wide early exit. The contract is what the Pallas kernel
// computes on every lane, live or dead:
//
// - a tile is 1024 rays; it walks its own visit list (vlist cluster ids,
//   ventry entry distances, NC entries each) in groups of G = 4 clusters,
//   positions clamped to NC - 1;
// - a cluster whose entry is >= SENTINEL (3e37) is skipped;
// - each of a cluster's 64 planes (Woop row slots 8-11: r3, c3) is tested
//   as t = -w_o / w_d, a true division, and accepted when |w_d| >= 1e-6,
//   t > 0 and t < t_best (so the first plane at the least t wins); its idx
//   is cid * 64 + k;
// - after each group t_lim = min(t_lim, max over the tile of
//   (live ? t_best : 0)), and the walk goes on while s < NC / G and
//   ventry[s * G] < t_lim.
//
// Design: one CTA of 1024 threads per tile, one thread per ray. The CTA
// stages the group's 4 x 64 planes (4 KB) in shared memory, one float per
// thread, then every thread tests them from there (broadcast reads). The
// tile-wide max is a warp shuffle reduction and a shared-memory pass over
// the 32 warps; every thread then holds the same t_lim, so the exit test is
// uniform across the CTA. Built with --fmad=false, the arithmetic is that
// of the plain PyTorch version (tuturenderer_tpu_torch/tools/proto_visit.py)
// step for step.
//
// What bounds it: the plane tests, ~12 fp32 operations each, at up to
// NC * 64 tests per ray on a full walk; the ray and visit-list bytes are
// small beside them. The TPU probe double-buffers the rows with async DMA;
// here the loads are plain (cp.async or TMA double buffering is later
// work), and only one CTA per tile runs, so a launch of 64 tiles fills 64
// of the card's 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr float kF32Max = 3.4e38f;
constexpr float kSentinel = 3.0e37f;
constexpr int kTile = 1024;       // rays per tile (8 x 128 on the TPU)
constexpr int kG = 4;             // clusters per group
constexpr int kCS = 64;           // planes (triangles) per cluster
constexpr int kWF = 14;           // floats per Woop row
constexpr int kRow = 1024;        // floats per cluster row (8 x 128)
constexpr int kWarps = kTile / 32;

static_assert(kG * kCS * 4 == kTile, "one staged float per thread");

__global__ void __launch_bounds__(kTile)
visit_walk_kernel(const int* __restrict__ vlist,
                  const float* __restrict__ ventry,
                  const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ live,
                  const float* __restrict__ woop, int nc,
                  float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float planes[kG][kCS][4];    // r3x r3y r3z c3
  __shared__ float warp_max[kWarps];
  __shared__ float tile_max;

  const int tid = threadIdx.x;
  const int i = blockIdx.x * kTile + tid;
  const int* vl = vlist + static_cast<size_t>(blockIdx.x) * nc;
  const float* ve = ventry + static_cast<size_t>(blockIdx.x) * nc;
  const float rox = ox[i], roy = oy[i], roz = oz[i];
  const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
  const bool lv = live[i] > 0.0f;

  float t_best = kF32Max;
  int idx_best = -1;
  float t_lim = kF32Max;          // the same value in every thread
  const int ng = nc / kG;
  for (int s = 0; s < ng && ve[min(s * kG, nc - 1)] < t_lim; ++s) {
    {
      const int g = tid / (kCS * 4);
      const int k = (tid / 4) % kCS;
      const int j = tid % 4;
      const int cid = vl[min(s * kG + g, nc - 1)];
      planes[g][k][j] =
          woop[static_cast<size_t>(cid) * kRow + k * kWF + 8 + j];
    }
    __syncthreads();
    for (int g = 0; g < kG; ++g) {
      const int p = min(s * kG + g, nc - 1);
      const bool valid = ve[p] < kSentinel;
      const int cid = vl[p];
      for (int k = 0; k < kCS; ++k) {
        const float r3x = planes[g][k][0], r3y = planes[g][k][1];
        const float r3z = planes[g][k][2], c3 = planes[g][k][3];
        const float w_o = rox * r3x + roy * r3y + roz * r3z - c3;
        const float w_d = rdx * r3x + rdy * r3y + rdz * r3z;
        const float t = -w_o / w_d;
        if (valid && fabsf(w_d) >= 1e-6f && t > 0.0f && t < t_best) {
          t_best = t;
          idx_best = cid * kCS + k;
        }
      }
    }
    // t_lim = min(t_lim, max over the tile of (live ? t_best : 0))
    float m = lv ? t_best : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (tid % 32 == 0) warp_max[tid / 32] = m;
    __syncthreads();
    if (tid < 32) {
      m = warp_max[tid];
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (tid == 0) tile_max = m;
    }
    __syncthreads();
    t_lim = fminf(t_lim, tile_max);
  }
  t_out[i] = t_best;
  idx_out[i] = idx_best;
}

}  // namespace

// C entry point, bound with ctypes: n_tiles CTAs of 1024 threads. Launches
// on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int visit_walk(const int* vlist, const float* ventry,
                          const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* live, const float* woop, int nc,
                          int n_tiles, float* t_out, int* idx_out,
                          void* stream) {
  visit_walk_kernel<<<n_tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      vlist, ventry, ox, oy, oz, dx, dy, dz, live, woop, nc, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
