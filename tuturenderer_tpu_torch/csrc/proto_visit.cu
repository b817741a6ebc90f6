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
// Design: a tile is a thread block cluster of kCtas = 2 CTAs of 512
// threads, one ray per thread, so a launch of 64 tiles puts 128 CTAs on
// the card's 132 SMs. Each CTA stages a group's
// 4 x 64 planes (4 KB) in shared memory by 4-byte cp.async, the next
// group in flight while the current one is tested (the prefetch may fetch
// a group the exit then skips: the CTA waits for it before leaving), and
// every thread tests them from there (broadcast float4 reads). A cluster
// whose entry is a sentinel is skipped on a branch that every thread of
// the tile takes alike. A test that |w_d| >= 1e-6 rejects divides 1 by 1:
// the IEEE division's range check sends a zero or subnormal dividend or
// divisor to its slow path (on an H100, 0 / 0 and +-0 / 1 alike: the
// full walk's zero rows took 12-14 ms that way, PERF.md), and an accepted
// test divides -w_o by w_d as before, as the plain version does. Four
// planes' tests are written together (distances, then divisions, then
// updates), so their chains overlap, and the running best is updated by
// selects. After each group every CTA reduces its rays' maximum (warp
// shuffles, then shared memory) and the cluster exchanges the kCtas
// partial maxima through distributed shared memory, so every thread of
// the tile holds the same t_lim and the exit is uniform; fmaxf is
// order-free, so t and idx are those of the one-CTA walk. (Clusters of 4
// CTAs and two rays per thread were measured slower, PERF.md.) Built with
// --fmad=false, the arithmetic is that of the plain PyTorch version
// (tuturenderer_tpu_torch/tools/proto_visit.py) step for step.
//
// What bounds it: the plane tests, 12 fp32 operations each, at up to
// NC * 64 tests per ray on a full walk; the ray and visit-list bytes are
// small beside them. Under --fmad=false each operation is an instruction,
// and the IEEE division adds its range check, MUFU.RCP and refinement, so
// issuing instructions sets the floor (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kF32Max = 3.4e38f;
constexpr float kSentinel = 3.0e37f;
constexpr float kMinWd = 1e-6f;   // |w_d| below it: parallel to the plane
constexpr int kTile = 1024;       // rays per tile (8 x 128 on the TPU)
constexpr int kG = 4;             // clusters per group
constexpr int kCS = 64;           // planes (triangles) per cluster
constexpr int kWF = 14;           // floats per Woop row
constexpr int kRow = 1024;        // floats per cluster row (8 x 128)
constexpr int kGroupF = kG * kCS * 4;   // floats staged per group
constexpr int kCtas = 2;          // CTAs per tile (a thread block cluster)
constexpr int kBatch = 4;         // planes whose tests are written together
constexpr int kThreads = kTile / kCtas;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies group s's planes (r3x r3y r3z c3 of plane k of its cluster g, at
// dst[(g * 64 + k) * 4 + slot]) by 4-byte cp.async and commits them as one
// group; past the last group it commits an empty one.
__device__ __forceinline__ void stage_group(float* dst,
                                            const int* __restrict__ vl,
                                            const float* __restrict__ woop,
                                            int s, int nc) {
  if (s < nc / kG) {
    for (int j = threadIdx.x; j < kGroupF; j += kThreads) {
      const int g = j / (kCS * 4);
      const int k = (j / 4) % kCS;
      const int cid = vl[min(s * kG + g, nc - 1)];
      const float* src =
          woop + static_cast<size_t>(cid) * kRow + k * kWF + 8 + j % 4;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       shared_addr(dst + j)),
                   "l"(src));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  bool live;
  float t_best = kF32Max;
  int idx_best = -1;

  // planes q[0..kBatch) (r3, c3), idx id0 + u: the kBatch tests' plane
  // distances first, then their divisions, then the updates in order, so
  // the independent chains overlap (each division is a branch region of
  // its own: its range check may call the slow path). t = -w_o / w_d
  // where |w_d| >= 1e-6, else 1 / 1: the range check passes a zero or
  // subnormal operand to the slow path, so neither reaches it on a test
  // that is rejected anyway.
  __device__ __forceinline__ void test(const float4* q, int id0) {
    float num[kBatch], den[kBatch], t[kBatch];
    bool crosses[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float w_o = ox * q[u].x + oy * q[u].y + oz * q[u].z - q[u].w;
      const float w_d = dx * q[u].x + dy * q[u].y + dz * q[u].z;
      crosses[u] = fabsf(w_d) >= kMinWd;   // false for NaN
      num[u] = crosses[u] ? -w_o : 1.0f;
      den[u] = crosses[u] ? w_d : 1.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) t[u] = num[u] / den[u];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool ok = crosses[u] & (t[u] > 0.0f) & (t[u] < t_best);
      t_best = ok ? t[u] : t_best;
      idx_best = ok ? id0 + u : idx_best;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
visit_walk_kernel(const int* __restrict__ vlist,
                  const float* __restrict__ ventry,
                  const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ live,
                  const float* __restrict__ woop, int nc,
                  float* __restrict__ t_out, int* __restrict__ idx_out,
                  int* __restrict__ sm_out) {
  __shared__ __align__(16) float planes[2][kGroupF];
  __shared__ float warp_max[kWarps];
  __shared__ float part[2];     // this CTA's maximum, by group parity

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int tile = blockIdx.x / kCtas;
  const int first = tile * kTile +
                    static_cast<int>(cluster.block_rank()) * kThreads + tid;
  const int* vl = vlist + static_cast<size_t>(tile) * nc;
  const float* ve = ventry + static_cast<size_t>(tile) * nc;
  Ray r;
  r.ox = ox[first];
  r.oy = oy[first];
  r.oz = oz[first];
  r.dx = dx[first];
  r.dy = dy[first];
  r.dz = dz[first];
  r.live = live[first] > 0.0f;

  float t_lim = kF32Max;          // the same value in every thread
  const int ng = nc / kG;
  stage_group(planes[0], vl, woop, 0, nc);
  for (int s = 0; s < ng && ve[min(s * kG, nc - 1)] < t_lim; ++s) {
    // group s + 1 in flight; group s's copies are then the only ones that
    // must have landed
    stage_group(planes[(s + 1) & 1], vl, woop, s + 1, nc);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float4* q = reinterpret_cast<const float4*>(planes[s & 1]);
    for (int g = 0; g < kG; ++g) {
      const int p = min(s * kG + g, nc - 1);
      if (!(ve[p] < kSentinel)) continue;     // alike for the whole tile
      const int base = vl[p] * kCS;
#pragma unroll 1
      for (int k = 0; k < kCS; k += kBatch) r.test(q + g * kCS + k, base + k);
    }
    // t_lim = min(t_lim, max over the tile of (live ? t_best : 0)): this
    // CTA's maximum, then the cluster's over the kCtas partial maxima
    float m = r.live ? r.t_best : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (tid % 32 == 0) warp_max[tid / 32] = m;
    __syncthreads();
    if (tid < 32) {
      m = tid < kWarps ? warp_max[tid] : 0.0f;
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (tid == 0) part[s & 1] = m;
    }
    // every CTA's part[s & 1] written (and, for the parity's next use at
    // s + 2, read: the sync of group s + 1 lies between)
    cluster.sync();
    float tile_max = 0.0f;
#pragma unroll
    for (int c = 0; c < kCtas; ++c)
      tile_max = fmaxf(tile_max, *cluster.map_shared_rank(&part[s & 1], c));
    t_lim = fminf(t_lim, tile_max);
  }
  // the last prefetch may still be in flight, and a CTA of the cluster may
  // still read this one's part: both end before it leaves
  asm volatile("cp.async.wait_all;\n" ::);
  cluster.sync();
  t_out[first] = r.t_best;
  idx_out[first] = r.idx_best;
  if (sm_out != nullptr && tid == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    sm_out[blockIdx.x] = static_cast<int>(sm);
  }
}

int launch(const int* vlist, const float* ventry, const float* ox,
           const float* oy, const float* oz, const float* dx, const float* dy,
           const float* dz, const float* live, const float* woop, int nc,
           int n_tiles, float* t_out, int* idx_out, int* sm_out,
           void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, visit_walk_kernel, vlist, ventry, ox, oy, oz, dx, dy, dz, live,
      woop, nc, t_out, idx_out, sm_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes: n_tiles clusters of kCtas CTAs. Each
// launches on `stream`, does not synchronise, and returns the launch's
// error (0 on success; a refused cluster launch is an error).
extern "C" int visit_walk(const int* vlist, const float* ventry,
                          const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* live, const float* woop, int nc,
                          int n_tiles, float* t_out, int* idx_out,
                          void* stream) {
  return launch(vlist, ventry, ox, oy, oz, dx, dy, dz, live, woop, nc,
                n_tiles, t_out, idx_out, nullptr, stream);
}

// visit_walk, also writing the SM each CTA ran on to sm_out
// [n_tiles * visit_walk_ctas()].
extern "C" int visit_walk_sm_ids(const int* vlist, const float* ventry,
                                 const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const float* live, const float* woop,
                                 int nc, int n_tiles, float* t_out,
                                 int* idx_out, int* sm_out, void* stream) {
  return launch(vlist, ventry, ox, oy, oz, dx, dy, dz, live, woop, nc,
                n_tiles, t_out, idx_out, sm_out, stream);
}

extern "C" int visit_walk_ctas() { return kCtas; }
