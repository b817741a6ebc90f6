// Mesh-scale ray/triangle intersection on Hopper: one thread per ray walks a
// binary tree over the cluster tables, for the nearest hit, the shadow any
// hit and the alpha-weighted shadow transmittance.
//
// Replaces the three Pallas TPU walk kernels of
// tuturenderer_tpu/ops/pallas/cluster.py: _kernel_nearest (K5),
// _kernel_anyhit (K6) and _kernel_transmit (K7), all three bodies of
// _walk_kernel. The TPU kernel reduces a 1024-ray tile to a beam, builds a
// sorted per-tile visit list of clusters in XLA, double-buffers cluster
// tiles into SMEM by DMA and exits the list at a tile-wide limit. None of
// that is needed here: a Hopper thread traces its own ray. What is kept is
// what the kernels compute:
//
//   K5: K1's contract over every triangle of the table: the nearest t with
//       |w_d| >= 1e-4, t > 0, u > 0, v > 0, 1 - u - v > 0, and its
//       original triangle id (tri_idx), -1 on a miss;
//   K6: K2's contract: any such hit with t < dist and |t - dist| >= 1e-4;
//   K7: the product of (1 - alpha) (row slot 13) over every such hit with
//       t < dist, no endpoint guard, no early exit.
//
// Tables (ops/cluster.py): woop [C, 8, 128] f32, 64 rows of 14 floats per
// cluster, r1(3) c1 r2(3) c2 r3'(3) c3' nlen alpha, with the r3/c3 row
// prescaled by |n| so w_d = d . r3' is dir . n_hat and the parallel test
// reads it directly (unlike K1, which multiplies by nlen); tri_idx [C, 64]
// i32, -1 in the padding; node_box [K, 8] f32 padded lo(3) hi(3), and
// node_link [K, 2] i32: the children of an inner node, or (-1 - cluster, -1)
// for a leaf; node 0 is the root.
//
// Traversal: a stack of (node, entry) in local memory, nearer child on top.
// A node is entered when the slab test of the JAX gate (cluster.py:374-393,
// 1 / (c == 0 ? 1e-30 : c)) gives tmin <= tmax, tmax >= 0 and
// tmin < bound; a popped node is skipped once its entry is no longer below
// the bound. The bound is the best t so far for K5 and dist for K6/K7. The
// node boxes are padded outward on the host, so rounding in the slab test
// never culls a hit that the dense test accepts. At a leaf the thread tests
// the cluster's real rows (tri_idx >= 0) in row order.
//
// Agreement: built with --fmad=false, the triangle test rounds every step
// as the plain PyTorch versions do (ops/cuda/cluster.py), so t and the
// barycentrics are bit-equal to theirs and the K6 masks equal. The visiting
// order differs from the plain versions' row order, so an exact t tie may
// keep another index (K5), and K7's product is taken in another order.
//
// What bounds it: per ray it reads 24 bytes (28 with dist) and writes 16
// (4), and does ~30 flops per ray/triangle test plus ~20 per node; at
// tens of tests per ray the byte and operation bounds are about equal
// (chip_smoke.py prints both). What holds it far above either is the walk
// itself: dependent node and row loads, lanes of a warp walking different
// nodes and leaving at different times, and the stack in local memory.
// Shared-memory staging of clusters, warp-coherent traversal and ray
// sorting are later work.
//
// `tests` (may be null) counts the ray/triangle tests made, one atomic add
// per thread: a diagnostic for the bound's operation count, off on the main
// path.

#include <cuda_runtime.h>

namespace {

constexpr float kF32Max = 3.4e38f;
constexpr float kParallelEps = 1e-4f;   // FLOAT_EQUAL, global.hpp:134-136
constexpr int kClusterSize = 64;
constexpr int kWoopF = 14;
constexpr int kClusterFloats = 8 * 128;
constexpr int kStack = 64;              // ops/cluster.py TREE_STACK
constexpr int kBlock = 128;

enum Mode { kNearest = 0, kAnyHit = 1, kTransmit = 2 };

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float inv_dir(float c) {
  return 1.0f / (c == 0.0f ? 1e-30f : c);
}

// Slab test of a padded node box; *entry = tmin.
__device__ __forceinline__ bool slab(const float* __restrict__ box,
                                     const Ray& r, float bound,
                                     float* entry) {
  const float t0x = (__ldg(box + 0) - r.ox) * r.ix;
  const float t1x = (__ldg(box + 3) - r.ox) * r.ix;
  const float t0y = (__ldg(box + 1) - r.oy) * r.iy;
  const float t1y = (__ldg(box + 4) - r.oy) * r.iy;
  const float t0z = (__ldg(box + 2) - r.oz) * r.iz;
  const float t1z = (__ldg(box + 5) - r.oz) * r.iz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z));
  *entry = tmin;
  return tmin <= tmax && tmax >= 0.0f && tmin < bound;
}

struct TriHit {
  float t, u, v, wd;
};

// The 12-value test of cluster.py:269-283, in its order of operations.
__device__ __forceinline__ TriHit woop_test(const float* __restrict__ row,
                                            const Ray& r) {
  const float r1x = __ldg(row + 0), r1y = __ldg(row + 1), r1z = __ldg(row + 2);
  const float c1 = __ldg(row + 3);
  const float r2x = __ldg(row + 4), r2y = __ldg(row + 5), r2z = __ldg(row + 6);
  const float c2 = __ldg(row + 7);
  const float r3x = __ldg(row + 8), r3y = __ldg(row + 9), r3z = __ldg(row + 10);
  const float c3 = __ldg(row + 11);
  const float w_o = r.ox * r3x + r.oy * r3y + r.oz * r3z - c3;
  const float w_d = r.dx * r3x + r.dy * r3y + r.dz * r3z;
  const float inv = 1.0f / w_d;     // w_d == 0 -> inf/NaN, rejected below
  TriHit h;
  h.t = -w_o * inv;
  h.u = (r.ox * r1x + r.oy * r1y + r.oz * r1z - c1) +
        h.t * (r.dx * r1x + r.dy * r1y + r.dz * r1z);
  h.v = (r.ox * r2x + r.oy * r2y + r.oz * r2z - c2) +
        h.t * (r.dx * r2x + r.dy * r2y + r.dz * r2z);
  h.wd = w_d;
  return h;
}

// Triangle.hpp:39-49; comparisons with NaN are false.
__device__ __forceinline__ bool accepted(const TriHit& h) {
  return fabsf(h.wd) >= kParallelEps && h.t > 0.0f && h.u > 0.0f &&
         h.v > 0.0f && 1.0f - h.u - h.v > 0.0f;
}

struct Tables {
  const float* node_box;
  const int* node_link;
  const float* woop;
  const int* tri_idx;
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *dist;
};

template <int kMode>
__global__ void __launch_bounds__(kBlock)
cluster_walk_kernel(Tables tab, Rays rays, int n, float* __restrict__ t_out,
                    int* __restrict__ idx_out, float* __restrict__ bu_out,
                    float* __restrict__ bv_out, int* __restrict__ hit_out,
                    float* __restrict__ trans_out,
                    unsigned long long* __restrict__ tests) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = rays.ox[i];
  r.oy = rays.oy[i];
  r.oz = rays.oz[i];
  r.dx = rays.dx[i];
  r.dy = rays.dy[i];
  r.dz = rays.dz[i];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  const float rdist = kMode == kNearest ? kF32Max : rays.dist[i];
  float bound = rdist;

  float t_best = kF32Max, bu = 0.0f, bv = 0.0f;
  int virt = -1;
  int blocked = 0;
  float trans = 1.0f;
  unsigned long long n_tests = 0;

  int stack_node[kStack];
  float stack_entry[kStack];
  int sp = 0;
  float entry;
  if (slab(tab.node_box, r, bound, &entry)) {
    stack_node[0] = 0;
    stack_entry[0] = entry;
    sp = 1;
  }
  while (sp > 0) {
    --sp;
    if (!(stack_entry[sp] < bound)) continue;
    const int node = stack_node[sp];
    const int a = __ldg(tab.node_link + 2 * node);
    const int b = __ldg(tab.node_link + 2 * node + 1);
    if (a < 0) {
      const int cid = -1 - a;
      const float* rows = tab.woop + static_cast<size_t>(cid) * kClusterFloats;
      const int* ids = tab.tri_idx + static_cast<size_t>(cid) * kClusterSize;
      for (int k = 0; k < kClusterSize; ++k) {
        if (__ldg(ids + k) < 0) continue;
        ++n_tests;
        const TriHit h = woop_test(rows + k * kWoopF, r);
        if (!accepted(h)) continue;
        if (kMode == kNearest) {
          if (h.t < t_best) {
            t_best = h.t;
            virt = cid * kClusterSize + k;
            bu = h.u;
            bv = h.v;
          }
        } else if (kMode == kAnyHit) {
          // t < dist with the FLOAT_EQUAL endpoint guard (BVH.hpp:184)
          if (h.t < rdist && fabsf(h.t - rdist) >= kParallelEps) {
            blocked = 1;
            break;
          }
        } else if (h.t < rdist) {
          trans *= 1.0f - __ldg(rows + k * kWoopF + 13);
        }
      }
      if (kMode == kNearest) bound = t_best;
      if (kMode == kAnyHit && blocked) break;
    } else {
      float ea, eb;
      const bool ha = slab(tab.node_box + 8 * a, r, bound, &ea);
      const bool hb = slab(tab.node_box + 8 * b, r, bound, &eb);
      if (ha && hb) {
        const bool a_near = ea <= eb;     // farther child pushed first
        stack_node[sp] = a_near ? b : a;
        stack_entry[sp] = a_near ? eb : ea;
        ++sp;
        stack_node[sp] = a_near ? a : b;
        stack_entry[sp] = a_near ? ea : eb;
        ++sp;
      } else if (ha || hb) {
        stack_node[sp] = ha ? a : b;
        stack_entry[sp] = ha ? ea : eb;
        ++sp;
      }
    }
  }

  if (kMode == kNearest) {
    t_out[i] = t_best;
    idx_out[i] = virt >= 0 ? __ldg(tab.tri_idx + virt) : -1;
    bu_out[i] = bu;
    bv_out[i] = bv;
  } else if (kMode == kAnyHit) {
    hit_out[i] = blocked;
  } else {
    trans_out[i] = trans;
  }
  if (tests != nullptr) atomicAdd(tests, n_tests);
}

template <int kMode>
int launch(Tables tab, Rays rays, int n, float* t_out, int* idx_out,
           float* bu_out, float* bv_out, int* hit_out, float* trans_out,
           unsigned long long* tests, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  cluster_walk_kernel<kMode><<<grid, kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      tab, rays, n, t_out, idx_out, bu_out, bv_out, hit_out, trans_out, tests);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int cluster_nearest(const float* node_box, const int* node_link,
                               const float* woop, const int* tri_idx,
                               const float* ox, const float* oy,
                               const float* oz, const float* dx,
                               const float* dy, const float* dz, int n,
                               float* t_out, int* idx_out, float* bu_out,
                               float* bv_out, unsigned long long* tests,
                               void* stream) {
  const Tables tab{node_box, node_link, woop, tri_idx};
  const Rays rays{ox, oy, oz, dx, dy, dz, nullptr};
  return launch<kNearest>(tab, rays, n, t_out, idx_out, bu_out, bv_out,
                          nullptr, nullptr, tests, stream);
}

extern "C" int cluster_anyhit(const float* node_box, const int* node_link,
                              const float* woop, const int* tri_idx,
                              const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const float* dist, int n, int* hit_out,
                              unsigned long long* tests, void* stream) {
  const Tables tab{node_box, node_link, woop, tri_idx};
  const Rays rays{ox, oy, oz, dx, dy, dz, dist};
  return launch<kAnyHit>(tab, rays, n, nullptr, nullptr, nullptr, nullptr,
                         hit_out, nullptr, tests, stream);
}

extern "C" int cluster_transmit(const float* node_box, const int* node_link,
                                const float* woop, const int* tri_idx,
                                const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const float* dist, int n, float* trans_out,
                                unsigned long long* tests, void* stream) {
  const Tables tab{node_box, node_link, woop, tri_idx};
  const Rays rays{ox, oy, oz, dx, dy, dz, dist};
  return launch<kTransmit>(tab, rays, n, nullptr, nullptr, nullptr, nullptr,
                           nullptr, trans_out, tests, stream);
}
