// Mesh-scale nearest hit, shadow any hit and alpha-shadow transmittance on
// Hopper: a while-while walk (Aila & Laine 2009) of a BVH with small
// leaves, both child boxes stored in each node, and 16-byte triangle rows.
//
// Replaces the three Pallas TPU walk kernels of tuturenderer_tpu/ops/
// pallas/cluster.py: _kernel_nearest (K5), _kernel_anyhit (K6) and
// _kernel_transmit (K7), bodies of _walk_kernel. The TPU kernel reduces a
// 1024-ray tile to a beam, walks a sorted per-tile visit list of
// 64-triangle clusters staged into SMEM, and exits at a tile-wide limit.
// What is kept is what they compute:
//
//   K5: the nearest t with |w_d| >= 1e-4, t > 0, u > 0, v > 0,
//       1 - u - v > 0 over every triangle of the table, and its original
//       triangle id (tri_idx), -1 on a miss (ops/pallas/cluster.py:269-283);
//   K6: any such hit with t < dist and |t - dist| >= 1e-4 (BVH.hpp:184);
//   K7: the product of (1 - alpha) over every such hit with t < dist, no
//       endpoint guard (cluster.py:473-491); alpha is Woop slot 13.
//
// Tables (ops/cluster.py build_bvh): nodes [K, 16] f32, 64 bytes per inner
// node read as 4 float4: both children's padded boxes
//   a.lo.x a.hi.x a.lo.y a.hi.y | b.lo.x b.hi.x b.lo.y b.hi.y |
//   a.lo.z a.hi.z b.lo.z b.hi.z | link a, link b (int32 bits), 0, 0
// with a link >= 0 an inner node and a link < 0 a leaf of `count` rows
// from `first`, -1 - link = first << 4 | count; node 0 is the root.
// rows [R, 12] f32: r1 c1 | r2 c2 | r3' c3' of the Woop rows (r3/c3
// prescaled by |n|, so w_d = d . r3' is dir . n_hat), 3 float4 per
// triangle, a leaf's rows contiguous; virt [R] i32 the virtual id
// (cluster * 64 + slot), mapped through tri_idx [C * 64] to the triangle
// (K5) and to the row's alpha in woop [C, 1024] f32 (K7): woop[virt / 64]
// [virt % 64 * 14 + 13]. K7 reads alpha there, on accepted crossings only,
// so a table whose woop was replaced (new alphas) needs no new BVH.
//
// Walk: one thread per ray. Each iteration runs the node phase until every
// lane of the warp holds a leaf or is done (__any_sync), then the leaf
// phase. A node visit loads one 64-byte node and slab-tests both children
// with the JAX gate (cluster.py:374-393, 1 / (c == 0 ? 1e-30 : c)):
// tmin <= tmax, tmax >= 0 and tmin < bound. K5 goes to the nearer child,
// pushes the farther and prunes by the best t so far; K6 and K7 need no
// order and prune by dist. K6 leaves at its first accepted hit, K7 when its
// product is exactly 0 (an alpha-1 crossing): every later factor is finite
// and >= 0, so the result is the one walking on would give. Each real row
// lies in exactly one leaf, so no crossing is counted twice. The stack
// holds links. The boxes are padded outward on the host (1e-4 absolute +
// 1e-5 relative), so the slab test's rounding never culls a hit that the
// dense test accepts.
//
// Agreement: built with --fmad=false, the triangle test rounds every step
// as the plain PyTorch versions do (ops/cuda/cluster.py), so t and the
// barycentrics are bit-equal to theirs and the K6 masks equal. The visiting
// order differs from their row order, so an exact t tie may keep another
// index, and K7's product is taken in another order (rtol 1e-5).
//
// What bounds it: per ray it reads 24 bytes (28 with dist) and writes 16
// (K5) or 4, and the tables once; ~30 flops per ray/triangle test and ~40
// per node visit (two slab tests). At the main path's ~6 tests and ~21
// node visits per ray (K5; K6 and K7 fewer) the bytes bound it
// (chip_smoke.py prints both bounds). The design cuts the work per ray
// (leaves of 4 rows instead of 64-row clusters), loads each node and row as
// whole float4s with no dependent load before a box test, and keeps the
// leaf work out of the node loop. What holds it far above the bound is
// latency: each node load depends on the last, and a warp lasts as long as
// its longest ray (chip_smoke.py phase 6 times 8,192-ray slices of a
// wavefront alone against the whole).
//
// `tests` and `nodes` (may be null) count the ray/triangle tests and the
// node visits made, one atomic add each per thread: diagnostics for the
// bound's operation count, off on the main path.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr float kF32Max = 3.4e38f;
constexpr float kParallelEps = 1e-4f;   // FLOAT_EQUAL, global.hpp:134-136
constexpr int kStack = 32;              // ops/cluster.py BVH_STACK
constexpr int kBlock = 128;
constexpr int kLeafBits = 4;            // ops/cluster.py LEAF_BITS
constexpr int kDone = INT_MIN;          // no node left
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClusterSize = 64;        // ops/cluster.py CLUSTER_SIZE
constexpr int kClusterFloats = 8 * 128; // woop floats per cluster
constexpr int kWoopF = 14;              // ops/cluster.py WOOP_F
constexpr int kAlphaSlot = 13;

enum Mode { kNearest = 0, kAnyHit = 1, kTransmit = 2 };

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float inv_dir(float c) {
  return 1.0f / (c == 0.0f ? 1e-30f : c);
}

// Slab test of one padded child box; *entry = tmin.
__device__ __forceinline__ bool slab(float lox, float hix, float loy,
                                     float hiy, float loz, float hiz,
                                     const Ray& r, float bound,
                                     float* entry) {
  const float t0x = (lox - r.ox) * r.ix;
  const float t1x = (hix - r.ox) * r.ix;
  const float t0y = (loy - r.oy) * r.iy;
  const float t1y = (hiy - r.oy) * r.iy;
  const float t0z = (loz - r.oz) * r.iz;
  const float t1z = (hiz - r.oz) * r.iz;
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

// The 12-value test of cluster.py:269-283 on one row of 3 float4, in the
// order of operations of the plain versions' _test_tile.
__device__ __forceinline__ TriHit woop_test(const float4* __restrict__ row,
                                            const Ray& r) {
  const float4 a = __ldg(row);        // r1 c1
  const float4 b = __ldg(row + 1);    // r2 c2
  const float4 c = __ldg(row + 2);    // r3' c3'
  const float w_o = r.ox * c.x + r.oy * c.y + r.oz * c.z - c.w;
  const float w_d = r.dx * c.x + r.dy * c.y + r.dz * c.z;
  const float inv = 1.0f / w_d;     // w_d == 0 -> inf/NaN, rejected below
  TriHit h;
  h.t = -w_o * inv;
  h.u = (r.ox * a.x + r.oy * a.y + r.oz * a.z - a.w) +
        h.t * (r.dx * a.x + r.dy * a.y + r.dz * a.z);
  h.v = (r.ox * b.x + r.oy * b.y + r.oz * b.z - b.w) +
        h.t * (r.dx * b.x + r.dy * b.y + r.dz * b.z);
  h.wd = w_d;
  return h;
}

// Triangle.hpp:39-49; comparisons with NaN are false.
__device__ __forceinline__ bool accepted(const TriHit& h) {
  return fabsf(h.wd) >= kParallelEps && h.t > 0.0f && h.u > 0.0f &&
         h.v > 0.0f && 1.0f - h.u - h.v > 0.0f;
}

struct Tables {
  const float4* nodes;
  const float4* rows;
  const int* virt;
  const int* tri_idx;   // K5
  const float* woop;    // K7: alpha in slot 13
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *dist;
};

struct Outputs {
  float* t;
  int* idx;
  float* bu;
  float* bv;
  int* hit;
  float* trans;
  unsigned long long* tests;
  unsigned long long* nodes;
};

template <int kMode>
__global__ void __launch_bounds__(kBlock)
bvh_walk_kernel(Tables tab, Rays rays, int n, Outputs out) {
  // every lane of a warp runs the walk's loops (__any_sync): lanes past
  // the last ray start with no node
  const int i = blockIdx.x * kBlock + threadIdx.x;
  Ray r{};
  float rdist = kF32Max;
  int node = kDone;
  if (i < n) {
    r.ox = rays.ox[i];
    r.oy = rays.oy[i];
    r.oz = rays.oz[i];
    r.dx = rays.dx[i];
    r.dy = rays.dy[i];
    r.dz = rays.dz[i];
    r.ix = inv_dir(r.dx);
    r.iy = inv_dir(r.dy);
    r.iz = inv_dir(r.dz);
    if (kMode != kNearest) rdist = rays.dist[i];
    node = 0;
  }
  float bound = rdist;
  float t_best = kF32Max, bu = 0.0f, bv = 0.0f, trans = 1.0f;
  int best = -1;
  int stop = 0;           // K6: blocked; K7: the product is 0
  int stack[kStack];
  int sp = 0;
  unsigned n_tests = 0, n_nodes = 0;

  while (__any_sync(kFull, node != kDone)) {
    // node phase: until every lane holds a leaf or is done
    while (__any_sync(kFull, node >= 0)) {
      if (node < 0) continue;
      ++n_nodes;
      const float4* p = tab.nodes + 4 * static_cast<size_t>(node);
      const float4 xa = __ldg(p);
      const float4 xb = __ldg(p + 1);
      const float4 z = __ldg(p + 2);
      const int4 link = __ldg(reinterpret_cast<const int4*>(p + 3));
      float ea, eb;
      const bool ha = slab(xa.x, xa.y, xa.z, xa.w, z.x, z.y, r, bound, &ea);
      const bool hb = slab(xb.x, xb.y, xb.z, xb.w, z.z, z.w, r, bound, &eb);
      if (ha && hb) {
        const bool a_first = kMode != kNearest || ea <= eb;
        stack[sp++] = a_first ? link.y : link.x;
        node = a_first ? link.x : link.y;
      } else if (ha) {
        node = link.x;
      } else if (hb) {
        node = link.y;
      } else {
        node = sp > 0 ? stack[--sp] : kDone;
      }
    }
    // leaf phase
    if (node == kDone) continue;
    const int code = -1 - node;
    const int first = code >> kLeafBits;
    const int count = code & ((1 << kLeafBits) - 1);
    n_tests += count;
    for (int k = 0; k < count; ++k) {
      const TriHit h = woop_test(tab.rows + 3 * (first + k), r);
      if (!accepted(h)) continue;
      if (kMode == kNearest) {
        if (h.t < t_best) {
          t_best = h.t;
          best = first + k;
          bu = h.u;
          bv = h.v;
        }
      } else if (kMode == kAnyHit) {
        // t < dist with the FLOAT_EQUAL endpoint guard (BVH.hpp:184)
        if (h.t < rdist && fabsf(h.t - rdist) >= kParallelEps) {
          stop = 1;
          break;
        }
      } else if (h.t < rdist) {
        const int v = __ldg(tab.virt + first + k);
        trans *= 1.0f - __ldg(tab.woop +
                              static_cast<size_t>(v / kClusterSize) *
                                  kClusterFloats +
                              (v % kClusterSize) * kWoopF + kAlphaSlot);
        if (trans == 0.0f) {
          stop = 1;
          break;
        }
      }
    }
    if (kMode == kNearest) bound = t_best;
    node = stop || sp == 0 ? kDone : stack[--sp];
  }
  if (i < n) {
    if (kMode == kNearest) {
      out.t[i] = t_best;
      out.idx[i] = best >= 0 ? __ldg(tab.tri_idx + __ldg(tab.virt + best))
                             : -1;
      out.bu[i] = bu;
      out.bv[i] = bv;
    } else if (kMode == kAnyHit) {
      out.hit[i] = stop;
    } else {
      out.trans[i] = trans;
    }
  }
  if (out.tests != nullptr) atomicAdd(out.tests, n_tests);
  if (out.nodes != nullptr) atomicAdd(out.nodes, n_nodes);
}

template <int kMode>
int launch(Tables tab, Rays rays, int n, Outputs out, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  bvh_walk_kernel<kMode><<<grid, kBlock, 0, static_cast<cudaStream_t>(
      stream)>>>(tab, rays, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 on success); `tests`
// and `nodes` may be null.
extern "C" int bvh_nearest(const float* nodes, const float* rows,
                           const int* virt, const int* tri_idx,
                           const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           int n, float* t_out, int* idx_out, float* bu_out,
                           float* bv_out, unsigned long long* tests,
                           unsigned long long* node_visits, void* stream) {
  const Tables tab{reinterpret_cast<const float4*>(nodes),
                   reinterpret_cast<const float4*>(rows), virt, tri_idx,
                   nullptr};
  const Rays rays{ox, oy, oz, dx, dy, dz, nullptr};
  const Outputs out{t_out, idx_out, bu_out, bv_out, nullptr, nullptr, tests,
                    node_visits};
  return launch<kNearest>(tab, rays, n, out, stream);
}

extern "C" int bvh_anyhit(const float* nodes, const float* rows,
                          const int* virt, const int* tri_idx,
                          const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* dist, int n, int* hit_out,
                          unsigned long long* tests,
                          unsigned long long* node_visits, void* stream) {
  const Tables tab{reinterpret_cast<const float4*>(nodes),
                   reinterpret_cast<const float4*>(rows), virt, tri_idx,
                   nullptr};
  const Rays rays{ox, oy, oz, dx, dy, dz, dist};
  const Outputs out{nullptr, nullptr, nullptr, nullptr, hit_out, nullptr,
                    tests, node_visits};
  return launch<kAnyHit>(tab, rays, n, out, stream);
}

extern "C" int bvh_transmit(const float* nodes, const float* rows,
                            const int* virt, const float* woop,
                            const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const float* dist, int n, float* trans_out,
                            unsigned long long* tests,
                            unsigned long long* node_visits, void* stream) {
  const Tables tab{reinterpret_cast<const float4*>(nodes),
                   reinterpret_cast<const float4*>(rows), virt, nullptr,
                   woop};
  const Rays rays{ox, oy, oz, dx, dy, dz, dist};
  const Outputs out{nullptr, nullptr, nullptr, nullptr, nullptr, trans_out,
                    tests, node_visits};
  return launch<kTransmit>(tab, rays, n, out, stream);
}
