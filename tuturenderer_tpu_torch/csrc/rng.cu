// The counter-based RNG's draw on Hopper: the hash of a lane's integer
// words and its 24-bit float in [0, 1), one launch a draw.
//
// Replaces no TPU kernel. The JAX package's hash
// (tuturenderer_tpu/utils/rng.py::hash_u32, ::uniform) is plain jnp uint32
// arithmetic, which XLA fuses into the kernels around it. PyTorch runs it
// eagerly: without this kernel the port's draw is ~116 int64 operations
// (utils/rng.py::hash_u32 splits every multiply into 16-bit halves, having
// no uint32) and, for each Python-int word, a blocking host-to-device
// copy. This kernel is that fusion.
//
// Arithmetic: native uint32_t. A 32-bit multiply wraps modulo 2^32, so it
// equals the plain version's split multiply bit for bit; adds and shifts
// wrap the same way. The float is (h >> 8) * 2^-24, exact in float32.
//
// Words, in hash order: up to kMaxWords, each a constant (one uint32 for
// every lane, passed by value) or an int32 / int64 device column read at
// lane * stride (stride 0: one value for every lane, a 0-d tensor), of
// which the low 32 bits are taken. The hash starts from the golden ratio,
// as the plain version's does.
//
// What bounds it: bytes. A lane reads its device words (two int32 on the
// path tracer's draws: the lane id and the sample id) and writes one
// float32, 12 bytes: 1,048,576 lanes in 3.8 us and 4,194,304 in 15.0 us at
// 3.35 TB/s. The integer work, ~15 operations a word and ~60 a lane, is of
// the same order on 132 SMs, so neither dominates by much. The design does
// what a byte-bound elementwise kernel needs: each thread hashes four
// neighbouring lanes, reading each word as one 16-byte load (two for
// int64) and writing the four floats as one 16-byte store where the column
// is dense and aligned (else one lane at a time), so a warp touches 512
// contiguous bytes a column; the four lanes' hashes are independent chains
// that the scheduler interleaves. No shared memory, no sync, nothing
// allocated: the wrapper allocates the output.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

// One word as the wrapper passes it (utils/rng.py::_Word). Outside the
// unnamed namespace: the exported rng_uniform takes it, and a type of
// internal linkage would make that function internal too.
struct RngWord {
  const void* ptr;                   // device column (kInt32, kInt64)
  long long stride;                  // elements from one lane to the next
  uint32_t value;                    // kConst: the word
  int kind;
};

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kMaxWords = 4;
constexpr int kBlock = 256;
constexpr int kLanes = 4;            // lanes per thread

enum Kind : int { kConst = 0, kInt32 = 1, kInt64 = 2 };

struct Words {
  RngWord w[kMaxWords];
  int vec[kMaxWords];                // dense, 16-byte aligned column
  int count;
};

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h = (h ^ (h >> 16)) * 0x7FEB352Du;
  h = (h ^ (h >> 15)) * 0x846CA68Bu;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t combine(uint32_t h, uint32_t w) {
  return mix(h ^ (w + kGolden + (h << 6) + (h >> 2)));
}

// The word of lanes base .. base + m - 1 (m <= kLanes) into out[0 .. m).
__device__ __forceinline__ void load_word(const RngWord& w, int vec,
                                          long long base, int m,
                                          uint32_t out[kLanes]) {
  if (w.kind == kConst) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) out[j] = w.value;
    return;
  }
  if (w.kind == kInt32) {
    const int* p = static_cast<const int*>(w.ptr);
    if (vec && m == kLanes) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p + base));
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
      return;
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      out[j] = j < m ? __ldg(p + (base + j) * w.stride) : 0;
    return;
  }
  const long long* p = static_cast<const long long*>(w.ptr);
  if (vec && m == kLanes) {
    const longlong2* q = reinterpret_cast<const longlong2*>(p + base);
    const longlong2 a = __ldg(q);
    const longlong2 b = __ldg(q + 1);
    out[0] = static_cast<uint32_t>(a.x); out[1] = static_cast<uint32_t>(a.y);
    out[2] = static_cast<uint32_t>(b.x); out[3] = static_cast<uint32_t>(b.y);
    return;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    out[j] = j < m ? static_cast<uint32_t>(__ldg(p + (base + j) * w.stride))
                   : 0u;                // the low 32 bits
}

__global__ void __launch_bounds__(kBlock)
rng_uniform_kernel(Words words, long long n,
                   float* __restrict__ out, int vec_out) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) * kLanes;
  if (base >= n) return;
  const int m = n - base < kLanes ? static_cast<int>(n - base) : kLanes;
  uint32_t h[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) h[j] = kGolden;
#pragma unroll
  for (int k = 0; k < kMaxWords; ++k) {
    if (k >= words.count) break;
    uint32_t w[kLanes];
    load_word(words.w[k], words.vec[k], base, m, w);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) h[j] = combine(h[j], w[j]);
  }
  float r[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    r[j] = static_cast<float>(h[j] >> 8) * (1.0f / 16777216.0f);
  if (vec_out && m == kLanes) {
    *reinterpret_cast<float4*>(out + base) = make_float4(r[0], r[1], r[2],
                                                         r[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    if (j < m) out[base + j] = r[j];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// out[i] = the draw of lane i, i < n, on `stream`. Returns the CUDA error
// of the launch (0 on success); cudaErrorInvalidValue for a word count
// past kMaxWords, a word kind it does not know or a grid too large.
extern "C" int rng_uniform(const RngWord* words, int n_words, long long n,
                           float* out, void* stream) {
  if (n_words < 0 || n_words > kMaxWords) return cudaErrorInvalidValue;
  Words a = {};
  a.count = n_words;
  for (int k = 0; k < n_words; ++k) {
    if (words[k].kind < kConst || words[k].kind > kInt64)
      return cudaErrorInvalidValue;
    a.w[k] = words[k];
    a.vec[k] = words[k].kind != kConst && words[k].stride == 1 &&
               aligned16(words[k].ptr);
  }
  if (n <= 0) return cudaSuccess;
  const long long blocks = (n + kBlock * kLanes - 1) / (kBlock * kLanes);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  rng_uniform_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, n, out, aligned16(out));
  return static_cast<int>(cudaGetLastError());
}
