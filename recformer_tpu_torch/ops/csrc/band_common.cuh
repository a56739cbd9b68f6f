// Helpers shared by the band-attention forward and backward kernels: type
// conversions, warp reductions and the attention-dropout keep mask.
//
// The keep mask is one counter-based function of absolute coordinates,
//   keep(seed, b, h, i, c) = philox4x32_10(ctr = (c >> 2, i, h, b),
//                                          key = (seed, 0))[c & 3] >= threshold
// with i the query row, c the key position j or L + g for global column g,
// and threshold = floor(rate * 2^32). It never depends on a tile, a thread or
// a block size, so the forward kernel, the backward kernel and the plain
// PyTorch versions (ops/window_attention.py::dropout_keep) draw the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace band {

constexpr float kNegInf = -1e30f;  // not -inf: a fully masked row stays finite
constexpr int kMaxSmem = 232448;   // bytes a block may use on sm_90 after the opt-in

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Value of x after a cast to the input type.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Attention-dropout parameters of one call; ``on == 0`` keeps everything.
struct Dropout {
  uint32_t seed;
  uint32_t threshold;  // floor(rate * 2^32)
  float scale;         // 1 / (1 - rate), rounded to float32 once on the host
  int on;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four random words of columns [4 (c >> 2), 4 (c >> 2) + 4) of row i.
__device__ __forceinline__ uint4 dropout_words(const Dropout& d, int b, int h, int i, int c) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(c) >> 2, static_cast<uint32_t>(i),
                                  static_cast<uint32_t>(h), static_cast<uint32_t>(b)),
                       make_uint2(d.seed, 0u));
}

__device__ __forceinline__ bool keep_word(const Dropout& d, const uint4& w, int c) {
  const uint32_t x = (c & 2) ? ((c & 1) ? w.w : w.z) : ((c & 1) ? w.y : w.x);
  return x >= d.threshold;
}

// keep(seed, b, h, i, c) for one column c >= 0.
__device__ __forceinline__ bool dropout_keep(const Dropout& d, int b, int h, int i, int c) {
  return keep_word(d, dropout_words(d, b, h, i, c), c);
}

}  // namespace band
