// Row-wise LayerNorm pieces shared by embed_layernorm.cu (kernels 3 and 4)
// and layernorm_bwd.cu (kernel 5): the register layout of one row held by
// one warp, vectorised row loads and stores, the backward's row body, and
// the deterministic cross-block reduction of dgamma/dbeta.
//
// One warp owns one row of H = 32 * N values: lane l holds the columns
// (c * 32 + l) * V + e for chunk c and element e < V, where V elements of the
// input type make up to 16 bytes, so every load and store is coalesced and
// vectorised. Row statistics are lane sums followed by a butterfly.
//
// The TPU kernels carry dgamma/dbeta across their sequential grid in one
// revisited output block. Blocks here run in any order, so a backward pass
// runs a fixed number of blocks, partial_blocks(M); each warp accumulates its
// rows in registers, a block sums its warps in a fixed order into one fp32
// row of partials (n_blocks, H) per output, and reduce_partials_kernel sums
// those rows, again in a fixed order. No atomics: the result is bitwise the
// same from run to run.
//
// Arithmetic uses the _rn intrinsics, so nvcc contracts no multiply-add into
// an FMA and the rounding order is the one written, as in the plain
// PyTorch versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_common.cuh"

namespace rowln {

using band::from_float;
using band::to_float;
using band::warp_sum;

constexpr int kWarps = 8;          // rows in flight per block, one warp each
constexpr int kMaxBlocks = 512;    // blocks of a backward pass: rows of partials
constexpr int kReduceRows = 8;     // partial rows summed side by side per column

// Blocks of a backward pass over M rows; the caller sizes the partials from it.
inline int partial_blocks(int M) {
  const int b = (M + kWarps - 1) / kWarps;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

template <typename T, int H>
struct RowLayout {
  static_assert(H % 64 == 0, "row width must be a multiple of 64");
  static constexpr int kVec =
      (H % (32 * (16 / (int)sizeof(T))) == 0) ? 16 / (int)sizeof(T) : 2;
  static constexpr int kChunks = H / (32 * kVec);
  static constexpr int kPerLane = H / 32;
  // column of the lane's i-th value
  static __device__ __forceinline__ int col(int i, int lane) {
    return ((i / kVec) * 32 + lane) * kVec + (i % kVec);
  }
};

template <typename S, int V>
struct alignas(sizeof(S) * V) Pack {
  S v[V];
};

// The lane's values of one row of S (T's layout), widened to float.
template <typename T, int H, typename S>
__device__ __forceinline__ void load_row(const S* __restrict__ row, int lane,
                                         float (&out)[H / 32]) {
  using L = RowLayout<T, H>;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    const Pack<S, L::kVec> p =
        *reinterpret_cast<const Pack<S, L::kVec>*>(row + (c * 32 + lane) * L::kVec);
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) out[c * L::kVec + e] = to_float(p.v[e]);
  }
}

template <typename T, int H>
__device__ __forceinline__ void store_row(T* __restrict__ row, int lane,
                                          const float (&in)[H / 32]) {
  using L = RowLayout<T, H>;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    Pack<T, L::kVec> p;
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) p.v[e] = from_float<T>(in[c * L::kVec + e]);
    *reinterpret_cast<Pack<T, L::kVec>*>(row + (c * 32 + lane) * L::kVec) = p;
  }
}

template <int N>
__device__ __forceinline__ float row_sum(const float (&v)[N]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s = __fadd_rn(s, v[i]);
  return warp_sum(s);
}

// The mean of a row from its sum: jnp.mean's sum / H (the embedding kernel)
// or the LayerNorm kernel's sum * (1 / H).
enum class Mean { kDivide, kScale };

template <Mean kMean>
__device__ __forceinline__ float row_mean(float sum, int H) {
  return kMean == Mean::kDivide ? __fdiv_rn(sum, (float)H)
                                : __fmul_rn(sum, __fdiv_rn(1.f, (float)H));
}

// x -> x_hat in place (two-pass variance); returns 1 / sqrt(var + eps).
template <Mean kMean, int N>
__device__ __forceinline__ float normalize(float (&x)[N], float eps) {
  constexpr int H = 32 * N;
  const float mu = row_mean<kMean>(row_sum(x), H);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = __fsub_rn(x[i], mu);
    sq = __fadd_rn(sq, __fmul_rn(x[i], x[i]));
  }
  const float var = row_mean<kMean>(warp_sum(sq), H);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = __fmul_rn(x[i], rstd);
  return rstd;
}

// The backward of a LayerNorm over M rows of width H: ``load_x(offset, lane,
// x)`` fills the lane's values of the forward's input row (float32), gamma is
// float32, dout and dx are T. Writes dx and this block's partial rows of
// dgamma (partial[blockIdx.x]) and dbeta (partial[gridDim.x + blockIdx.x]):
//   m1 = mean(dy*g), m2 = mean(dy*g*x_hat), dx = rstd*((dy*g - m1) - x_hat*m2)
template <typename T, int H, Mean kMean, typename LoadX>
__device__ __forceinline__ void ln_bwd_rows(const LoadX& load_x,
                                            const float* __restrict__ gamma,
                                            const T* __restrict__ dout, T* __restrict__ dx,
                                            float* __restrict__ partial, int M, float eps) {
  constexpr int N = H / 32;
  using L = RowLayout<T, H>;
  __shared__ float red[kWarps][H];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float dg[N], db[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dg[i] = db[i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < M; row += gridDim.x * kWarps) {
    const size_t off = (size_t)row * H;
    float x[N], g[N], gam[N];
    load_x(off, lane, x);
    const float rstd = normalize<kMean>(x, eps);
    load_row<T, H>(dout + off, lane, g);
    load_row<T, H>(gamma, lane, gam);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      dg[i] = __fadd_rn(dg[i], __fmul_rn(g[i], x[i]));
      db[i] = __fadd_rn(db[i], g[i]);
      g[i] = __fmul_rn(g[i], gam[i]);  // dy * gamma
      s1 = __fadd_rn(s1, g[i]);
      s2 = __fadd_rn(s2, __fmul_rn(g[i], x[i]));
    }
    const float m1 = row_mean<kMean>(warp_sum(s1), H);
    const float m2 = row_mean<kMean>(warp_sum(s2), H);
#pragma unroll
    for (int i = 0; i < N; ++i)
      g[i] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(g[i], m1), __fmul_rn(x[i], m2)));
    store_row<T, H>(dx + off, lane, g);
  }

  // this block's warps, summed in warp order: dgamma, then dbeta
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp][L::col(i, lane)] = k ? db[i] : dg[i];
    __syncthreads();
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w][h]);
      partial[((size_t)k * gridDim.x + blockIdx.x) * H + h] = s;
    }
    __syncthreads();
  }
}

// out[k * H + h] = sum over b of partial[(k * n_blocks + b) * H + h], k < 2,
// in a fixed order: kReduceRows strided sums, then those in row order.
// Block (32, kReduceRows), one block per 32 of the 2H columns.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int n_blocks, int H) {
  __shared__ float red[kReduceRows][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;  // over 2H
  float s = 0.f;
  if (col < 2 * H) {
    const int k = col / H, h = col - k * H;
    const float* src = partial + (size_t)k * n_blocks * H + h;
    for (int b = ty; b < n_blocks; b += kReduceRows) s = __fadd_rn(s, src[(size_t)b * H]);
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < 2 * H) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kReduceRows; ++r) t = __fadd_rn(t, red[r][tx]);
    out[col] = t;
  }
}

inline cudaError_t reduce_partials(const float* partial, float* out, int n_blocks, int H,
                                   cudaStream_t stream) {
  reduce_partials_kernel<<<(2 * H + 31) / 32, dim3(32, kReduceRows), 0, stream>>>(
      partial, out, n_blocks, H);
  return cudaGetLastError();
}

}  // namespace rowln

// Dispatch on the row widths the kernels are built for (the Python wrappers
// hold the same list, SUPPORTED_WIDTHS).
#define ROWLN_WIDTHS(CASE) CASE(64) CASE(128) CASE(256) CASE(384) CASE(512) CASE(768) CASE(1024)
