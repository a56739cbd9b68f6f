// Fused four-way embedding sum + LayerNorm, forward and backward, for sm_90a,
// with a plain C interface (loaded through ctypes by
// recformer_tpu_torch/ops/embed_layernorm.py, which holds the plain PyTorch
// versions, embed_layernorm_plain and embed_layernorm_bwd_plain).
//
// Replaces recformer_tpu/ops/pallas_embed.py::_fwd_kernel (forward) and
// ::_bwd_kernel (backward). Forward: y = LN(a + b + c + d) with the four
// addends widened to float32 and summed in that order, the two-pass variance
// (jnp.mean: sums divided by H), rsqrt(var + eps), x_hat * gamma + beta,
// written in the addends' type. Backward: recomputes x_hat from the addends
// and writes the one dx that all four addends share, in their type, and
// dgamma/dbeta in float32 through the deterministic cross-block reduction of
// row_reduce.cuh (the TPU kernel accumulates them across its sequential
// grid instead).
//
// Operands, row-major and contiguous, 32-byte aligned:
//   a, b, c, d, out, dout, dx : (M, H)  float or bf16
//   gamma, beta               : (H,)    float32
//   partial                   : (2, partial_blocks(M), H) float32 scratch
//   dgb                       : (2, H)  float32: dgamma, dbeta
//
// What bounds them: a few flops per element against 10 (forward) and 12
// (backward) bytes per element in bf16, so HBM bytes. One warp per row keeps
// the row in registers: every input is read once, every output written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_reduce.cuh"

namespace {

using rowln::kWarps;
using rowln::load_row;
using rowln::Mean;

// The lane's values of the float32 sum ((a + b) + c) + d of one row.
template <typename T, int H>
struct SumOf4 {
  const T* a;
  const T* b;
  const T* c;
  const T* d;
  __device__ __forceinline__ void operator()(size_t off, int lane, float (&x)[H / 32]) const {
    float t[H / 32];
    load_row<T, H>(a + off, lane, x);
    load_row<T, H>(b + off, lane, t);
#pragma unroll
    for (int i = 0; i < H / 32; ++i) x[i] = __fadd_rn(x[i], t[i]);
    load_row<T, H>(c + off, lane, t);
#pragma unroll
    for (int i = 0; i < H / 32; ++i) x[i] = __fadd_rn(x[i], t[i]);
    load_row<T, H>(d + off, lane, t);
#pragma unroll
    for (int i = 0; i < H / 32; ++i) x[i] = __fadd_rn(x[i], t[i]);
  }
};

template <typename T, int H>
__global__ void __launch_bounds__(kWarps * 32)
    embed_ln_fwd_kernel(SumOf4<T, H> sum, const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ out, int M, float eps) {
  constexpr int N = H / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;  // the whole warp leaves together
  const size_t off = (size_t)row * H;
  float x[N], g[N], bt[N];
  sum(off, lane, x);
  rowln::normalize<Mean::kDivide>(x, eps);
  load_row<T, H>(gamma, lane, g);
  load_row<T, H>(beta, lane, bt);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = __fadd_rn(__fmul_rn(x[i], g[i]), bt[i]);
  rowln::store_row<T, H>(out + off, lane, x);
}

template <typename T, int H>
__global__ void __launch_bounds__(kWarps * 32, 2)
    embed_ln_bwd_kernel(SumOf4<T, H> sum, const float* __restrict__ gamma,
                        const T* __restrict__ dout, T* __restrict__ dx,
                        float* __restrict__ partial, int M, float eps) {
  rowln::ln_bwd_rows<T, H, Mean::kDivide>(sum, gamma, dout, dx, partial, M, eps);
}

template <typename T, int H>
cudaError_t fwd(const void* a, const void* b, const void* c, const void* d, const float* gamma,
                const float* beta, void* out, int M, float eps, cudaStream_t stream) {
  const SumOf4<T, H> sum{static_cast<const T*>(a), static_cast<const T*>(b),
                         static_cast<const T*>(c), static_cast<const T*>(d)};
  embed_ln_fwd_kernel<T, H><<<(M + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      sum, gamma, beta, static_cast<T*>(out), M, eps);
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t bwd(const void* a, const void* b, const void* c, const void* d, const float* gamma,
                const void* dout, void* dx, float* partial, float* dgb, int M, float eps,
                cudaStream_t stream) {
  const SumOf4<T, H> sum{static_cast<const T*>(a), static_cast<const T*>(b),
                         static_cast<const T*>(c), static_cast<const T*>(d)};
  const int n_blocks = rowln::partial_blocks(M);
  embed_ln_bwd_kernel<T, H><<<n_blocks, kWarps * 32, 0, stream>>>(
      sum, gamma, static_cast<const T*>(dout), static_cast<T*>(dx), partial, M, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rowln::reduce_partials(partial, dgb, n_blocks, H, stream);
}

template <typename T>
cudaError_t fwd_width(int H, const void* a, const void* b, const void* c, const void* d,
                      const float* gamma, const float* beta, void* out, int M, float eps,
                      cudaStream_t stream) {
#define EMBED_FWD_CASE(W) \
  case W:                 \
    return fwd<T, W>(a, b, c, d, gamma, beta, out, M, eps, stream);
  switch (H) {
    ROWLN_WIDTHS(EMBED_FWD_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef EMBED_FWD_CASE
}

template <typename T>
cudaError_t bwd_width(int H, const void* a, const void* b, const void* c, const void* d,
                      const float* gamma, const void* dout, void* dx, float* partial, float* dgb,
                      int M, float eps, cudaStream_t stream) {
#define EMBED_BWD_CASE(W) \
  case W:                 \
    return bwd<T, W>(a, b, c, d, gamma, dout, dx, partial, dgb, M, eps, stream);
  switch (H) {
    ROWLN_WIDTHS(EMBED_BWD_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef EMBED_BWD_CASE
}

}  // namespace

// Rows of partials the backward writes for M rows (the caller sizes them).
extern "C" int embed_layernorm_bwd_blocks(int M) { return rowln::partial_blocks(M); }

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t, or 0.
extern "C" int embed_layernorm_fwd(int dtype, const void* a, const void* b, const void* c,
                                   const void* d, const void* gamma, const void* beta,
                                   void* out, int M, int H, float eps, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  if (dtype == 0) return (int)fwd_width<float>(H, a, b, c, d, g, bt, out, M, eps, s);
  if (dtype == 1) return (int)fwd_width<__nv_bfloat16>(H, a, b, c, d, g, bt, out, M, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int embed_layernorm_bwd(int dtype, const void* a, const void* b, const void* c,
                                   const void* d, const void* gamma, const void* dout, void* dx,
                                   void* partial, void* dgb, int M, int H, float eps,
                                   void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(dgb);
  if (dtype == 0) return (int)bwd_width<float>(H, a, b, c, d, g, dout, dx, p, o, M, eps, s);
  if (dtype == 1)
    return (int)bwd_width<__nv_bfloat16>(H, a, b, c, d, g, dout, dx, p, o, M, eps, s);
  return (int)cudaErrorInvalidValue;
}
