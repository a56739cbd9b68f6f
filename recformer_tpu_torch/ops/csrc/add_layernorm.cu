// Residual sum + bias-free LayerNorm for sm_90a, with a plain C interface
// (loaded through ctypes by recformer_tpu_torch/ops/add_layernorm.py, which
// holds the plain PyTorch version, add_layernorm_plain, and the backward,
// plain PyTorch in float32).
//
// Replaces no TPU kernel: the JAX package has no ModernBERT. It was added
// because ModernBERT's LayerNorm (models/modernbert.py), run as plain
// PyTorch, is about ten kernels over the whole activation in float32, and at
// the rank cell's (32, 8192) x 1,024 its 57 calls a forward took about a
// quarter of a request's device time. One launch computes, over (M, H)
// contiguous rows of T (float or bf16) with gamma float32 and no bias,
//   with a residual d:  s = T(x + d), written out, then y = LN(s);
//   without one:        y = LN(x);
// LN(v) = T((vc * rsqrt(mean(vc * vc) + eps)) * gamma), vc = v - mean(v),
// float32 two-pass statistics, means as PyTorch's mean takes them (the sum
// scaled by 1/H). s is bitwise PyTorch's x + d in T (the float32 sum of the
// widened values, rounded once), since the next residual reads it.
//
// Operands, row-major and contiguous, 32-byte aligned:
//   x, d, s, y : (M, H) float or bf16 (d and s both null without a residual)
//   gamma      : (H,)   float32
//
// What bounds it: a few flops per element against 8 bytes per element in
// bf16 with a residual (x, d read; s, y written) and 4 without, so HBM
// bytes. The design is kernel 3's forward (embed_layernorm.cu): one warp owns
// one row, kept in registers (row_reduce.cuh's layout: 16-byte coalesced
// loads and stores), so every input is read once and every output written
// once; no grid barrier, no scratch, nothing allocated by the kernel.
// Arithmetic uses the _rn intrinsics, so nvcc contracts nothing into an FMA
// and the rounding order is the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_reduce.cuh"

namespace {

using rowln::kWarps;
using rowln::load_row;
using rowln::Mean;

template <typename T, int H, bool kResidual>
__global__ void __launch_bounds__(kWarps * 32)
    add_ln_kernel(const T* __restrict__ x, const T* __restrict__ d,
                  const float* __restrict__ gamma, T* __restrict__ s, T* __restrict__ y, int M,
                  float eps) {
  constexpr int N = H / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;  // the whole warp leaves together
  const size_t off = (size_t)row * H;
  float v[N];
  load_row<T, H>(x + off, lane, v);
  if constexpr (kResidual) {
    float t[N];
    load_row<T, H>(d + off, lane, t);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = band::round_to<T>(__fadd_rn(v[i], t[i]));
    rowln::store_row<T, H>(s + off, lane, v);
  }
  rowln::normalize<Mean::kScale>(v, eps);
  float g[N];
  load_row<T, H>(gamma, lane, g);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __fmul_rn(v[i], g[i]);
  rowln::store_row<T, H>(y + off, lane, v);
}

template <typename T, int H>
cudaError_t fwd(const void* x, const void* d, const float* gamma, void* s, void* y, int M,
                float eps, cudaStream_t stream) {
  const dim3 grid((M + kWarps - 1) / kWarps), block(kWarps * 32);
  const T* xt = static_cast<const T*>(x);
  if (d != nullptr)
    add_ln_kernel<T, H, true><<<grid, block, 0, stream>>>(
        xt, static_cast<const T*>(d), gamma, static_cast<T*>(s), static_cast<T*>(y), M, eps);
  else
    add_ln_kernel<T, H, false><<<grid, block, 0, stream>>>(xt, nullptr, gamma, nullptr,
                                                           static_cast<T*>(y), M, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_width(int H, const void* x, const void* d, const float* gamma, void* s, void* y,
                      int M, float eps, cudaStream_t stream) {
#define ADD_LN_CASE(W) \
  case W:              \
    return fwd<T, W>(x, d, gamma, s, y, M, eps, stream);
  switch (H) {
    ROWLN_WIDTHS(ADD_LN_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef ADD_LN_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d and s: both given (the residual sum is
// taken and written) or both null. Returns the launch's cudaError_t, or 0.
extern "C" int add_layernorm_fwd(int dtype, const void* x, const void* d, const void* gamma,
                                 void* s, void* y, int M, int H, float eps, void* stream) {
  if (M <= 0 || (d == nullptr) != (s == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  if (dtype == 0) return (int)fwd_width<float>(H, x, d, g, s, y, M, eps, st);
  if (dtype == 1) return (int)fwd_width<__nv_bfloat16>(H, x, d, g, s, y, M, eps, st);
  return (int)cudaErrorInvalidValue;
}
