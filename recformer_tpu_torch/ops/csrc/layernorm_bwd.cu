// LayerNorm backward for sm_90a, with a plain C interface (loaded through
// ctypes by recformer_tpu_torch/ops/layernorm.py, which holds the plain
// PyTorch version, layernorm_bwd_plain, and the forward, plain PyTorch as in
// the JAX package).
//
// Replaces recformer_tpu/ops/pallas_layernorm.py::_ln_bwd_kernel: dx, dgamma
// and dbeta in one pass over the rows with the float32 statistics recomputed
// (sums scaled by 1/H, as the TPU kernel does),
//   m1 = mean(dy*g), m2 = mean(dy*g*x_hat), dx = rstd*((dy*g - m1) - x_hat*m2),
// dx written in the input type; dgamma = sum(dy*x_hat) and dbeta = sum(dy)
// over all rows, through the deterministic cross-block reduction of
// row_reduce.cuh (the TPU kernel accumulates them across its sequential grid
// instead).
//
// Operands, row-major and contiguous, 32-byte aligned:
//   x, dout, dx : (M, H) float or bf16
//   gamma       : (H,)   float32, holding values of x's type (the caller
//                        rounds gamma to it, as the JAX VJP does)
//   partial     : (2, partial_blocks(M), H) float32 scratch
//   dgb         : (2, H) float32: dgamma, dbeta
//
// What bounds it: a few flops per element against 6 bytes per element in
// bf16 (x and dout read, dx written), so HBM bytes. One warp per row keeps
// the row in registers, so x and dout are read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_reduce.cuh"

namespace {

using rowln::kWarps;
using rowln::Mean;

template <typename T, int H>
struct RowOf {
  const T* x;
  __device__ __forceinline__ void operator()(size_t off, int lane, float (&v)[H / 32]) const {
    rowln::load_row<T, H>(x + off, lane, v);
  }
};

template <typename T, int H>
__global__ void __launch_bounds__(kWarps * 32, 2)
    ln_bwd_kernel(RowOf<T, H> x, const float* __restrict__ gamma, const T* __restrict__ dout,
                  T* __restrict__ dx, float* __restrict__ partial, int M, float eps) {
  rowln::ln_bwd_rows<T, H, Mean::kScale>(x, gamma, dout, dx, partial, M, eps);
}

template <typename T, int H>
cudaError_t bwd(const void* x, const float* gamma, const void* dout, void* dx, float* partial,
                float* dgb, int M, float eps, cudaStream_t stream) {
  const int n_blocks = rowln::partial_blocks(M);
  ln_bwd_kernel<T, H><<<n_blocks, kWarps * 32, 0, stream>>>(
      RowOf<T, H>{static_cast<const T*>(x)}, gamma, static_cast<const T*>(dout),
      static_cast<T*>(dx), partial, M, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rowln::reduce_partials(partial, dgb, n_blocks, H, stream);
}

template <typename T>
cudaError_t bwd_width(int H, const void* x, const float* gamma, const void* dout, void* dx,
                      float* partial, float* dgb, int M, float eps, cudaStream_t stream) {
#define LN_BWD_CASE(W) \
  case W:              \
    return bwd<T, W>(x, gamma, dout, dx, partial, dgb, M, eps, stream);
  switch (H) {
    ROWLN_WIDTHS(LN_BWD_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef LN_BWD_CASE
}

}  // namespace

// Rows of partials the kernel writes for M rows (the caller sizes them).
extern "C" int layernorm_bwd_blocks(int M) { return rowln::partial_blocks(M); }

// dtype: 0 = float32, 1 = bfloat16. Returns the first failing launch's
// cudaError_t, or 0.
extern "C" int layernorm_bwd(int dtype, const void* x, const void* gamma, const void* dout,
                             void* dx, void* partial, void* dgb, int M, int H, float eps,
                             void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(dgb);
  if (dtype == 0) return (int)bwd_width<float>(H, x, g, dout, dx, p, o, M, eps, s);
  if (dtype == 1) return (int)bwd_width<__nv_bfloat16>(H, x, g, dout, dx, p, o, M, eps, s);
  return (int)cudaErrorInvalidValue;
}
