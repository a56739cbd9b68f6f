// LayerNorm backward for sm_90a, with a plain C interface (loaded through
// ctypes by recformer_tpu_torch/ops/layernorm.py, which holds the plain
// PyTorch version, layernorm_bwd_plain, and the forward, plain PyTorch as in
// the JAX package).
//
// Replaces recformer_tpu/ops/pallas_layernorm.py::_ln_bwd_kernel (with the
// rounding of _pln_bwd, :104-126): dx, dgamma and dbeta in one launch over
// the rows, with the float32 statistics recomputed (sums scaled by 1/H, as
// the TPU kernel does),
//   m1 = mean(dy*g), m2 = mean(dy*g*x_hat), dx = rstd*((dy*g - m1) - x_hat*m2),
// dx written in the input type, g = gamma rounded to the input type inside
// the kernel (__float2bfloat16_rn: the bits of weight.to(bf16)); dgamma =
// sum(dy*x_hat) and dbeta = sum(dy) over all rows in float32, reduced inside
// the same launch in a fixed order (the TPU kernel accumulates them across
// its sequential grid instead).
//
// What bounds it: a few flops per element against 6 bytes per element in
// bf16 (x and dout read, dx written), so HBM bytes. The design is
// row_reduce.cuh's ln_bwd_body: a persistent cooperative grid, one block of
// 8 warps an SM; each warp keeps its next row's x and dout in flight
// (cp.async into a ring in shared memory) while it reduces and stores the
// current one; gamma staged once a block; dgamma/dbeta through the warps,
// one row of partials a block and a grid barrier, no second launch and no
// atomic on a sum. The wrapper casts nothing: one call is one device
// kernel. At <bf16, 768> a block takes 52,224 bytes of shared memory and
// a thread 145 registers, with no spills (nvcc -Xptxas -v for sm_90a).
//
// Operands, row-major and contiguous, 32-byte aligned:
//   x, dout, dx : (M, H) float or bf16
//   gamma       : (H,)   float32, the parameter as it is
//   partial     : (layernorm_bwd_partial_rows(dtype, H), 2H) float32 scratch
//   dgb         : (2, H) float32: dgamma, dbeta

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_reduce.cuh"

namespace {

using rowln::Mean;

// The forward's input of a row is one row of x.
template <typename T, int H>
struct RowOf {
  static constexpr int kRows = 1;      // rows of T staged per row
  static constexpr int kStages = 2;    // rows in each warp's ring: the next is in flight
  static constexpr int kMaxWarps = 8;  // warps of a block
  const T* x;
  __device__ __forceinline__ void stage(T* dst, size_t off, int lane) const {
    rowln::stage_row<T, H>(dst, x + off, lane);
  }
  __device__ __forceinline__ void read(const T* staged, int lane, float (&v)[H / 32]) const {
    rowln::load_row<T, H>(staged, lane, v);
  }
};

template <typename T, int H>
using Plan = rowln::BwdPlan<T, H, RowOf<T, H>>;

template <typename T, int H>
__global__ void __launch_bounds__(Plan<T, H>::kThreads, 1)
    ln_bwd_kernel(RowOf<T, H> x, const float* __restrict__ gamma, const T* __restrict__ dout,
                  T* __restrict__ dx, float* __restrict__ partial, float* __restrict__ dgb,
                  int M, float eps) {
  rowln::ln_bwd_body<T, H, Mean::kScale, true>(x, gamma, dout, dx, partial, dgb, M, eps);
}

template <typename T, int H>
int partial_rows() {
  return rowln::bwd_partial_rows<Plan<T, H>, ln_bwd_kernel<T, H>>();
}

template <typename T, int H>
cudaError_t bwd(const void* x, const float* gamma, const void* dout, void* dx, float* partial,
                float* dgb, int M, float eps, cudaStream_t stream) {
  return rowln::launch_bwd<Plan<T, H>, ln_bwd_kernel<T, H>>(
      stream, RowOf<T, H>{static_cast<const T*>(x)}, gamma, static_cast<const T*>(dout),
      static_cast<T*>(dx), partial, dgb, M, eps);
}

template <typename T>
int rows_width(int H) {
#define LN_ROWS_CASE(W) \
  case W:               \
    return partial_rows<T, W>();
  switch (H) {
    ROWLN_WIDTHS(LN_ROWS_CASE)
    default:
      return -(int)cudaErrorInvalidValue;
  }
#undef LN_ROWS_CASE
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

// Rows of block partials a launch over rows of H writes (the caller sizes
// the scratch from it); negative: minus a cudaError_t.
extern "C" int layernorm_bwd_partial_rows(int dtype, int H) {
  if (dtype == 0) return rows_width<float>(H);
  if (dtype == 1) return rows_width<__nv_bfloat16>(H);
  return -(int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t, or 0.
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
