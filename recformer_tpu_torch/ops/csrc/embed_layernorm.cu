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
// dgamma/dbeta in float32, reduced inside the same launch in a fixed order
// (the TPU kernel accumulates them across its sequential grid instead).
//
// Operands, row-major and contiguous, 32-byte aligned:
//   a, b, c, d, out, dout, dx : (M, H)  float or bf16
//   gamma, beta               : (H,)    float32 (gamma kept in float32, as
//                                       _fused_bwd keeps it)
//   partial                   : (embed_layernorm_bwd_partial_rows(dtype, H), 2H)
//                               float32 scratch
//   dgb                       : (2, H)  float32: dgamma, dbeta
//
// What bounds them: a few flops per element against 10 (forward) and 12
// (backward) bytes per element in bf16, so HBM bytes. The forward: one warp
// per row keeps the row in registers, so every input is read once and every
// output written once. The backward is the LayerNorm backward's design
// (row_reduce.cuh's ln_bwd_body, one launch): a persistent cooperative grid
// whose warps keep the next row's four addends and dout in flight in a ring
// in shared memory (12 warps and 187,392 bytes a block, 127 registers a
// thread, no spills at <bf16, 768>), gamma staged once a block,
// dgamma/dbeta through one row of partials a block and a grid barrier.

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
  // the backward's block shape: the four addends' rows staged per row, two
  // rows in each warp's ring (the next in flight), 12 warps
  static constexpr int kRows = 4;
  static constexpr int kStages = 2;
  static constexpr int kMaxWarps = 12;
  const T* a;
  const T* b;
  const T* c;
  const T* d;
  // the backward's pieces of a row: the four addends' rows, one after another
  __device__ __forceinline__ void stage(T* dst, size_t off, int lane) const {
    rowln::stage_row<T, H>(dst, a + off, lane);
    rowln::stage_row<T, H>(dst + H, b + off, lane);
    rowln::stage_row<T, H>(dst + 2 * H, c + off, lane);
    rowln::stage_row<T, H>(dst + 3 * H, d + off, lane);
  }
  __device__ __forceinline__ void read(const T* staged, int lane, float (&x)[H / 32]) const {
    SumOf4{staged, staged + H, staged + 2 * H, staged + 3 * H}(0, lane, x);
  }
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
using BwdPlan = rowln::BwdPlan<T, H, SumOf4<T, H>>;

template <typename T, int H>
__global__ void __launch_bounds__(BwdPlan<T, H>::kThreads, 1)
    embed_ln_bwd_kernel(SumOf4<T, H> sum, const float* __restrict__ gamma,
                        const T* __restrict__ dout, T* __restrict__ dx,
                        float* __restrict__ partial, float* __restrict__ dgb, int M, float eps) {
  rowln::ln_bwd_body<T, H, Mean::kDivide, false>(sum, gamma, dout, dx, partial, dgb, M, eps);
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
int bwd_rows() {
  return rowln::bwd_partial_rows<BwdPlan<T, H>, embed_ln_bwd_kernel<T, H>>();
}

template <typename T, int H>
cudaError_t bwd(const void* a, const void* b, const void* c, const void* d, const float* gamma,
                const void* dout, void* dx, float* partial, float* dgb, int M, float eps,
                cudaStream_t stream) {
  const SumOf4<T, H> sum{static_cast<const T*>(a), static_cast<const T*>(b),
                         static_cast<const T*>(c), static_cast<const T*>(d)};
  return rowln::launch_bwd<BwdPlan<T, H>, embed_ln_bwd_kernel<T, H>>(
      stream, sum, gamma, static_cast<const T*>(dout), static_cast<T*>(dx), partial, dgb, M,
      eps);
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
int bwd_rows_width(int H) {
#define EMBED_ROWS_CASE(W) \
  case W:                  \
    return bwd_rows<T, W>();
  switch (H) {
    ROWLN_WIDTHS(EMBED_ROWS_CASE)
    default:
      return -(int)cudaErrorInvalidValue;
  }
#undef EMBED_ROWS_CASE
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

// Rows of block partials a backward over rows of H writes (the caller
// sizes the scratch from it); negative: minus a cudaError_t.
extern "C" int embed_layernorm_bwd_partial_rows(int dtype, int H) {
  if (dtype == 0) return bwd_rows_width<float>(H);
  if (dtype == 1) return bwd_rows_width<__nv_bfloat16>(H);
  return -(int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. Each returns its launch's cudaError_t, or 0.
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
