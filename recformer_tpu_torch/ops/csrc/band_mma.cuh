// Tensor-core helpers shared by the band-attention forward and backward
// kernels: ldmatrix and mma.sync m16n8k16 (bf16 in, fp32 accumulate),
// cp.async staging with zero fill, and the dropout keep bits of one C tile
// drawn once per four adjacent columns.
//
// Fragment layout of mma.m16n8k16 (lane = 4 gq + tq): a C tile's thread
// holds rows gq and gq + 8, columns 2 tq and 2 tq + 1; two C tiles side by
// side are, register for register, the A fragment of a 16-deep product
// (pack_bf16 of c0,c1 / c2,c3 of each).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_common.cuh"

namespace band {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared without passing through registers; when
// ``pred`` is false no byte is read and the 16 bytes are zero-filled
// (``gmem`` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight; the
// finished copies are visible to this thread (to others after a barrier)
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// e^(s - m) as 2^((s - m) log2 e) on the SFU (relative error ~2^-22, where
// expf takes several more instructions). The difference comes first, so a
// fully masked row (s = m = -1e30) gives exactly 1, as expf does.
__device__ __forceinline__ float exp_diff(float s, float m) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"((s - m) * 1.4426950408889634f));
  return y;
}

// q * scale rounded to bf16, for the 8 values of one 16-byte chunk in place
__device__ __forceinline__ void scale_chunk(__nv_bfloat16* p, float scale) {
  uint4 c = *reinterpret_cast<uint4*>(p);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&c);
#pragma unroll
  for (int x = 0; x < 8; ++x) e[x] = __float2bfloat16_rn(__bfloat162float(e[x]) * scale);
  *reinterpret_cast<uint4*>(p) = c;
}

// Keep bits of one thread's four elements of a C tile: rows i0 and i1 and
// columns c, c + 1, where c = base + 2 tq with base a multiple of 4. The
// threads tq and tq ^ 1 hold the four columns [c & ~3, +4) of the same two
// rows, so one Philox call each covers them: the even one draws row i0's
// words, the odd one row i1's, and each passes the other the two it needs.
// Every lane of the warp must call it. keep = {(i0,c), (i0,c+1), (i1,c), (i1,c+1)}.
__device__ __forceinline__ void keep_quad(const Dropout& d, int b, int h, int i0, int i1, int c,
                                          int tq, bool (&keep)[4]) {
  const bool odd = tq & 1;
  const uint4 w = dropout_words(d, b, h, odd ? i1 : i0, c);
  const uint32_t own0 = odd ? w.z : w.x, own1 = odd ? w.w : w.y;
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  keep[0] = (odd ? got0 : own0) >= d.threshold;
  keep[1] = (odd ? got1 : own1) >= d.threshold;
  keep[2] = (odd ? own0 : got0) >= d.threshold;
  keep[3] = (odd ? own1 : got1) >= d.threshold;
}

// The same for the global tile, whose columns c = L + 2 tq start at a
// multiple of 4 only when L does; otherwise each element draws its own.
__device__ __forceinline__ void keep_global(const Dropout& d, int b, int h, int i0, int i1,
                                            int L, int tq, bool (&keep)[4]) {
  const int c = L + 2 * tq;
  if ((L & 3) == 0) {
    keep_quad(d, b, h, i0, i1, c, tq, keep);
  } else {
    keep[0] = dropout_keep(d, b, h, i0, c);
    keep[1] = dropout_keep(d, b, h, i0, c + 1);
    keep[2] = dropout_keep(d, b, h, i1, c);
    keep[3] = dropout_keep(d, b, h, i1, c + 1);
  }
}

}  // namespace band
