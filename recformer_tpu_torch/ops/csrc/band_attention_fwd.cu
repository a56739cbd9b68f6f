// Windowed + global attention forward for sm_90a, with a plain C interface
// (loaded through ctypes by recformer_tpu_torch/ops/window_attention.py,
// which holds the design note and the plain PyTorch version). Optional
// attention dropout on the un-normalised exponentials uses the keep mask of
// band_common.cuh, which the backward kernel regenerates.
//
// Operands, all row-major and contiguous:
//   q, k, v, out : (B, L, H*D)   float or bf16
//   keyloc, mrow : (B, L)        int32 (keyloc 1 = local key; mrow in {0,1,2})
//   gk, gv, gout : (B, G, H*D)   float or bf16; G may be 0 (no global column)
//   gvalid       : (B, G)        int32
//
// Two kernels compute the same function; the entry point picks by dtype and
// shape:
// - band_attention_fwd_tc_kernel<W>: bf16 with D == 64, W in {64, 128} (the
//   Recformer-base shapes at 64, ModernBERT's local layers at 128), G <= 8
//   (band_attention_fwd_path); its operands must be 16-byte aligned, which
//   the wrapper ensures. Tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   accumulate). One block of 8 warps per 128 query rows of one (batch,
//   head), so every K/V row is staged (128 + W) / 128 times; a warp owns 16
//   rows and the 16 + W band keys they can see, plus, when G > 0, one 8-wide
//   tile of global keys (read at run time: zero-filled, and its products
//   skipped, when G == 0). The block stages with cp.async in two groups (Q and
//   K, then V), zero-filling rows off [0, L) without reading them, so V
//   arrives while the scores are computed; the exponentials are packed to
//   bf16 pairs before P.V, which frees their fp32 registers for the output;
//   the output leaves through shared memory in 16-byte stores. Two blocks
//   fit on an SM at either W (79 KB / 96 KB of shared memory, 128 registers
//   a thread). Bytes bound the function (about 4*D flops per pair against
//   8*D bytes per row and head), but the kernel is held back inside the SM:
//   a persistent grid of one block per SM that prefetched the next tile into
//   a second stage ran slower (PERF.md), since 8 warps an SM cannot hide the
//   latency of the score arithmetic.
// - band_attention_fwd_kernel: every other shape and float32. CUDA cores; a
//   warp owns one query row at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_common.cuh"
#include "band_mma.cuh"

namespace {

using band::Dropout;
using band::from_float;
using band::kMaxSmem;
using band::kNegInf;
using band::round_to;
using band::to_float;
using band::warp_max;
using band::warp_sum;

// ---------------------------------------------------------------------------
// CUDA-core kernel: any D in {8,16,32,64,128}, any window, float or bf16
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
band_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int32_t* __restrict__ keyloc,
                          const T* __restrict__ gk, const T* __restrict__ gv,
                          const int32_t* __restrict__ gvalid,
                          const int32_t* __restrict__ mrow, const T* __restrict__ gout,
                          T* __restrict__ out, int L, int H, int G, int window,
                          int tile_q, float scale, int fuse_epilogue, Dropout drop) {
  drop = band::resolve(drop);
  constexpr int DP = D + 1;  // padded row stride (in floats) of the K/V band
  const int HD = H * D;
  const int half = window / 2;
  const int ncol = window + 1 + G;  // band columns, then global columns
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * tile_q;
  const int t1 = min(t0 + tile_q, L);
  const int lo = max(t0 - half, 0);  // the tile's band: rows [lo, hi)
  const int hi = min(t1 + half, L);
  const int nband = hi - lo;
  const int band_cap = tile_q + window;

  extern __shared__ float smem[];
  float* ks = smem;                    // (band_cap, DP)
  float* vs = ks + band_cap * DP;      // (band_cap, DP)
  float* gks = vs + band_cap * DP;     // (G, DP)
  float* gvs = gks + G * DP;           // (G, DP)
  float* qs = gvs + G * DP;            // (kWarps, D) scaled query row per warp
  float* ps = qs + kWarps * D;         // (kWarps, ncol) scores, then exponentials
  int* kl = reinterpret_cast<int*>(ps + kWarps * ncol);  // (band_cap) keyloc

  const size_t head_base = (size_t)b * L * HD + (size_t)h * D;
  for (int idx = threadIdx.x; idx < nband * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    const size_t off = head_base + (size_t)(lo + r) * HD + d;
    ks[r * DP + d] = to_float(k[off]);
    vs[r * DP + d] = to_float(v[off]);
  }
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx - g * D;
    const size_t off = ((size_t)b * G + g) * HD + (size_t)h * D + d;
    gks[g * DP + d] = to_float(gk[off]);
    gvs[g * DP + d] = to_float(gv[off]);
  }
  for (int r = threadIdx.x; r < nband; r += blockDim.x) kl[r] = keyloc[(size_t)b * L + lo + r];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * D;
  float* pw = ps + warp * ncol;

  for (int i = t0 + warp; i < t1; i += kWarps) {
    const size_t row = head_base + (size_t)i * HD;
    // q * scale rounds to the input type, as the TPU kernel computes it
    for (int d = lane; d < D; d += 32) qw[d] = round_to<T>(to_float(q[row + d]) * scale);
    __syncwarp();

    // band column c holds key j = i - half + c; it counts iff j is in [0, L)
    // and a local key (the global position enters once, as a global column)
    float mx = kNegInf;
    for (int c = lane; c < ncol; c += 32) {
      float s = kNegInf;
      if (c <= window) {
        const int j = i - half + c;
        if (j >= lo && j < hi && kl[j - lo] != 0) {
          const float* kr = ks + (j - lo) * DP;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) acc = fmaf(qw[d], kr[d], acc);
          s = acc;
        }
      } else {
        const int g = c - window - 1;
        if (gvalid[(size_t)b * G + g] != 0) {
          const float* kr = gks + g * DP;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) acc = fmaf(qw[d], kr[d], acc);
          s = acc;
        }
      }
      pw[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);

    // the row sum takes the float32 exponentials; the product with V takes
    // them after dropout (kept ones scaled by 1/(1-rate)) and the cast to the
    // input type
    float sum = 0.f;
    for (int c = lane; c < ncol; c += 32) {
      float e = expf(pw[c] - mx);
      sum += e;
      if (drop.on) {
        // columns off [0, L) carry no key and are never read below
        const int col = c <= window ? i - half + c : L + c - window - 1;
        if (c > window || (col >= 0 && col < L))
          e = band::dropout_keep(drop, b, h, i, col) ? e * drop.scale : 0.f;
      }
      pw[c] = round_to<T>(e);
    }
    const float denom = fmaxf(warp_sum(sum), 1e-30f);
    __syncwarp();

    const int c_lo = max(0, lo - (i - half));
    const int c_hi = min(window, hi - 1 - (i - half));
    const int mr = fuse_epilogue ? mrow[(size_t)b * L + i] : 1;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int c = c_lo; c <= c_hi; ++c) acc = fmaf(pw[c], vs[(i - half + c - lo) * DP + d], acc);
      for (int g = 0; g < G; ++g) acc = fmaf(pw[window + 1 + g], gvs[g * DP + d], acc);
      float o = acc / denom;
      if (mr == 2) {
        o = to_float(gout[(size_t)b * G * HD + (size_t)h * D + d]);
      } else if (mr != 1) {
        o = 0.f;
      }
      out[row + d] = from_float<T>(o);
    }
    __syncwarp();
  }
}

int simt_smem_bytes(int tile_q, int window, int G, int D) {
  const int rows = tile_q + window;
  return 4 * (2 * rows + 2 * G) * (D + 1) + 4 * kWarps * D + 4 * kWarps * (window + 1 + G) +
         4 * rows;
}

template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* keyloc,
                        const void* gk, const void* gv, const void* gvalid, const void* mrow,
                        const void* gout, void* out, int B, int L, int H, int G, int window,
                        float scale, int fuse, Dropout drop, cudaStream_t stream) {
  // the largest tile (up to 64 rows) whose band fits in shared memory
  int tile_q = 64;
  while (tile_q > 8 && simt_smem_bytes(tile_q, window, G, D) > kMaxSmem) tile_q /= 2;
  const int smem = simt_smem_bytes(tile_q, window, G, D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = band_attention_fwd_kernel<T, D>;
  // above 48 KB a block needs the opt-in; the base band in float32 is ~66 KB
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + tile_q - 1) / tile_q, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(keyloc), static_cast<const T*>(gk),
      static_cast<const T*>(gv), static_cast<const int32_t*>(gvalid),
      static_cast<const int32_t*>(mrow), static_cast<const T*>(gout), static_cast<T*>(out),
      L, H, G, window, tile_q, scale, fuse, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_simt(int D, const void* q, const void* k, const void* v,
                          const void* keyloc, const void* gk, const void* gv,
                          const void* gvalid, const void* mrow, const void* gout, void* out,
                          int B, int L, int H, int G, int window, float scale, int fuse,
                          Dropout drop, cudaStream_t stream) {
#define BAND_ATTN_CASE(DIM)                                                                \
  case DIM:                                                                                \
    return launch_simt<T, DIM>(q, k, v, keyloc, gk, gv, gvalid, mrow, gout, out, B, L, H, \
                               G, window, scale, fuse, drop, stream);
  switch (D) {
    BAND_ATTN_CASE(8)
    BAND_ATTN_CASE(16)
    BAND_ATTN_CASE(32)
    BAND_ATTN_CASE(64)
    BAND_ATTN_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef BAND_ATTN_CASE
}

// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16, D == 64, W in {64, 128}
// ---------------------------------------------------------------------------

template <int W_>
struct Tc {
  static constexpr int D = 64;
  static constexpr int W = W_;
  static constexpr int HALF = W / 2;
  static constexpr int WARPS = 8;
  static constexpr int TILE = 16 * WARPS;      // query rows per block
  static constexpr int BAND = TILE + W;        // band rows per block
  static constexpr int NT = (16 + W) / 8;      // 8-key tiles one warp's 16 rows can see
  static constexpr int GMAX = 8;               // global keys: one 8-wide tile
  static constexpr int GPAD = 16;              // global rows padded to one k-step of P.V
  static constexpr int S = D + 8;              // smem row stride (bf16): 144 B, ldmatrix without conflicts
  static constexpr int CH = D / 8;             // 16-byte chunks per row
  static constexpr int SMEM = (TILE + 2 * BAND + 2 * GPAD) * S * 2 + BAND * 4;
  static_assert(NT % 2 == 0, "P.V takes the band in 16-key steps");
};

template <int W_, bool GLOBALS>
__global__ void __launch_bounds__(Tc<W_>::WARPS * 32, 2)
band_attention_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const int32_t* __restrict__ keyloc,
                             const __nv_bfloat16* __restrict__ gk,
                             const __nv_bfloat16* __restrict__ gv,
                             const int32_t* __restrict__ gvalid,
                             const int32_t* __restrict__ mrow,
                             const __nv_bfloat16* __restrict__ gout,
                             __nv_bfloat16* __restrict__ out, int L, int H, int G, float scale,
                             int fuse_epilogue, Dropout drop) {
  drop = band::resolve(drop);
  using T = Tc<W_>;
  constexpr int D = T::D, W = T::W, HALF = T::HALF, TILE = T::TILE, BAND = T::BAND;
  constexpr int NT = T::NT, GPAD = T::GPAD, S = T::S, CH = T::CH;
  using bf16 = __nv_bfloat16;
  const int HD = H * D;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int lo = t0 - HALF;  // band row 0 holds key lo (may lie before 0)
  // GLOBALS: G >= 1 is known when compiling; otherwise G (0 or more) is
  // read at run time
  const bool globals = GLOBALS || G > 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (TILE, S) scaled queries, then the output
  bf16* ks = qs + TILE * S;                       // (BAND, S)
  bf16* vs = ks + BAND * S;                       // (BAND, S)
  bf16* gks = vs + BAND * S;                      // (GPAD, S)
  bf16* gvs = gks + GPAD * S;                     // (GPAD, S)
  int* kl = reinterpret_cast<int*>(gvs + GPAD * S);  // (BAND) keyloc, 0 outside [0, L)

  // stage with cp.async in two groups: Q, K and the global keys first, V
  // and the global values behind them, so that V arrives while the scores
  // are computed. Rows outside [0, L) (and global rows >= G) are zero-filled
  // by the copy without reading memory; with no global column the source
  // address is q's (gk may be null), never read.
  const size_t head = (size_t)b * L * HD + (size_t)h * D;
  const size_t ghead = globals ? (size_t)b * G * HD + (size_t)h * D : head;
  const bf16* gk_ = globals ? gk : q;
  const bf16* gv_ = globals ? gv : q;
  for (int c = threadIdx.x; c < TILE * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8, i = t0 + r;
    band::cp_async16(qs + r * S + col, q + head + (size_t)(i < L ? i : 0) * HD + col, i < L);
  }
  for (int c = threadIdx.x; c < BAND * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8, j = lo + r;
    const bool ok = j >= 0 && j < L;
    band::cp_async16(ks + r * S + col, k + head + (size_t)(ok ? j : 0) * HD + col, ok);
  }
  for (int c = threadIdx.x; c < GPAD * CH; c += blockDim.x) {
    const int g = c / CH, col = (c % CH) * 8;
    band::cp_async16(gks + g * S + col, gk_ + ghead + (size_t)(g < G ? g : 0) * HD + col, g < G);
  }
  band::cp_async_commit();
  for (int c = threadIdx.x; c < BAND * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8, j = lo + r;
    const bool ok = j >= 0 && j < L;
    band::cp_async16(vs + r * S + col, v + head + (size_t)(ok ? j : 0) * HD + col, ok);
  }
  for (int c = threadIdx.x; c < GPAD * CH; c += blockDim.x) {
    const int g = c / CH, col = (c % CH) * 8;
    band::cp_async16(gvs + g * S + col, gv_ + ghead + (size_t)(g < G ? g : 0) * HD + col, g < G);
  }
  band::cp_async_commit();
  for (int r = threadIdx.x; r < BAND; r += blockDim.x) {
    const int j = lo + r;
    kl[r] = (j >= 0 && j < L) ? keyloc[(size_t)b * L + j] : 0;
  }
  band::cp_async_wait<1>();
  // q * scale rounds to bf16, as the TPU kernel computes it; each thread
  // scales the chunks it copied
  for (int c = threadIdx.x; c < TILE * CH; c += blockDim.x)
    if (t0 + c / CH < L) band::scale_chunk(qs + (c / CH) * S + (c % CH) * 8, scale);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // this thread's rows in the warp's 16: gq and gq + 8
  const int tq = lane & 3;   // and its column pair in each 8-wide tile: 2tq, 2tq + 1
  const int r0 = warp * 16;  // the warp's first query row in the tile; its keys are band rows r0.. r0+15+W

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    band::ldsm_x4(qa[kc], qs + (r0 + (lane & 15)) * S + kc * 16 + (lane >> 4) * 8);

  // scores: NT band tiles and (with global columns) one global tile, fp32
  float sc[NT][4];
  float sg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    const bf16* kb = ks + (r0 + nt * 8 + (lane & 7)) * S + (lane >> 3) * 8;
#pragma unroll
    for (int dc = 0; dc < D / 32; ++dc) {
      uint32_t bk[4];
      band::ldsm_x4(bk, kb + dc * 32);
      band::mma_bf16(sc[nt], qa[2 * dc], bk[0], bk[1]);
      band::mma_bf16(sc[nt], qa[2 * dc + 1], bk[2], bk[3]);
    }
  }
  if (globals) {
    const bf16* kb = gks + (lane & 7) * S + (lane >> 3) * 8;
#pragma unroll
    for (int dc = 0; dc < D / 32; ++dc) {
      uint32_t bk[4];
      band::ldsm_x4(bk, kb + dc * 32);
      band::mma_bf16(sg, qa[2 * dc], bk[0], bk[1]);
      band::mma_bf16(sg, qa[2 * dc + 1], bk[2], bk[3]);
    }
  }

  // mask: query row r0+rr sees band column c (key lo + r0 + c) iff
  // |rr + HALF - c| <= HALF and the key is a local key in [0, L)
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c0 = nt * 8 + 2 * tq;
    const int2 kp = *reinterpret_cast<const int2*>(kl + r0 + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = gq + (e >> 1) * 8;
      const int c = c0 + (e & 1);
      const bool ok = c >= rr && c <= rr + W && ((e & 1) ? kp.y : kp.x) != 0;
      sc[nt][e] = ok ? sc[nt][e] : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int g = 2 * tq + (e & 1);
    const bool ok = g < G && gvalid[(size_t)b * G + g] != 0;
    sg[e] = ok ? sg[e] : kNegInf;
    mx[e >> 1] = fmaxf(mx[e >> 1], sg[e]);
  }
  // a row's columns are spread over the 4 threads of a quad
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
  }
  // the row sum takes the fp32 exponentials; P.V takes them rounded to bf16
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[nt][e] = band::exp_diff(sc[nt][e], mx[e >> 1]);
      sum[e >> 1] += sc[nt][e];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sg[e] = band::exp_diff(sg[e], mx[e >> 1]);
    sum[e >> 1] += sg[e];
  }
  float inv[2];  // 1 / the clamped row sum
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 1);
    sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 2);
    inv[x] = 1.f / fmaxf(sum[x], 1e-30f);
  }

  // dropout on the exponentials after the row sum: kept ones scaled by
  // 1/(1-rate); one Philox call per four adjacent columns of a row. A band
  // column off [0, L) meets a zero V row, so its bit is never seen.
  if (drop.on) {
    const int i0 = t0 + r0 + gq;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bool kp[4];
      band::keep_quad(drop, b, h, i0, i0 + 8, lo + r0 + nt * 8 + 2 * tq, tq, kp);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = kp[e] ? sc[nt][e] * drop.scale : 0.f;
    }
    if (globals) {
      bool kp[4];
      band::keep_global(drop, b, h, i0, i0 + 8, L, tq, kp);
#pragma unroll
      for (int e = 0; e < 4; ++e) sg[e] = kp[e] ? sg[e] * drop.scale : 0.f;
    }
  }

  // the score tiles of 16 keys are, register for register, the A fragments
  // of P.V: packed to bf16 pairs once
  uint32_t pa[NT / 2][4];
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    pa[kk][0] = band::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
    pa[kk][1] = band::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
    pa[kk][2] = band::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
    pa[kk][3] = band::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
  }

  band::cp_async_wait<0>();
  __syncthreads();

  // out = P.V
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const bf16* vb = vs + (r0 + kk * 16 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      band::ldsm_x4_trans(bv, vb + dp * 16);
      band::mma_bf16(o[2 * dp], pa[kk], bv[0], bv[1]);
      band::mma_bf16(o[2 * dp + 1], pa[kk], bv[2], bv[3]);
    }
  }
  if (globals) {
    const uint32_t a[4] = {band::pack_bf16(sg[0], sg[1]), band::pack_bf16(sg[2], sg[3]), 0u, 0u};
    const bf16* vb = gvs + (lane & 15) * S + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      band::ldsm_x4_trans(bv, vb + dp * 16);
      band::mma_bf16(o[2 * dp], a, bv[0], bv[1]);
      band::mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
    }
  }

  // divide and fused epilogue into the warp's own 16 rows of qs (only this
  // warp read them), then 16-byte stores of whole rows; a mask == 2 row
  // (only with global columns) takes its global row
  bf16* ow = qs + r0 * S;
  const bf16* grow = gout + ghead;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int i = t0 + r0 + gq + 8 * x;
    const int mr = (fuse_epilogue && i < L) ? mrow[(size_t)b * L + i] : 1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * tq;
      float v0 = o[dt][2 * x] * inv[x];
      float v1 = o[dt][2 * x + 1] * inv[x];
      if (mr == 2 && globals) {
        v0 = __bfloat162float(grow[col]);
        v1 = __bfloat162float(grow[col + 1]);
      } else if (mr != 1) {
        v0 = v1 = 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(ow + (gq + 8 * x) * S + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, col = (c % CH) * 8, i = t0 + r0 + r;
    if (i < L)
      *reinterpret_cast<uint4*>(out + head + (size_t)i * HD + col) =
          *reinterpret_cast<const uint4*>(ow + r * S + col);
  }
}

template <int W, bool GLOBALS>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* keyloc,
                      const void* gk, const void* gv, const void* gvalid, const void* mrow,
                      const void* gout, void* out, int B, int L, int H, int G, float scale,
                      int fuse, Dropout drop, cudaStream_t stream) {
  using T = Tc<W>;
  auto kernel = band_attention_fwd_tc_kernel<W, GLOBALS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((L + T::TILE - 1) / T::TILE, H, B);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, T::WARPS * 32, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int32_t*>(keyloc), static_cast<const bf16*>(gk),
      static_cast<const bf16*>(gv), static_cast<const int32_t*>(gvalid),
      static_cast<const int32_t*>(mrow), static_cast<const bf16*>(gout),
      static_cast<bf16*>(out), L, H, G, scale, fuse, drop);
  return cudaGetLastError();
}

bool tc_shape(int dtype, int D, int G, int window) {
  return dtype == 1 && D == Tc<64>::D && (window == 64 || window == 128) && G <= Tc<64>::GMAX;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Which kernel band_attention_fwd launches for these sizes: 1 the
// tensor-core kernel (bf16, D == 64, W in {64, 128}, G <= 8), 0 the
// CUDA-core one.
extern "C" int band_attention_fwd_path(int dtype, int D, int G, int window) {
  return tc_shape(dtype, D, G, window) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16; G = 0 means no global column (gk, gv,
// gvalid and gout are then never read). Dropout (band_common.cuh) is on when
// ``dropout`` is non-zero; its seed is ``seed``, or the one at ``seed_at`` in
// device memory where that is not null. Returns the launch's cudaError_t.
// The tensor-core kernel takes 16-byte aligned operands and returns
// cudaErrorMisalignedAddress otherwise.
extern "C" int band_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                  const void* keyloc, const void* gk, const void* gv,
                                  const void* gvalid, const void* mrow, const void* gout,
                                  void* out, int B, int L, int H, int D, int G, int window,
                                  float scale, int fuse_epilogue, int dropout, uint32_t seed,
                                  const void* seed_at, uint32_t threshold, float drop_scale,
                                  void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G < 0 || window <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, drop_scale, dropout != 0,
                     static_cast<const uint32_t*>(seed_at)};
  if (tc_shape(dtype, D, G, window)) {
    for (const void* p : {q, k, v, static_cast<const void*>(out)})
      if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
    if (G > 0 && (!aligned16(gk) || !aligned16(gv))) return (int)cudaErrorMisalignedAddress;
    // W 64 with global columns (Recformer-base) compiles them in; the rest
    // reads G at run time (measured faster at W 128, where the compile-time
    // forms spill more registers)
    auto launch = window == 128 ? &launch_tc<128, false>
                                : (G > 0 ? &launch_tc<64, true> : &launch_tc<64, false>);
    return (int)launch(q, k, v, keyloc, gk, gv, gvalid, mrow, gout, out, B, L, H, G, scale,
                       fuse_epilogue, drop, s);
  }
  if (dtype == 0)
    return (int)dispatch_simt<float>(D, q, k, v, keyloc, gk, gv, gvalid, mrow, gout, out, B,
                                     L, H, G, window, scale, fuse_epilogue, drop, s);
  if (dtype == 1)
    return (int)dispatch_simt<__nv_bfloat16>(D, q, k, v, keyloc, gk, gv, gvalid, mrow, gout,
                                             out, B, L, H, G, window, scale, fuse_epilogue,
                                             drop, s);
  return (int)cudaErrorInvalidValue;
}
