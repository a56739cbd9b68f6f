// Two timing probes of the band-attention forward for sm_90a, with a plain C
// interface (loaded through ctypes by recformer_tpu_torch/ops/band_probes.py,
// which defines both functions and holds their plain PyTorch versions).
//
// - band_ablation_kernel<MASK, SOFTMAX, GLOBALS> replaces
//   benchmarks/kernel_ablation.py::kern: kernel 1's band forward with parts
//   removed. Each variant is one instantiation of one body, so the
//   differences between their times are the costs of the parts:
//     dots_only <0,0,0>, no_softmax <1,0,0>, no_mask <0,1,0>,
//     band_softmax <1,1,0>, full <1,1,1>.
// - band_headpair_kernel<PAIR> replaces benchmarks/headpair_probe.py::perhead
//   (PAIR = false) and pair (PAIR = true).
//
// Operands, row-major, contiguous, bf16 and 16-byte aligned:
//   ablation: q, out (B, L, H*64); kpad, vpad (B, L + W, H*64);
//             keyloc (B, L + W) int32; gk (B, G, H*64); gvalid (B, G) int32
//   head pair: q, k, v, out (B, L, P*128), each 128 lanes two 64-wide heads
//
// Design (a right, simple one; making it fast is later work): tensor cores
// through mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the ldmatrix
// helpers of band_mma.cuh, as kernel 1's tensor-core forward. A block of 8
// warps owns 128 query rows of one (batch, head) or (batch, head pair), a
// warp 16 rows; block_q is a multiple of 16, so a warp's rows lie in one
// query block and share its band. The block stages with cp.async, in two
// groups (Q and K, then V), every band row its warps can see, once: at most
// max(block_q, 128) + W rows (320 at block_q = 256). V's arrival overlaps
// the first chunk's scores.
//
// A warp walks its band in chunks of columns. The ablation takes chunks of
// 80 keys (ten 8-key tiles: at block_q = 16 the whole band, the tile one
// warp of kernel 1 holds); a band of block_q + W = 320 keys (block_q = 256)
// would take 160 score registers a thread in one piece. The softmax
// variants keep an online row max and sum across chunks: each chunk's
// exponentials are taken against the running max, rounded to bf16 for P.V,
// and the accumulator and sum are rescaled when the max grows; the
// division by max(sum, 1e-30) comes last. The TPU kernel normalises first
// and rounds after; the two round at different points, which differs only
// within bf16 rounding (each P element once, relative 2^-9). The -1e30 mask
// value passes through the bf16 cast (no_softmax) exactly as
// torch.tensor(-1e30).bfloat16() rounds it. A row whose every column is
// masked (and, for full, every global invalid) gets e = 1 on each column, as
// the TPU kernel's exp(s - m) does.
//
// The head-pair kernels take chunks of 32 keys. perhead contracts each
// head's 64 lanes in turn (4 k-steps a score tile). pair contracts all 128
// lanes (8 k-steps) against a block-diagonal K of twice the columns (head
// 0's keys with lanes 64..127 zero, then head 1's with lanes 0..63 zero),
// and multiplies the scores by a block-diagonal V that lands head 0 in
// lanes 0..63 and head 1 in lanes 64..127: the operands are formed in
// shared memory from the staged band rows and a 16-row tile of zeros, which
// ldmatrix reads for the off-diagonal blocks, so every product of the TPU's
// pair form, zeros included, is issued (twice perhead's MMAs).
//
// What bounds both functions on the H100: about 4*64 flops per (query, key)
// pair against 8*64 bytes of q/k/v/out per row and head, so HBM bytes
// (PERF.md has the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_common.cuh"
#include "band_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using band::kMaxSmem;
using band::kNegInf;

constexpr int D = 64;           // head width
constexpr int WARPS = 8;
constexpr int TILE = 16 * WARPS;  // query rows per block
constexpr int GMAX = 8;         // global keys: one 8-wide tile
constexpr int S = D + 8;        // smem row stride (bf16) of one head: 144 B, no ldmatrix conflicts
constexpr int CH = D / 8;       // 16-byte chunks of a head row
constexpr int CT = 10;          // 8-key tiles per chunk of the ablation's band (80 keys)
constexpr int S2 = 2 * D + 8;   // smem row stride (bf16) of a head pair: 272 B, no conflicts
constexpr int CH2 = 2 * D / 8;  // 16-byte chunks of a pair row
constexpr int PK = 32;          // keys per chunk of the head-pair band
constexpr int ZROWS = 16;       // rows of the zero tile

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// The first row of the last warp of the block starting at t0 that has rows.
__host__ __device__ inline int last_warp_row(int t0, int L) { return imin(t0 + TILE, L) - 16; }

// Padded K/V rows [lo, hi) the ablation block starting at query row t0 sees:
// query block i reads padded rows [i*bq, i*bq + bq + W).
__host__ __device__ inline void ablation_span(int t0, int L, int bq, int W, int& lo, int& hi) {
  lo = (t0 / bq) * bq;
  hi = (last_warp_row(t0, L) / bq) * bq + bq + W;
}

// The head-pair band of query block i: band = min(bq + W, L) rows from
// clamp(i*bq - W/2, 0, L - band).
__host__ __device__ inline int headpair_offset(int i, int bq, int W, int L, int band) {
  const int off = i * bq - W / 2;
  return off < 0 ? 0 : (off > L - band ? L - band : off);
}

__host__ __device__ inline void headpair_span(int t0, int L, int bq, int W, int band, int& lo,
                                              int& hi) {
  lo = headpair_offset(t0 / bq, bq, W, L, band);
  hi = headpair_offset(last_warp_row(t0, L) / bq, bq, W, L, band) + band;
}

// ---------------------------------------------------------------------------
// kernel 6: the ablation
// ---------------------------------------------------------------------------

template <bool MASK, bool SOFTMAX, bool GLOBALS>
__global__ void __launch_bounds__(WARPS * 32)
band_ablation_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kpad,
                     const bf16* __restrict__ vpad, const int32_t* __restrict__ keyloc,
                     const bf16* __restrict__ gk, const int32_t* __restrict__ gvalid,
                     bf16* __restrict__ out, int L, int H, int G, int W, int bq, int rows_cap) {
  const int HD = H * D;
  const int Lp = L + W;
  const int band = bq + W;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  int lo, hi;
  ablation_span(t0, L, bq, W, lo, hi);
  const int nrows = hi - lo;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (TILE, S) queries, then the output
  bf16* ks = qs + TILE * S;                       // (rows_cap, S) padded key rows [lo, hi)
  bf16* vs = ks + rows_cap * S;                   // (rows_cap, S)
  bf16* gks = vs + rows_cap * S;                  // (GMAX, S) global keys, rows >= G zero
  int* kl = reinterpret_cast<int*>(gks + GMAX * S);  // (rows_cap) keyloc of [lo, hi)

  const size_t qhead = (size_t)b * L * HD + (size_t)h * D;
  const size_t khead = (size_t)b * Lp * HD + (size_t)h * D;
  for (int c = threadIdx.x; c < TILE * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8, i = t0 + r;
    band::cp_async16(qs + r * S + col, q + qhead + (size_t)(i < L ? i : 0) * HD + col, i < L);
  }
  for (int c = threadIdx.x; c < nrows * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8;
    band::cp_async16(ks + r * S + col, kpad + khead + (size_t)(lo + r) * HD + col, true);
  }
  if constexpr (GLOBALS) {
    const size_t ghead = (size_t)b * G * HD + (size_t)h * D;
    for (int c = threadIdx.x; c < GMAX * CH; c += blockDim.x) {
      const int g = c / CH, col = (c % CH) * 8;
      band::cp_async16(gks + g * S + col, gk + ghead + (size_t)(g < G ? g : 0) * HD + col,
                       g < G);
    }
  }
  band::cp_async_commit();
  for (int c = threadIdx.x; c < nrows * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8;
    band::cp_async16(vs + r * S + col, vpad + khead + (size_t)(lo + r) * HD + col, true);
  }
  band::cp_async_commit();
  if constexpr (MASK)
    for (int r = threadIdx.x; r < nrows; r += blockDim.x) kl[r] = keyloc[(size_t)b * Lp + lo + r];
  band::cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // this thread's rows in the warp's 16: gq and gq + 8
  const int tq = lane & 3;   // and its column pair in each 8-wide tile: 2tq, 2tq + 1
  const int r0 = warp * 16;
  const int tw = t0 + r0;    // the warp's first query row
  const bool active = tw < L;
  const int iw = (active ? tw : t0) / bq;  // its query block
  const int tt0 = tw - iw * bq;            // its first row's place in the block
  const int boff = iw * bq - lo;           // smem row of its band's column 0

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    band::ldsm_x4(qa[kc], qs + (r0 + (lane & 15)) * S + kc * 16 + (lane >> 4) * 8);

  float m[2] = {kNegInf, kNegInf};  // running row max (softmax variants)
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  if constexpr (GLOBALS) {
    // the global scores enter the max and the sum, never P.V
    if (active) {
      float sg[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kb = gks + (lane & 7) * S + (lane >> 3) * 8;
#pragma unroll
      for (int dc = 0; dc < D / 32; ++dc) {
        uint32_t bk[4];
        band::ldsm_x4(bk, kb + dc * 32);
        band::mma_bf16(sg, qa[2 * dc], bk[0], bk[1]);
        band::mma_bf16(sg, qa[2 * dc + 1], bk[2], bk[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = 2 * tq + (e & 1);
        sg[e] = (g < G && gvalid[(size_t)b * G + g] != 0) ? sg[e] : kNegInf;
        if (g < G) m[e >> 1] = fmaxf(m[e >> 1], sg[e]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        m[x] = fmaxf(m[x], __shfl_xor_sync(0xffffffffu, m[x], 1));
        m[x] = fmaxf(m[x], __shfl_xor_sync(0xffffffffu, m[x], 2));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (2 * tq + (e & 1) < G) l[e >> 1] += band::exp_diff(sg[e], m[e >> 1]);
    }
  }

  for (int c0 = 0; c0 < band; c0 += CT * 8) {
    const int ncol = imin(CT * 8, band - c0);  // a multiple of 16
    float sc[CT][4];
    if (active) {
#pragma unroll
      for (int nt = 0; nt < CT; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        if (nt * 8 < ncol) {
          const bf16* kb = ks + (boff + c0 + nt * 8 + (lane & 7)) * S + (lane >> 3) * 8;
#pragma unroll
          for (int dc = 0; dc < D / 32; ++dc) {
            uint32_t bk[4];
            band::ldsm_x4(bk, kb + dc * 32);
            band::mma_bf16(sc[nt], qa[2 * dc], bk[0], bk[1]);
            band::mma_bf16(sc[nt], qa[2 * dc + 1], bk[2], bk[3]);
          }
        }
      }
      if constexpr (MASK) {
        // query row tt (in its block) sees band column u iff
        // |tt - (u - W/2)| <= W/2, i.e. u in [tt, tt + W], and keyloc != 0
#pragma unroll
        for (int nt = 0; nt < CT; ++nt) {
          if (nt * 8 < ncol) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int tt = tt0 + gq + (e >> 1) * 8;
              const int u = c0 + nt * 8 + 2 * tq + (e & 1);
              const bool ok = u >= tt && u <= tt + W && kl[boff + u] != 0;
              sc[nt][e] = ok ? sc[nt][e] : kNegInf;
            }
          }
        }
      }
      if constexpr (SOFTMAX) {
        float cm[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int nt = 0; nt < CT; ++nt)
          if (nt * 8 < ncol)
#pragma unroll
            for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], sc[nt][e]);
        float alpha[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          cm[x] = fmaxf(cm[x], __shfl_xor_sync(0xffffffffu, cm[x], 1));
          cm[x] = fmaxf(cm[x], __shfl_xor_sync(0xffffffffu, cm[x], 2));
          const float mn = fmaxf(m[x], cm[x]);
          alpha[x] = band::exp_diff(m[x], mn);  // 1 while every column so far is masked
          m[x] = mn;
          l[x] *= alpha[x];
        }
#pragma unroll
        for (int nt = 0; nt < CT; ++nt)
          if (nt * 8 < ncol)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[nt][e] = band::exp_diff(sc[nt][e], m[e >> 1]);
              l[e >> 1] += sc[nt][e];
            }
        if (c0 > 0)
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            o[dt][0] *= alpha[0];
            o[dt][1] *= alpha[0];
            o[dt][2] *= alpha[1];
            o[dt][3] *= alpha[1];
          }
      }
    }
    if (c0 == 0) {  // V has arrived (every warp takes the same chunks)
      band::cp_async_wait<0>();
      __syncthreads();
    }
    if (active) {
      // the score tiles of 16 keys are, register for register, the A
      // fragments of P.V (rounded to bf16)
#pragma unroll
      for (int kk = 0; kk < CT / 2; ++kk) {
        if (kk * 16 < ncol) {
          const uint32_t a[4] = {band::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                 band::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                 band::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                 band::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
          const bf16* vb = vs + (boff + c0 + kk * 16 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t bv[4];
            band::ldsm_x4_trans(bv, vb + dp * 16);
            band::mma_bf16(o[2 * dp], a, bv[0], bv[1]);
            band::mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
  }
  if (!active) return;

  float inv[2] = {1.f, 1.f};
  if constexpr (SOFTMAX) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
      inv[x] = 1.f / fmaxf(l[x], 1e-30f);
    }
  }
  // into the warp's own 16 rows of qs (only this warp read them), then
  // 16-byte stores of whole rows
  bf16* ow = qs + r0 * S;
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(ow + (gq + 8 * x) * S + dt * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[dt][2 * x] * inv[x], o[dt][2 * x + 1] * inv[x]);
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, col = (c % CH) * 8;
    *reinterpret_cast<uint4*>(out + qhead + (size_t)(tw + r) * HD + col) =
        *reinterpret_cast<const uint4*>(ow + r * S + col);
  }
}

// ---------------------------------------------------------------------------
// kernel 7: the head pair
// ---------------------------------------------------------------------------

template <bool PAIR>
__global__ void __launch_bounds__(WARPS * 32)
band_headpair_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int L, int P, int W,
                     int bq, int rows_cap) {
  const int C = P * 2 * D;
  const int band = imin(bq + W, L);
  const int b = blockIdx.z;
  const int p = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  int lo, hi;
  headpair_span(t0, L, bq, W, band, lo, hi);
  const int nrows = hi - lo;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (TILE, S2) queries, then the output
  bf16* ks = qs + TILE * S2;                      // (rows_cap, S2) key rows [lo, hi)
  bf16* vs = ks + rows_cap * S2;                  // (rows_cap, S2)
  bf16* zs = vs + rows_cap * S2;                  // (ZROWS, S2) zeros: pair's off-diagonal blocks

  const size_t head = (size_t)b * L * C + (size_t)p * 2 * D;
  for (int c = threadIdx.x; c < TILE * CH2; c += blockDim.x) {
    const int r = c / CH2, col = (c % CH2) * 8, i = t0 + r;
    band::cp_async16(qs + r * S2 + col, q + head + (size_t)(i < L ? i : 0) * C + col, i < L);
  }
  for (int c = threadIdx.x; c < nrows * CH2; c += blockDim.x) {
    const int r = c / CH2, col = (c % CH2) * 8;
    band::cp_async16(ks + r * S2 + col, k + head + (size_t)(lo + r) * C + col, true);
  }
  band::cp_async_commit();
  for (int c = threadIdx.x; c < nrows * CH2; c += blockDim.x) {
    const int r = c / CH2, col = (c % CH2) * 8;
    band::cp_async16(vs + r * S2 + col, v + head + (size_t)(lo + r) * C + col, true);
  }
  band::cp_async_commit();
  if constexpr (PAIR)
    for (int c = threadIdx.x; c < ZROWS * S2 / 8; c += blockDim.x)
      reinterpret_cast<uint4*>(zs)[c] = make_uint4(0u, 0u, 0u, 0u);
  band::cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int r0 = warp * 16;
  const int tw = t0 + r0;
  const bool active = tw < L;
  const int boff = headpair_offset((active ? tw : t0) / bq, bq, W, L, band) - lo;
  bf16* ow = qs + r0 * S2;

  if constexpr (!PAIR) {
    // each head's 64 lanes in turn
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t qa[D / 16][4];
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        band::ldsm_x4(qa[kc], qs + (r0 + (lane & 15)) * S2 + hh * D + kc * 16 + (lane >> 4) * 8);
      float o[D / 8][4];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
      for (int c0 = 0; c0 < band; c0 += PK) {
        const int nk = imin(PK, band - c0);  // 32 or 16
        float sc[PK / 8][4];
        if (active) {
#pragma unroll
          for (int nt = 0; nt < PK / 8; ++nt) {
            sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
            if (nt * 8 < nk) {
              const bf16* kb =
                  ks + (boff + c0 + nt * 8 + (lane & 7)) * S2 + hh * D + (lane >> 3) * 8;
#pragma unroll
              for (int dc = 0; dc < D / 32; ++dc) {
                uint32_t bk[4];
                band::ldsm_x4(bk, kb + dc * 32);
                band::mma_bf16(sc[nt], qa[2 * dc], bk[0], bk[1]);
                band::mma_bf16(sc[nt], qa[2 * dc + 1], bk[2], bk[3]);
              }
            }
          }
        }
        if (hh == 0 && c0 == 0) {  // V has arrived
          band::cp_async_wait<0>();
          __syncthreads();
        }
        if (active) {
#pragma unroll
          for (int kk = 0; kk < PK / 16; ++kk) {
            if (kk * 16 < nk) {
              const uint32_t a[4] = {band::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                     band::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                     band::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                     band::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
              const bf16* vb =
                  vs + (boff + c0 + kk * 16 + (lane & 15)) * S2 + hh * D + (lane >> 4) * 8;
#pragma unroll
              for (int dp = 0; dp < D / 16; ++dp) {
                uint32_t bv[4];
                band::ldsm_x4_trans(bv, vb + dp * 16);
                band::mma_bf16(o[2 * dp], a, bv[0], bv[1]);
                band::mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
              }
            }
          }
        }
      }
      if (active) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt)
            *reinterpret_cast<__nv_bfloat162*>(ow + (gq + 8 * x) * S2 + hh * D + dt * 8 +
                                               2 * tq) =
                __floats2bfloat162_rn(o[dt][2 * x], o[dt][2 * x + 1]);
      }
    }
  } else {
    // both heads at once: 128-lane contraction against block-diagonal K,
    // then block-diagonal V
    uint32_t qa[2 * D / 16][4];
#pragma unroll
    for (int kc = 0; kc < 2 * D / 16; ++kc)
      band::ldsm_x4(qa[kc], qs + (r0 + (lane & 15)) * S2 + kc * 16 + (lane >> 4) * 8);
    float o[2 * D / 8][4];
#pragma unroll
    for (int dt = 0; dt < 2 * D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    for (int c0 = 0; c0 < band; c0 += PK) {
      const int nk = imin(PK, band - c0);  // keys of each head; the operand has 2 nk columns
      float sc[2 * PK / 8][4];             // tiles [0, nk/8): head 0's keys, then head 1's
      if (active) {
#pragma unroll
        for (int nt = 0; nt < 2 * PK / 8; ++nt) {
          sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
          if (nt * 8 < 2 * nk) {
            const int hh = nt * 8 >= nk;  // the diagonal block of this column tile
            const bf16* kb =
                ks + (boff + c0 + nt * 8 - hh * nk + (lane & 7)) * S2 + (lane >> 3) * 8;
            const bf16* zb = zs + (lane & 7) * S2 + (lane >> 3) * 8;
#pragma unroll
            for (int dc = 0; dc < 2 * D / 32; ++dc) {  // lanes [32 dc, 32 dc + 32)
              uint32_t bk[4];
              band::ldsm_x4(bk, ((dc >> 1) == hh ? kb : zb) + dc * 32);
              band::mma_bf16(sc[nt], qa[2 * dc], bk[0], bk[1]);
              band::mma_bf16(sc[nt], qa[2 * dc + 1], bk[2], bk[3]);
            }
          }
        }
      }
      if (c0 == 0) {  // V has arrived
        band::cp_async_wait<0>();
        __syncthreads();
      }
      if (active) {
#pragma unroll
        for (int kk = 0; kk < 2 * PK / 16; ++kk) {
          if (kk * 16 < 2 * nk) {
            const uint32_t a[4] = {band::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                   band::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                   band::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                   band::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
            const int hh = kk * 16 >= nk;
            const bf16* vb =
                vs + (boff + c0 + kk * 16 - hh * nk + (lane & 15)) * S2 + (lane >> 4) * 8;
            const bf16* zb = zs + (lane & 15) * S2 + (lane >> 4) * 8;
#pragma unroll
            for (int dp = 0; dp < 2 * D / 16; ++dp) {  // lanes [16 dp, 16 dp + 16)
              uint32_t bv[4];
              band::ldsm_x4_trans(bv, ((dp >> 2) == hh ? vb : zb) + dp * 16);
              band::mma_bf16(o[2 * dp], a, bv[0], bv[1]);
              band::mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
            }
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int dt = 0; dt < 2 * D / 8; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(ow + (gq + 8 * x) * S2 + dt * 8 + 2 * tq) =
              __floats2bfloat162_rn(o[dt][2 * x], o[dt][2 * x + 1]);
    }
  }
  if (!active) return;
  __syncwarp();
  for (int c = lane; c < 16 * CH2; c += 32) {
    const int r = c / CH2, col = (c % CH2) * 8;
    *reinterpret_cast<uint4*>(out + head + (size_t)(tw + r) * C + col) =
        *reinterpret_cast<const uint4*>(ow + r * S2 + col);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

bool shape_ok(int B, int L, int heads, int W, int bq) {
  return B > 0 && L > 0 && heads > 0 && W > 0 && W % 16 == 0 && bq > 0 && bq % 16 == 0 &&
         L % bq == 0;
}

template <bool MASK, bool SOFTMAX, bool GLOBALS>
cudaError_t launch_ablation(const void* q, const void* kpad, const void* vpad,
                            const void* keyloc, const void* gk, const void* gvalid, void* out,
                            int B, int L, int H, int G, int W, int bq, int rows_cap,
                            size_t smem, cudaStream_t stream) {
  auto kernel = band_ablation_kernel<MASK, SOFTMAX, GLOBALS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + TILE - 1) / TILE, H, B);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kpad),
      static_cast<const bf16*>(vpad), static_cast<const int32_t*>(keyloc),
      static_cast<const bf16*>(gk), static_cast<const int32_t*>(gvalid), static_cast<bf16*>(out),
      L, H, G, W, bq, rows_cap);
  return cudaGetLastError();
}

template <bool PAIR>
cudaError_t launch_headpair(const void* q, const void* k, const void* v, void* out, int B,
                            int L, int P, int W, int bq, int rows_cap, size_t smem,
                            cudaStream_t stream) {
  auto kernel = band_headpair_kernel<PAIR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + TILE - 1) / TILE, P, B);
  kernel<<<grid, WARPS * 32, smem, stream>>>(static_cast<const bf16*>(q),
                                             static_cast<const bf16*>(k),
                                             static_cast<const bf16*>(v),
                                             static_cast<bf16*>(out), L, P, W, bq, rows_cap);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 dots_only, 1 no_softmax, 2 no_mask, 3 band_softmax, 4 full
// (ops/band_probes.py::ABLATION_VARIANTS). Returns the launch's cudaError_t;
// cudaErrorInvalidValue for a shape the kernel does not take (block_q not a
// multiple of 16 dividing L, W not a multiple of 16, G outside 1..8, a band
// beyond shared memory), cudaErrorMisalignedAddress for an operand off 16 bytes.
extern "C" int band_ablation(int variant, const void* q, const void* kpad, const void* vpad,
                             const void* keyloc, const void* gk, const void* gvalid, void* out,
                             int B, int L, int H, int G, int W, int bq, void* stream) {
  if (!shape_ok(B, L, H, W, bq) || G < 1 || G > GMAX) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, kpad, vpad, gk, static_cast<const void*>(out)})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  int rows_cap = 0;
  for (int t0 = 0; t0 < L; t0 += TILE) {
    int lo, hi;
    ablation_span(t0, L, bq, W, lo, hi);
    rows_cap = hi - lo > rows_cap ? hi - lo : rows_cap;
  }
  const size_t smem = (size_t)(TILE + 2 * rows_cap + GMAX) * S * 2 + (size_t)rows_cap * 4;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ABLATION(M, SM, GL)                                                                   \
  launch_ablation<M, SM, GL>(q, kpad, vpad, keyloc, gk, gvalid, out, B, L, H, G, W, bq, rows_cap, \
                             smem, s)
  switch (variant) {
    case 0: return (int)ABLATION(false, false, false);
    case 1: return (int)ABLATION(true, false, false);
    case 2: return (int)ABLATION(false, true, false);
    case 3: return (int)ABLATION(true, true, false);
    case 4: return (int)ABLATION(true, true, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ABLATION
}

// variant: 0 perhead, 1 pair (ops/band_probes.py::HEADPAIR_VARIANTS); P head
// pairs of 128 lanes. Returns the launch's cudaError_t, as band_ablation.
extern "C" int band_headpair(int variant, const void* q, const void* k, const void* v,
                             void* out, int B, int L, int P, int W, int bq, void* stream) {
  if (!shape_ok(B, L, P, W, bq)) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const int band = imin(bq + W, L);
  int rows_cap = 0;
  for (int t0 = 0; t0 < L; t0 += TILE) {
    int lo, hi;
    headpair_span(t0, L, bq, W, band, lo, hi);
    rows_cap = hi - lo > rows_cap ? hi - lo : rows_cap;
  }
  const size_t smem = (size_t)(TILE + 2 * rows_cap + ZROWS) * S2 * 2;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return (int)launch_headpair<false>(q, k, v, out, B, L, P, W, bq, rows_cap, smem, s);
    case 1: return (int)launch_headpair<true>(q, k, v, out, B, L, P, W, bq, rows_cap, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
