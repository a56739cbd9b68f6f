// Two timing probes of the band-attention forward for sm_90a, with a plain C
// interface (loaded through ctypes by recformer_tpu_torch/ops/band_probes.py,
// which defines both functions and holds their plain PyTorch versions).
//
// - band_ablation replaces benchmarks/kernel_ablation.py::kern (TPU kernel
//   6): kernel 1's band forward with parts removed. Each variant is one
//   instantiation <MASK, SOFTMAX, GLOBALS> of one body, so the differences
//   between their times are the costs of the parts:
//     dots_only <0,0,0>, no_softmax <1,0,0>, no_mask <0,1,0>,
//     band_softmax <1,1,0>, full <1,1,1>.
// - band_headpair replaces benchmarks/headpair_probe.py::perhead and pair
//   (TPU kernel 7): (q . k^T) . v over each query block's band, the
//   ablation's dots_only on the head-pair band, in the same body.
//
// Operands, row-major, contiguous, 16-byte aligned, bf16 but keyloc/gvalid:
//   ablation: q, out (B, L, H*64); kpad, vpad (B, L + W, H*64);
//             keyloc (B, L + W) int32; gk (B, G, H*64); gvalid (B, G) int32
//   head pair: q, k, v, out (B, L, P*128), each 128 lanes two 64-wide heads
//
// What bounds them on the H100: about 4*64 flops per (query, key) pair
// against 8*64 bytes of q/k/v/out per row and head, so HBM bytes at every
// block_q (at block_q 256 the products are half the byte time at the
// tensor cores' peak). The design keeps bytes moving while the products and
// the softmax run, with Hopper's own tools (hopper_tma.cuh):
//
// - A persistent grid, one block per SM, each walking tiles of query rows:
//   256 rows of one (batch, head) for the ablation, 128 rows of one
//   (batch, head pair) for the head pair. A block is four consumer
//   warpgroups and one producer warp.
// - The producer's one thread stages by TMA, 128-byte swizzled: the tile's
//   Q (two buffers, so the next tile's lands while this one computes;
//   with it the global keys for `full`) and the band under the tile, once,
//   in chunks of 64 key rows through a ring of stages (six for the
//   ablation: K, V and keyloc; three for the head pair: K and V of both
//   heads), each with a "full" mbarrier (TMA bytes) and an "empty" one (one
//   arrival per warpgroup). Tensor maps are 3-D over (B, rows, lanes), so a
//   band never crosses a batch, and rows past the tensor read as zeros.
//   perhead stages each head's 64 lanes as its own box (two boxes a tile);
//   pair stages the pair's 128 lanes in one box of a 5-D map (lanes, rows,
//   head, pair, batch) whose head stride is 128 bytes, landing head 0 then
//   head 1 in the same layout. The two differ only in that, so pair against
//   perhead measures staging granularity; both issue only the per-head
//   products (the TPU form's block-diagonal zeros are not useful work).
// - A consumer warpgroup owns 64 query rows (the ablation's warpgroup w rows
//   64 w; the head pair's w rows 64 (w >> 1) of head w & 1) and, per chunk,
//   takes S = Q.K^T on wgmma m64n64k16 with both operands in shared memory,
//   masks and exponentiates S in registers, and adds P.V on wgmma with P
//   (rounded to bf16) from registers and V from shared memory, then
//   releases the stage. Each product is awaited before its registers are
//   touched again, and the SM's four warpgroups overlap one another's
//   products and elementwise work: a product left in flight across the
//   elementwise code makes the softmax variants spill at the 96 registers
//   a thread of this block gets, and such a build hung at random on the
//   card. The softmax
//   variants keep an online row max and sum (over the quad of threads
//   holding a row); the division by max(sum, 1e-30) comes last. The
//   output goes through shared memory to a TMA store, which drops rows
//   past L.
// - The elementwise work, not the bytes, is what the masked and softmax
//   variants add, so it is cut where the result allows: a chunk inside
//   every row's band skips the per-column band test, and in the masked
//   variants a chunk outside every row's window skips Q.K^T and the
//   per-column work (each score is -1e30, so e is one value a row: 0, or
//   1 on a row with nothing valid so far); P.V still runs on it, as the
//   function needs it for such rows and for no_softmax's -1e30.
// - block_q below 64 or not a multiple of 64: a warpgroup's 64 rows span
//   several query blocks whose bands differ. It walks the union of their
//   bands and excludes, per row, the columns of the other blocks' bands:
//   their P is zero, and the softmax variants leave them out of the max and
//   the sum (-inf, not the -1e30 of a masked key), so a row with no valid
//   key (and, for full, no valid global) averages its own block's band and
//   nothing else, as the TPU kernel's exp(s - m) does. One path serves every
//   block_q; chunks wholly outside a warpgroup's union are not computed.
//
// The TPU kernel normalises before rounding e to bf16; this one rounds the
// unnormalised e, which differs within bf16 rounding (relative 2^-9). The
// -1e30 mask value passes through the bf16 cast (no_softmax) as
// torch.tensor(-1e30).bfloat16() rounds it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "band_common.cuh"
#include "band_mma.cuh"
#include "hopper_tma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using band::kMaxSmem;
using band::kNegInf;

constexpr int D = 64;                    // head width: one 128-byte row
constexpr int WG = 4;                    // consumer warpgroups a block
constexpr int THREADS = WG * 128 + 32;   // and one producer warp
constexpr int MROWS = 64;                // query rows of a warpgroup (wgmma M)
constexpr int KC = 64;                   // keys a chunk (wgmma N of Q.K^T)
constexpr int TILE = 64 * D * 2;         // bytes of a 64-row tile
constexpr int GMAX = 8;                  // global keys: one 8-row tile
constexpr int QBUF = 2;                  // query-tile buffers

enum Kind { kAblation = 0, kPerHead = 1, kPair = 2 };

// Shared memory of each kind, in bytes from a 1024-aligned base:
// Q (QBUF x qbytes), the output tiles (WG x TILE), the global keys
// (ablation: QBUF x 1024), the ring of stages, the mbarriers.
template <int KIND> struct Lay {
  static constexpr int rows = KIND == kAblation ? WG * MROWS : 2 * MROWS;  // query rows a tile
  static constexpr int qbytes = KIND == kAblation ? rows * 128 : 2 * rows * 128;
  static constexpr int nstages = KIND == kAblation ? 6 : 3;
  // ablation stage: K, V, keyloc (256 bytes, padded); head pair: K, V of both heads
  static constexpr int stage = KIND == kAblation ? 2 * TILE + 1024 : 4 * TILE;
  static constexpr int vofs = KIND == kAblation ? TILE : 2 * TILE;
  static constexpr int q = 0;
  static constexpr int o = q + QBUF * qbytes;
  static constexpr int gk = o + WG * TILE;
  static constexpr int stages = gk + (KIND == kAblation ? QBUF * 1024 : 0);
  static constexpr int bars = stages + nstages * stage;
};

struct Bars {
  uint64_t full[6], empty[6], qfull[QBUF], qempty[QBUF];
};

template <int KIND> constexpr int smem_bytes() {
  return Lay<KIND>::bars + static_cast<int>(sizeof(Bars)) + 1024;  // + alignment slack
}

struct Args {
  CUtensorMap q, k, v, kl, gk, out;  // kl, gk: the ablation's only
  const int32_t* gvalid;
  int L, units, G, W, bq;  // units: heads (ablation) or head pairs
  // query block i's band: ``band`` key rows from clamp(i bq - shift, 0, maxoff)
  int band, shift, maxoff;
  int ntile, tiles;  // query tiles a unit, and in all
};

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ int band_start(const Args& a, int i) {
  return imin(imax(i * a.bq - a.shift, 0), a.maxoff);
}

// one tile: its batch, head or pair, first query row, first band row and
// number of 64-row chunks of the union of its query blocks' bands
struct Span {
  int b, unit, t0, c0, nck;
};

__device__ __forceinline__ Span span(const Args& a, int tile, int rows) {
  Span s;
  const int u = tile / a.ntile;
  s.t0 = (tile - u * a.ntile) * rows;
  s.unit = u % a.units;
  s.b = u / a.units;
  s.c0 = band_start(a, s.t0 / a.bq);
  const int c1 = band_start(a, (imin(s.t0 + rows, a.L) - 1) / a.bq) + a.band;
  s.nck = (c1 - s.c0 + KC - 1) / KC;
  return s;
}

// A chunk's scores before the softmax (sc: the accumulator fragment, see
// hopper_tma.cuh): the mask (-1e30 outside the window [t, t + W] or where
// keyloc is 0), then, with OWN_TEST, the columns of another query block's
// band left out (0, or -inf for the softmax). ao and aw place column col of
// a row x: own band iff 0 <= col + ao[x] < band, window iff
// 0 <= col + aw[x] <= W; kls is this thread's first keyloc of the chunk.
template <bool MASK, bool SOFTMAX, bool OWN_TEST>
__device__ __forceinline__ void mask_chunk(float (&sc)[32], const int (&ao)[2], const int (&aw)[2],
                                           const int32_t* kls, int band, int W) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int x = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + (i & 1);
    float v = sc[i];
    if constexpr (MASK) {
      const bool ok =
          static_cast<unsigned>(col + aw[x]) <= static_cast<unsigned>(W) && kls[col] != 0;
      v = ok ? v : kNegInf;
    }
    if constexpr (OWN_TEST) {
      const bool mine = static_cast<unsigned>(col + ao[x]) < static_cast<unsigned>(band);
      v = mine ? v : (SOFTMAX ? -INFINITY : 0.f);
    }
    sc[i] = v;
  }
}

template <int KIND, bool MASK, bool SOFTMAX, bool GLOBALS>
__global__ void __launch_bounds__(THREADS, 1) band_probe_kernel(const __grid_constant__ Args a) {
  using LY = Lay<KIND>;
  constexpr int NS = LY::nstages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  Bars* bars = reinterpret_cast<Bars*>(base + LY::bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hop::mbar_init(&bars->full[s], 1);
      hop::mbar_init(&bars->empty[s], WG);
    }
    for (int s = 0; s < QBUF; ++s) {
      hop::mbar_init(&bars->qfull[s], 1);
      hop::mbar_init(&bars->qempty[s], WG);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG * 128) {
    // ---- the producer: one thread issues every TMA load ----
    if (threadIdx.x != WG * 128) return;
    int s = 0, ph = 0, k = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++k) {
      const Span sp = span(a, tile, LY::rows);
      const int qb = k & 1;
      hop::mbar_wait(&bars->qempty[qb], ((k >> 1) & 1) ^ 1);
      uint8_t* qs = base + LY::q + qb * LY::qbytes;
      uint64_t* qf = &bars->qfull[qb];
      hop::mbar_expect_tx(qf, LY::qbytes + (GLOBALS ? GMAX * 128 : 0));
      if constexpr (KIND == kAblation) {
        hop::tma_load_3d(qs, a.q, qf, sp.unit * D, sp.t0, sp.b);
        if constexpr (GLOBALS)
          hop::tma_load_3d(base + LY::gk + qb * 1024, a.gk, qf, sp.unit * D, 0, sp.b);
      } else if constexpr (KIND == kPerHead) {
        for (int hh = 0; hh < 2; ++hh)
          hop::tma_load_3d(qs + hh * LY::rows * 128, a.q, qf, sp.unit * 2 * D + hh * D, sp.t0,
                           sp.b);
      } else {
        hop::tma_load_5d(qs, a.q, qf, 0, sp.t0, 0, sp.unit, sp.b);
      }
      for (int j = 0; j < sp.nck; ++j) {
        hop::mbar_wait(&bars->empty[s], ph ^ 1);
        uint8_t* st = base + LY::stages + s * LY::stage;
        uint64_t* f = &bars->full[s];
        const int c = sp.c0 + j * KC;
        if constexpr (KIND == kAblation) {
          hop::mbar_expect_tx(f, 2 * TILE + (MASK ? KC * 4 : 0));
          hop::tma_load_3d(st, a.k, f, sp.unit * D, c, sp.b);
          hop::tma_load_3d(st + LY::vofs, a.v, f, sp.unit * D, c, sp.b);
          if constexpr (MASK) hop::tma_load_2d(st + 2 * TILE, a.kl, f, c, sp.b);
        } else if constexpr (KIND == kPerHead) {
          hop::mbar_expect_tx(f, 4 * TILE);
          for (int hh = 0; hh < 2; ++hh) {
            const int lane0 = sp.unit * 2 * D + hh * D;
            hop::tma_load_3d(st + hh * TILE, a.k, f, lane0, c, sp.b);
            hop::tma_load_3d(st + LY::vofs + hh * TILE, a.v, f, lane0, c, sp.b);
          }
        } else {
          hop::mbar_expect_tx(f, 4 * TILE);
          hop::tma_load_5d(st, a.k, f, 0, c, 0, sp.unit, sp.b);
          hop::tma_load_5d(st + LY::vofs, a.v, f, 0, c, 0, sp.unit, sp.b);
        }
        if (++s == NS) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg ----
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;   // this thread's rows in the warp's 16: gq and gq + 8
  const int tq2 = 2 * (lane & 3);  // and its first column of each 8-wide tile
  const int mt = KIND == kAblation ? wg : wg >> 1;  // the warpgroup's 64-row tile
  const int hh = KIND == kAblation ? 0 : wg & 1;    // and its head of the pair

  float o[32];  // the warpgroup's 64x64 output
  int s = 0, ph = 0, k = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++k) {
    const Span sp = span(a, tile, LY::rows);
    const int qb = k & 1;
    const int r0 = sp.t0 + mt * MROWS;
    const bool active = r0 < a.L;
    // the first rows of the first and the last row's bands; the warpgroup
    // walks the chunks that meet [own_first, own_last + band)
    const int own_first = band_start(a, r0 / a.bq);
    const int own_last = band_start(a, (imin(r0 + MROWS, a.L) - 1) / a.bq);
    int trow[2], own[2];  // this thread's two query rows and their bands' first rows
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      trow[x] = r0 + 16 * warp + gq + 8 * x;
      own[x] = band_start(a, trow[x] / a.bq);
    }
    bool gok[2] = {false, false};  // this thread's global columns 2 tq, 2 tq + 1: valid
    if constexpr (GLOBALS) {  // read before the wait, so the load's latency hides
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (tq2 + e < a.G) gok[e] = a.gvalid[static_cast<size_t>(sp.b) * a.G + tq2 + e] != 0;
    }
    hop::mbar_wait(&bars->qfull[qb], (k >> 1) & 1);
    const uint8_t* qs = base + LY::q + qb * LY::qbytes + hh * LY::rows * 128 + mt * TILE;
    const uint64_t dq = hop::desc_sw128(qs);

    float m[2] = {kNegInf, kNegInf};  // running row max (softmax variants)
    float l[2] = {0.f, 0.f};          // this thread's part of the row sum
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;

    if constexpr (GLOBALS) {
      // the global scores enter the max and the sum, never P.V
      if (active) {
        float sg[4];
        const uint64_t dg = hop::desc_sw128(base + LY::gk + qb * 1024);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hop::wgmma_64x8_ss(sg, dq + 2 * kk, dg + 2 * kk, kk > 0);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sg);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (tq2 + (e & 1) < a.G) {
            sg[e] = gok[e & 1] ? sg[e] : kNegInf;
            m[e >> 1] = fmaxf(m[e >> 1], sg[e]);
          }
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          m[x] = fmaxf(m[x], __shfl_xor_sync(0xffffffffu, m[x], 1));
          m[x] = fmaxf(m[x], __shfl_xor_sync(0xffffffffu, m[x], 2));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tq2 + (e & 1) < a.G) l[e >> 1] += band::exp_diff(sg[e], m[e >> 1]);
      }
    }

    for (int j = 0; j < sp.nck; ++j) {
      const int c = sp.c0 + j * KC;
      const uint8_t* st = base + LY::stages + s * LY::stage;
      hop::mbar_wait(&bars->full[s], ph);
      // every condition below is uniform over the warpgroup
      if (active && c < own_last + a.band && c + KC > own_first) {
        // the chunk lies in every row's band: no column of it is another block's
        const bool all_own = c >= own_last && c + KC <= own_first + a.band;
        // the chunk lies outside every row's window [t, t + W]: each score is
        // masked to -1e30, so e is one value a row and Q.K^T is not needed
        const bool outside =
            MASK && all_own && (c + KC <= r0 || c > imin(r0 + MROWS, a.L) - 1 + a.W);
        uint32_t p[4][4];  // e in bf16: the A operand of each 16-key step of P.V
        if (outside) {
          float e[2] = {kNegInf, kNegInf};
          if constexpr (SOFTMAX) {
            // the chunk's max, -1e30, leaves m as it is (alpha = 1)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              e[x] = band::exp_diff(kNegInf, m[x]);  // 1 on a row with nothing valid yet
              l[x] += 16.f * e[x];
            }
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            p[kk][0] = p[kk][2] = band::pack_bf16(e[0], e[0]);
            p[kk][1] = p[kk][3] = band::pack_bf16(e[1], e[1]);
          }
        } else {
          // Each product is awaited right after its commit, so no register
          // an asynchronous wgmma reads or writes is touched while it runs;
          // the SM's four warpgroups keep the tensor cores busy between them.
          float sc[32];  // the chunk's scores, then e
          const uint64_t dk = hop::desc_sw128(st + hh * TILE);
          hop::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hop::wgmma_64x64_ss(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          hop::fence_regs(sc);
          // column col of the chunk is band row c + col; element i of sc is
          // row trow[(i >> 1) & 1], column 8 (i >> 2) + tq2 + (i & 1)
          int ao[2], aw[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            ao[x] = c + tq2 - own[x];   // own band iff 0 <= col + ao < band
            aw[x] = c + tq2 - trow[x];  // window iff 0 <= col + aw <= W
          }
          const int32_t* kls = reinterpret_cast<const int32_t*>(st + 2 * TILE) + tq2;
          if (all_own)
            mask_chunk<MASK, SOFTMAX, false>(sc, ao, aw, kls, a.band, a.W);
          else
            mask_chunk<MASK, SOFTMAX, true>(sc, ao, aw, kls, a.band, a.W);
          if constexpr (SOFTMAX) {
            float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int i = 0; i < 32; ++i) cm[(i >> 1) & 1] = fmaxf(cm[(i >> 1) & 1], sc[i]);
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
            for (int i = 0; i < 32; ++i) {
              const int x = (i >> 1) & 1;
              sc[i] = band::exp_diff(sc[i], m[x]);  // 0 for another block's column
              l[x] += sc[i];
              o[i] *= alpha[x];
            }
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) p[i >> 2][i & 3] = band::pack_bf16(sc[2 * i], sc[2 * i + 1]);
        }
        const uint64_t dv = hop::desc_sw128(st + LY::vofs + hh * TILE);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) hop::wgmma_64x64_rs(o, p[kk], dv + 128 * kk, 1);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hop::fence_regs(p[kk]);
        hop::fence_regs(o);
      }
      if (tid == 0) hop::mbar_arrive(&bars->empty[s]);  // its products have read the stage
      if (++s == NS) {
        s = 0;
        ph ^= 1;
      }
    }
    if (tid == 0) hop::mbar_arrive(&bars->qempty[qb]);  // Q and the global keys are read
    if (!active) continue;

    float inv[2] = {1.f, 1.f};
    if constexpr (SOFTMAX) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
        l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
        inv[x] = 1.f / fmaxf(l[x], 1e-30f);
      }
    }
    // the warpgroup's output tile, 128-byte swizzled as the TMA store reads it
    uint8_t* os = base + LY::o + wg * TILE;
    if (tid == 0) hop::bulk_wait_read();  // the last tile's store has left it
    hop::named_sync(1 + wg, 128);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = 16 * warp + gq + 8 * x;
        *reinterpret_cast<__nv_bfloat162*>(os + r * 128 + ((n8 ^ (r & 7)) << 4) + 2 * tq2) =
            __floats2bfloat162_rn(o[4 * n8 + 2 * x] * inv[x], o[4 * n8 + 2 * x + 1] * inv[x]);
      }
    hop::fence_async_smem();
    hop::named_sync(1 + wg, 128);
    if (tid == 0) {
      const int lane0 = KIND == kAblation ? sp.unit * D : sp.unit * 2 * D + hh * D;
      hop::tma_store_3d(a.out, os, lane0, r0, sp.b);
      hop::bulk_commit();
    }
  }
  if (tid == 0) hop::bulk_wait();
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

bool shape_ok(int B, int L, int units, int W, int bq) {
  return B > 0 && L > 0 && units > 0 && W > 0 && W % 16 == 0 && bq > 0 && bq % 16 == 0 &&
         L % bq == 0;
}

// a bf16 map over (B, rows, lanes) with boxes of 64 lanes x box_rows rows
bool map_rows(CUtensorMap* m, const void* base, int B, int rows, int lanes, int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(lanes), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(lanes) * 2,
                               static_cast<uint64_t>(lanes) * 2 * rows};
  const uint32_t box[3] = {D, static_cast<uint32_t>(box_rows), 1};
  return hop::make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// a bf16 map over (B, P, 2, L, 64) of a (B, L, P*128) tensor: a box is both
// heads of a pair, head 0's rows then head 1's
bool map_pairs(CUtensorMap* m, const void* base, int B, int L, int P, int box_rows) {
  const uint64_t C = static_cast<uint64_t>(P) * 2 * D;
  const uint64_t dims[5] = {D, static_cast<uint64_t>(L), 2, static_cast<uint64_t>(P),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[4] = {C * 2, D * 2, 2 * D * 2, C * 2 * L};
  const uint32_t box[5] = {D, static_cast<uint32_t>(box_rows), 2, 1, 1};
  return hop::make_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, base, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 1;
  return n;
}

template <int KIND, bool MASK, bool SOFTMAX, bool GLOBALS>
cudaError_t launch(Args& a, int B, cudaStream_t stream) {
  auto kernel = band_probe_kernel<KIND, MASK, SOFTMAX, GLOBALS>;
  constexpr int smem = smem_bytes<KIND>();
  static_assert(smem <= kMaxSmem, "probe kernel: shared memory");
  a.ntile = (a.L + Lay<KIND>::rows - 1) / Lay<KIND>::rows;
  a.tiles = B * a.units * a.ntile;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<imin(a.tiles, sm_count()), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 dots_only, 1 no_softmax, 2 no_mask, 3 band_softmax, 4 full
// (ops/band_probes.py::ABLATION_VARIANTS). Returns the launch's cudaError_t;
// cudaErrorInvalidValue for a shape the kernel does not take (block_q not a
// multiple of 16 dividing L, W not a multiple of 16, G outside 1..8) or a
// tensor map the driver refuses, cudaErrorMisalignedAddress for an operand
// off 16 bytes.
extern "C" int band_ablation(int variant, const void* q, const void* kpad, const void* vpad,
                             const void* keyloc, const void* gk, const void* gvalid, void* out,
                             int B, int L, int H, int G, int W, int bq, void* stream) {
  if (!shape_ok(B, L, H, W, bq) || G < 1 || G > GMAX) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, kpad, vpad, keyloc, gk, static_cast<const void*>(out)})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  Args a = {};
  const int Lp = L + W;
  const uint64_t kl_dims[2] = {static_cast<uint64_t>(Lp), static_cast<uint64_t>(B)};
  const uint64_t kl_strides[1] = {static_cast<uint64_t>(Lp) * 4};
  const uint32_t kl_box[2] = {KC, 1};
  if (!map_rows(&a.q, q, B, L, H * D, Lay<kAblation>::rows) ||
      !map_rows(&a.k, kpad, B, Lp, H * D, KC) || !map_rows(&a.v, vpad, B, Lp, H * D, KC) ||
      !map_rows(&a.gk, gk, B, G, H * D, GMAX) || !map_rows(&a.out, out, B, L, H * D, MROWS) ||
      !hop::make_map(&a.kl, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, keyloc, kl_dims, kl_strides, kl_box,
                     CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  a.gvalid = static_cast<const int32_t*>(gvalid);
  a.L = L;
  a.units = H;
  a.G = G;
  a.W = W;
  a.bq = bq;
  a.band = bq + W;  // padded rows [i bq, i bq + bq + W)
  a.shift = 0;
  a.maxoff = L - bq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return (int)launch<kAblation, false, false, false>(a, B, s);
    case 1: return (int)launch<kAblation, true, false, false>(a, B, s);
    case 2: return (int)launch<kAblation, false, true, false>(a, B, s);
    case 3: return (int)launch<kAblation, true, true, false>(a, B, s);
    case 4: return (int)launch<kAblation, true, true, true>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// variant: 0 perhead, 1 pair (ops/band_probes.py::HEADPAIR_VARIANTS); P head
// pairs of 128 lanes. Returns the launch's cudaError_t, as band_ablation.
extern "C" int band_headpair(int variant, const void* q, const void* k, const void* v,
                             void* out, int B, int L, int P, int W, int bq, void* stream) {
  if (!shape_ok(B, L, P, W, bq) || variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  Args a = {};
  constexpr int rows = Lay<kPair>::rows;
  const bool maps_ok =
      variant == 0
          ? map_rows(&a.q, q, B, L, P * 2 * D, rows) && map_rows(&a.k, k, B, L, P * 2 * D, KC) &&
                map_rows(&a.v, v, B, L, P * 2 * D, KC)
          : map_pairs(&a.q, q, B, L, P, rows) && map_pairs(&a.k, k, B, L, P, KC) &&
                map_pairs(&a.v, v, B, L, P, KC);
  if (!maps_ok || !map_rows(&a.out, out, B, L, P * 2 * D, MROWS)) return (int)cudaErrorInvalidValue;
  a.L = L;
  a.units = P;
  a.W = W;
  a.bq = bq;
  a.band = imin(bq + W, L);  // rows [clamp(i bq - W/2, 0, L - band), + band)
  a.shift = W / 2;
  a.maxoff = L - a.band;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return variant == 0 ? (int)launch<kPerHead, false, false, false>(a, B, s)
                      : (int)launch<kPair, false, false, false>(a, B, s);
}
