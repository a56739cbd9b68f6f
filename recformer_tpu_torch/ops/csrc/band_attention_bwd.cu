// Windowed + global attention backward for sm_90a, with a plain C interface
// (loaded through ctypes by recformer_tpu_torch/ops/window_attention.py,
// which holds the design note and the plain PyTorch version,
// window_attention_bwd_plain).
//
// Replaces recformer_tpu/ops/pallas_attention.py::_bwd_kernel. The TPU
// kernel walks the query blocks of one (batch, head pair) in sequence and
// carries two sums across them: dK/dV over overlapping bands, and dgK/dgV
// over the whole sequence. Blocks here run in parallel and in no order, so
// the work is split into three deterministic passes (no atomics; the result
// is bitwise the same from run to run):
//
// (a) query pass, one block per 64-row query tile of one (batch, head),
//     staged like the forward: recomputes the scores, p and dp of each row,
//     writes dq, the row statistics (max, clamped sum, row_dot = sum p*dp),
//     the tile's fp32 partials of dgk/dgv/dgout into a workspace;
// (b) key pass, one block per 64-key tile: stages the query rows that can see
//     its keys, [j0 - W/2, j1 + W/2) clipped to [0, L), with their dout and
//     statistics, recomputes those rows' scores against its own keys and
//     writes dk and dv once;
// (c) a reduction of the workspace over query tiles into dgk, dgv, dgout.
//
// Both passes compute a score with the same code in the same order, so p, dp
// and ds agree between them bit for bit. Rounding follows the TPU kernel:
// q*scale rounds to the input type, ds rounds before dq and dk, the dropped
// p rounds before dv, dq is scaled after its float32 product. With the fused
// epilogue (G == 1) dgout sums dout over mask == 2 rows and the band sees
// dout only at mask == 1 rows.
//
// Operands, all row-major and contiguous:
//   q, k, v, dout, dq, dk, dv : (B, L, H*D)   float or bf16
//   keyloc, mrow              : (B, L)        int32
//   gk, gv                    : (B, G, H*D)   float or bf16
//   gvalid                    : (B, G)        int32
//   dg                        : (3, B, G, H*D) float32: dgk, dgv, dgout
//   stats                     : (B, H, L, 3)   float32 scratch
//   ws                        : (3, B, H, n_tiles, G, D) float32 scratch
//
// What bounds it: about 10*D flops per useful (query, key) pair and head
// against roughly 14*D bytes per row and head in bf16, so bytes by the
// card's ratio. Two sets of passes compute the same function; the entry
// point picks by dtype and shape (band_attention_bwd_path):
// - tensor cores, for bf16 at D == W == 64 with G <= 8 (every Recformer-base
//   training step): each product is an mma.sync m16n8k16 tile product, bf16
//   in and fp32 accumulate. The query pass is the forward's tile (4 warps,
//   64 query rows, a warp owning 16 rows and their 80 band keys plus one
//   global tile) with dP = dout.V^T beside S; its rounded dS feeds
//   dQ = dS.K straight from the score registers; it stages its operands in
//   two cp.async groups, so V and dout arrive while the scores are
//   computed. The key pass swaps the roles of Q and K (a warp owns 16 keys
//   and the 80 rows that see them: S^T = K.Q^T, dP^T = V.dout^T,
//   dK = dS^T.Q, dV = P_drop^T.dout) and walks the 80 rows in chunks of 16,
//   so that four blocks fit on an SM. Both stage bf16 in shared memory at a
//   stride of 72 elements (ldmatrix without bank conflicts) and zero-fill
//   rows off [0, L) without reading them. Dropout draws each Philox word
//   once: the query pass shares one call per four columns across a thread
//   pair by shuffles; in the key pass the four keys of a call sit in four
//   lanes, so lanes draw and exchange the words through shared memory.
// - CUDA cores, for float32 and every other shape (W = 128 and G = 0 among
//   them: ModernBERT's local layers): a warp owns one row (a
//   key in the key pass) and reads its operands from float32 shared memory
//   once per pair, so shared-memory bandwidth limits it; the keep bits of a
//   row (a key tile) are drawn once per four adjacent columns into shared
//   memory first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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

constexpr int kWarps = 8;
constexpr int kTile = 64;  // key rows per block in the key pass

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// ---------------------------------------------------------------------------
// (a) query pass
// ---------------------------------------------------------------------------

int query_smem_bytes(int tile_q, int window, int G, int D) {
  const int rows = tile_q + window;
  const int ncol = window + 1 + G;
  return 4 * (2 * rows + 2 * G) * (D + 1) + 4 * 2 * kWarps * D + 4 * 2 * kWarps * ncol +
         4 * kWarps * 3 * G * D + 4 * rows + kWarps * ncol;
}

// The keep bits of query row i into keep[0, ncol): band column c (key
// i - window/2 + c, where it lies in [0, L)) and global column window + 1 + g
// (column L + g). The warp makes each Philox call of the row once, one per
// four adjacent columns, and spreads its words.
__device__ void row_keep(const Dropout& d, int b, int h, int i, int L, int window, int G,
                         int lane, unsigned char* keep) {
  const int half = window / 2;
  const int a0 = max(i - half, 0), a1 = min(i + half, L - 1);  // the band's columns
  const int gb0 = a0 >> 2, gb1 = a1 >> 2;
  const int gg0 = max(L >> 2, gb1 + 1), gg1 = (L + G - 1) >> 2;  // the rest of the global ones
  const int n1 = gb1 - gb0 + 1;
  const int n = n1 + max(gg1 - gg0 + 1, 0);
  for (int t = lane; t < n; t += 32) {
    const int m = t < n1 ? gb0 + t : gg0 + t - n1;
    const uint4 w = band::dropout_words(d, b, h, i, 4 * m);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int a = 4 * m + x;
      const bool kp = band::keep_word(d, w, a);
      if (a >= a0 && a <= a1)
        keep[a - (i - half)] = kp;
      else if (a >= L && a < L + G)
        keep[window + 1 + a - L] = kp;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
band_bwd_query_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const int32_t* __restrict__ keyloc, const T* __restrict__ gk,
                      const T* __restrict__ gv, const int32_t* __restrict__ gvalid,
                      const int32_t* __restrict__ mrow, const T* __restrict__ dout,
                      T* __restrict__ dq, float* __restrict__ stats, float* __restrict__ ws,
                      int B, int L, int H, int G, int window, int tile_q, float q_scale,
                      float dq_scale, int fuse, Dropout drop) {
  drop = band::resolve(drop);
  constexpr int DP = D + 1;
  const int HD = H * D;
  const int half = window / 2;
  const int ncol = window + 1 + G;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int t0 = tile * tile_q;
  const int t1 = min(t0 + tile_q, L);
  const int lo = max(t0 - half, 0);
  const int hi = min(t1 + half, L);
  const int nband = hi - lo;
  const int band_cap = tile_q + window;

  extern __shared__ float smem[];
  float* ks = smem;                        // (band_cap, DP)
  float* vs = ks + band_cap * DP;          // (band_cap, DP)
  float* gks = vs + band_cap * DP;         // (G, DP)
  float* gvs = gks + G * DP;               // (G, DP)
  float* qs = gvs + G * DP;                // (kWarps, D) scaled query row per warp
  float* dos = qs + kWarps * D;            // (kWarps, D) dout row per warp
  float* ps = dos + kWarps * D;            // (kWarps, ncol) scores -> p -> rounded ds
  float* dps = ps + kWarps * ncol;         // (kWarps, ncol) dp -> rounded dropped p
  float* acc = dps + kWarps * ncol;        // (kWarps, 3, G, D) dgk, dgv, dgout partials
  int* kl = reinterpret_cast<int*>(acc + kWarps * 3 * G * D);  // (band_cap)
  unsigned char* keeps = reinterpret_cast<unsigned char*>(kl + band_cap);  // (kWarps, ncol)

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
  for (int idx = threadIdx.x; idx < kWarps * 3 * G * D; idx += blockDim.x) acc[idx] = 0.f;
  for (int r = threadIdx.x; r < nband; r += blockDim.x) kl[r] = keyloc[(size_t)b * L + lo + r];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * D;
  float* dw = dos + warp * D;
  float* pw = ps + warp * ncol;
  float* dpw = dps + warp * ncol;
  float* aw = acc + warp * 3 * G * D;
  unsigned char* kw = keeps + warp * ncol;

  for (int i = t0 + warp; i < t1; i += kWarps) {
    const size_t row = head_base + (size_t)i * HD;
    const int mr = mrow[(size_t)b * L + i];
    for (int d = lane; d < D; d += 32) {
      qw[d] = round_to<T>(to_float(q[row + d]) * q_scale);
      float g = to_float(dout[row + d]);
      if (fuse) {
        // the epilogue's backward: global rows feed dgout, the band sees dout
        // only at local rows
        if (mr == 2) aw[2 * G * D + d] += g;
        if (mr != 1) g = 0.f;
      }
      dw[d] = g;
    }
    __syncwarp();

    // scores and dout . v per column; band column c holds key j = i - half + c
    float mx = kNegInf;
    for (int c = lane; c < ncol; c += 32) {
      float s = kNegInf, dp = 0.f;
      if (c <= window) {
        const int j = i - half + c;
        if (j >= lo && j < hi && kl[j - lo] != 0) {
          s = dot<D>(qw, ks + (j - lo) * DP);
          dp = dot<D>(dw, vs + (j - lo) * DP);
        }
      } else {
        const int g = c - window - 1;
        if (gvalid[(size_t)b * G + g] != 0) {
          s = dot<D>(qw, gks + g * DP);
          dp = dot<D>(dw, gvs + g * DP);
        }
      }
      pw[c] = s;
      dpw[c] = dp;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < ncol; c += 32) {
      const float e = expf(pw[c] - mx);
      sum += e;
      pw[c] = e;
    }
    const float denom = fmaxf(warp_sum(sum), 1e-30f);

    // p from the undropped exponentials; dropout scales dp (and, for dv, p)
    if (drop.on) {
      row_keep(drop, b, h, i, L, window, G, lane, kw);
      __syncwarp();
    }
    float rd = 0.f;
    for (int c = lane; c < ncol; c += 32) {
      const float p = pw[c] / denom;
      float dp = dpw[c];
      if (drop.on) {
        const int col = c <= window ? i - half + c : L + c - window - 1;
        if (c > window || (col >= 0 && col < L))
          dp = kw[c] ? dp * drop.scale : 0.f;
      }
      rd += p * dp;
      pw[c] = p;
      dpw[c] = dp;
    }
    const float row_dot = warp_sum(rd);
    // pw <- ds rounded to the input type; for the global columns dpw <- the
    // dropped p rounded to the input type (the band's dv is the key pass's)
    for (int c = lane; c < ncol; c += 32) {
      const float p = pw[c];
      pw[c] = round_to<T>(p * (dpw[c] - row_dot));
      if (c > window) {
        float pd = p;
        if (drop.on)
          pd = kw[c] ? p * drop.scale : 0.f;
        dpw[c] = round_to<T>(pd);
      }
    }
    __syncwarp();

    const int c_lo = max(0, lo - (i - half));
    const int c_hi = min(window, hi - 1 - (i - half));
    for (int d = lane; d < D; d += 32) {
      float a = 0.f;
      for (int c = c_lo; c <= c_hi; ++c) a = fmaf(pw[c], ks[(i - half + c - lo) * DP + d], a);
      for (int g = 0; g < G; ++g) a = fmaf(pw[window + 1 + g], gks[g * DP + d], a);
      dq[row + d] = from_float<T>(a * dq_scale);
      for (int g = 0; g < G; ++g) {
        aw[g * D + d] = fmaf(pw[window + 1 + g], qw[d], aw[g * D + d]);
        aw[(G + g) * D + d] = fmaf(dpw[window + 1 + g], dw[d], aw[(G + g) * D + d]);
      }
    }
    if (lane == 0) {
      float* st = stats + (((size_t)b * H + h) * L + i) * 3;
      st[0] = mx;
      st[1] = denom;
      st[2] = row_dot;
    }
    __syncwarp();
  }
  __syncthreads();

  // this tile's partials: the warps' accumulators summed in a fixed order
  for (int idx = threadIdx.x; idx < 3 * G * D; idx += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += acc[w * 3 * G * D + idx];
    const int x = idx / (G * D);
    const int gd = idx - x * G * D;
    ws[((((size_t)x * B + b) * H + h) * n_tiles + tile) * G * D + gd] = s;
  }
}

// ---------------------------------------------------------------------------
// (b) key pass
// ---------------------------------------------------------------------------

int key_smem_bytes(int window, int D) {
  const int rows = kTile + window;
  return 4 * 2 * rows * (D + 1) + 4 * 3 * rows + 4 * 2 * kWarps * D +
         4 * 2 * kWarps * (window + 1) + kTile * (window + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
band_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int32_t* __restrict__ keyloc, const int32_t* __restrict__ mrow,
                    const T* __restrict__ dout, const float* __restrict__ stats,
                    T* __restrict__ dk, T* __restrict__ dv, int L, int H, int window,
                    float q_scale, int fuse, Dropout drop) {
  drop = band::resolve(drop);
  constexpr int DP = D + 1;
  const int HD = H * D;
  const int half = window / 2;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int j0 = blockIdx.x * kTile;
  const int j1 = min(j0 + kTile, L);
  const int qlo = max(j0 - half, 0);  // query rows that see a key of this tile
  const int qhi = min(j1 + half, L);
  const int nq = qhi - qlo;
  const int cap = kTile + window;

  extern __shared__ float smem[];
  float* qs = smem;                  // (cap, DP) scaled queries
  float* dos = qs + cap * DP;        // (cap, DP) dout as the band sees it
  float* st = dos + cap * DP;        // (cap, 3) row statistics
  float* kw = st + 3 * cap;          // (kWarps, D) this warp's key
  float* vw = kw + kWarps * D;       // (kWarps, D) and value
  float* dsw = vw + kWarps * D;      // (kWarps, window + 1) rounded ds per row
  float* pdw = dsw + kWarps * (window + 1);  // (kWarps, window + 1) rounded dropped p
  // (kTile, window + 1) keep bit of key j0 + t and row j0 + t - half + r
  unsigned char* keeps = reinterpret_cast<unsigned char*>(pdw + kWarps * (window + 1));

  const size_t head_base = (size_t)b * L * HD + (size_t)h * D;
  for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int i = qlo + r;
    const size_t off = head_base + (size_t)i * HD + d;
    qs[r * DP + d] = round_to<T>(to_float(q[off]) * q_scale);
    float g = to_float(dout[off]);
    if (fuse && mrow[(size_t)b * L + i] != 1) g = 0.f;
    dos[r * DP + d] = g;
  }
  for (int idx = threadIdx.x; idx < nq * 3; idx += blockDim.x)
    st[idx] = stats[(((size_t)b * H + h) * L + qlo) * 3 + idx];
  if (drop.on) {
    // one Philox call per row and four adjacent keys (j0 is a multiple of 4):
    // group m meets rows [4m - half, 4m + 3 + half]
    const int span = window + 4;
    const int n = ((j1 - 1 - j0) / 4 + 1) * span;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int m = j0 / 4 + t / span;
      const int i = 4 * m - half + t % span;
      if (i < 0 || i >= L) continue;
      const uint4 w = band::dropout_words(drop, b, h, i, 4 * m);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = 4 * m + x;
        const int r = i - j + half;
        if (j < j1 && r >= 0 && r <= window)
          keeps[(j - j0) * (window + 1) + r] = band::keep_word(drop, w, j);
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* kr = kw + warp * D;
  float* vr = vw + warp * D;
  float* dsr = dsw + warp * (window + 1);
  float* pdr = pdw + warp * (window + 1);

  for (int j = j0 + warp; j < j1; j += kWarps) {
    const size_t row = head_base + (size_t)j * HD;
    if (keyloc[(size_t)b * L + j] == 0) {
      // not a band key of any row (padding, or the global row, whose
      // gradient arrives through dgk/dgv)
      for (int d = lane; d < D; d += 32) {
        dk[row + d] = from_float<T>(0.f);
        dv[row + d] = from_float<T>(0.f);
      }
      continue;
    }
    for (int d = lane; d < D; d += 32) {
      kr[d] = to_float(k[row + d]);
      vr[d] = to_float(v[row + d]);
    }
    __syncwarp();
    // rows i = j - half + r, r in [0, window], that exist
    for (int r = lane; r <= window; r += 32) {
      const int i = j - half + r;
      float ds = 0.f, pd = 0.f;
      if (i >= 0 && i < L) {
        const int ri = i - qlo;
        const float s = dot<D>(qs + ri * DP, kr);
        const float p = expf(s - st[3 * ri]) / st[3 * ri + 1];
        float dp = dot<D>(dos + ri * DP, vr);
        float pdr_ = p;
        if (drop.on) {
          const bool kp = keeps[(j - j0) * (window + 1) + r];
          dp = kp ? dp * drop.scale : 0.f;
          pdr_ = kp ? p * drop.scale : 0.f;
        }
        ds = round_to<T>(p * (dp - st[3 * ri + 2]));
        pd = round_to<T>(pdr_);
      }
      dsr[r] = ds;
      pdr[r] = pd;
    }
    __syncwarp();
    const int r_lo = max(0, qlo - (j - half));
    const int r_hi = min(window, qhi - 1 - (j - half));
    for (int d = lane; d < D; d += 32) {
      float a = 0.f, c = 0.f;
      for (int r = r_lo; r <= r_hi; ++r) {
        const int ri = j - half + r - qlo;
        a = fmaf(dsr[r], qs[ri * DP + d], a);
        c = fmaf(pdr[r], dos[ri * DP + d], c);
      }
      dk[row + d] = from_float<T>(a);
      dv[row + d] = from_float<T>(c);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// (c) reduction of the query tiles' partials
// ---------------------------------------------------------------------------

__global__ void band_bwd_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dg,
                                       int B, int H, int n_tiles, int G, int D) {
  const int HD = H * D;
  const size_t n = (size_t)3 * B * G * HD;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    // dg[x, b, g, h*D + d]
    const int hd = idx % HD;
    const int g = (idx / HD) % G;
    const int b = (idx / ((size_t)HD * G)) % B;
    const int x = idx / ((size_t)HD * G * B);
    const int h = hd / D;
    const int d = hd - h * D;
    const float* src = ws + (((size_t)x * B + b) * H + h) * n_tiles * G * D + g * D + d;
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += src[(size_t)t * G * D];
    dg[idx] = s;
  }
}

int tile_for(int D, int G, int window) {
  int tile_q = 64;
  while (tile_q > 8 && query_smem_bytes(tile_q, window, G, D) > kMaxSmem) tile_q /= 2;
  if (query_smem_bytes(tile_q, window, G, D) > kMaxSmem) return -1;
  if (key_smem_bytes(window, D) > kMaxSmem) return -1;
  return tile_q;
}

// ---------------------------------------------------------------------------
// Tensor-core passes: bf16, D == W == 64, G <= 8
// ---------------------------------------------------------------------------

namespace tcb {
constexpr int D = 64;
constexpr int W = 64;
constexpr int HALF = W / 2;
constexpr int WARPS = 4;
constexpr int TILE = 16 * WARPS;  // query rows (query pass) or keys (key pass) per block
constexpr int BAND = TILE + W;    // rows of the other side a tile meets
constexpr int NT = (16 + W) / 8;  // 8-wide tiles of the 80 columns one warp's 16 rows meet
constexpr int GMAX = 8;
constexpr int GPAD = 16;          // global rows padded to one k-step
constexpr int S = D + 8;          // smem row stride (bf16): ldmatrix without bank conflicts
constexpr int CH = D / 8;         // 16-byte chunks per row
// query pass: Q and dout tiles, K and V bands, global K and V, band keyloc,
// tile mrow, then each warp's partials of dgk, dgv and dgout (WARPS, 3, G, D)
constexpr int QSMEM_BASE = (2 * TILE + 2 * BAND + 2 * GPAD) * S * 2 + BAND * 4 + TILE * 4;
int qsmem(int G) { return QSMEM_BASE + WARPS * 3 * G * D * 4; }
// key pass: Q and dout bands, the band's row statistics and validity, and
// each warp's Philox words
constexpr int KSMEM = 2 * BAND * S * 2 + BAND * 16 + WARPS * 32 * 16;
}  // namespace tcb

using bf16 = __nv_bfloat16;

// (a) query pass: the forward's tile (a warp owns 16 query rows and their 80
// band keys plus one 8-wide global tile) with dP = dout.V^T beside S, then
// dS, dQ = dS.K and the global columns' partials
__global__ void __launch_bounds__(tcb::WARPS * 32)
band_bwd_query_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int32_t* __restrict__ keyloc,
                         const bf16* __restrict__ gk, const bf16* __restrict__ gv,
                         const int32_t* __restrict__ gvalid, const int32_t* __restrict__ mrow,
                         const bf16* __restrict__ dout, bf16* __restrict__ dq,
                         float* __restrict__ stats, float* __restrict__ ws, int B, int L, int H,
                         int G, float q_scale, float dq_scale, int fuse, Dropout drop) {
  using namespace tcb;
  drop = band::resolve(drop);
  const int HD = H * D;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int t0 = tile * TILE;
  const int lo = t0 - HALF;  // band row 0 holds key lo

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (TILE, S) scaled queries
  bf16* dos = qs + TILE * S;                      // (TILE, S) dout as the band sees it
  bf16* ks = dos + TILE * S;                      // (BAND, S)
  bf16* vs = ks + BAND * S;                       // (BAND, S)
  bf16* gks = vs + BAND * S;                      // (GPAD, S)
  bf16* gvs = gks + GPAD * S;                     // (GPAD, S)
  int* kl = reinterpret_cast<int*>(gvs + GPAD * S);  // (BAND) keyloc, 0 off [0, L)
  int* mr = kl + BAND;                               // (TILE) mrow, -1 past L
  float* part = reinterpret_cast<float*>(mr + TILE);  // (WARPS, 3, G, D) partials

  // group 0 holds what the scores need, group 1 what dP needs; rows off
  // [0, L) are zero-filled, and so is dout at non-local rows under the
  // fused epilogue (the band sees dout only at mask == 1 rows)
  const size_t head = (size_t)b * L * HD + (size_t)h * D;
  const size_t ghead = (size_t)b * G * HD + (size_t)h * D;
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
    band::cp_async16(gks + g * S + col, gk + ghead + (size_t)(g < G ? g : 0) * HD + col, g < G);
  }
  band::cp_async_commit();
  for (int c = threadIdx.x; c < TILE * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8, i = t0 + r;
    const bool ok = i < L && (!fuse || mrow[(size_t)b * L + i] == 1);
    band::cp_async16(dos + r * S + col, dout + head + (size_t)(ok ? i : 0) * HD + col, ok);
  }
  for (int c = threadIdx.x; c < BAND * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8, j = lo + r;
    const bool ok = j >= 0 && j < L;
    band::cp_async16(vs + r * S + col, v + head + (size_t)(ok ? j : 0) * HD + col, ok);
  }
  for (int c = threadIdx.x; c < GPAD * CH; c += blockDim.x) {
    const int g = c / CH, col = (c % CH) * 8;
    band::cp_async16(gvs + g * S + col, gv + ghead + (size_t)(g < G ? g : 0) * HD + col, g < G);
  }
  band::cp_async_commit();
  for (int r = threadIdx.x; r < BAND; r += blockDim.x) {
    const int j = lo + r;
    kl[r] = (j >= 0 && j < L) ? keyloc[(size_t)b * L + j] : 0;
  }
  for (int r = threadIdx.x; r < TILE; r += blockDim.x)
    mr[r] = t0 + r < L ? mrow[(size_t)b * L + t0 + r] : -1;
  band::cp_async_wait<1>();
  for (int c = threadIdx.x; c < TILE * CH; c += blockDim.x)
    if (t0 + c / CH < L) band::scale_chunk(qs + (c / CH) * S + (c % CH) * 8, q_scale);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int r0 = warp * 16;

  // scores, as the forward computes them
  float sc[NT][4];
  float sg[4] = {0.f, 0.f, 0.f, 0.f};
  {
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      band::ldsm_x4(qa[kc], qs + (r0 + (lane & 15)) * S + kc * 16 + (lane >> 4) * 8);
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
    const bf16* kb = gks + (lane & 7) * S + (lane >> 3) * 8;
#pragma unroll
    for (int dc = 0; dc < D / 32; ++dc) {
      uint32_t bk[4];
      band::ldsm_x4(bk, kb + dc * 32);
      band::mma_bf16(sg, qa[2 * dc], bk[0], bk[1]);
      band::mma_bf16(sg, qa[2 * dc + 1], bk[2], bk[3]);
    }
  }
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
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
  }
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
  float denom[2], inv[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 1);
    sum[x] += __shfl_xor_sync(0xffffffffu, sum[x], 2);
    denom[x] = fmaxf(sum[x], 1e-30f);
    inv[x] = 1.f / denom[x];
  }
  // p from the undropped exponentials, p = e * (1 / sum) as the key pass
  // recomputes it
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] *= inv[e >> 1];
#pragma unroll
  for (int e = 0; e < 4; ++e) sg[e] *= inv[e >> 1];

  band::cp_async_wait<0>();
  __syncthreads();

  // dP = dout.V^T over the same columns
  float dp[NT][4];
  float dpg[4] = {0.f, 0.f, 0.f, 0.f};
  {
    uint32_t da[D / 16][4];
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      band::ldsm_x4(da[kc], dos + (r0 + (lane & 15)) * S + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      const bf16* vb = vs + (r0 + nt * 8 + (lane & 7)) * S + (lane >> 3) * 8;
#pragma unroll
      for (int dc = 0; dc < D / 32; ++dc) {
        uint32_t bv[4];
        band::ldsm_x4(bv, vb + dc * 32);
        band::mma_bf16(dp[nt], da[2 * dc], bv[0], bv[1]);
        band::mma_bf16(dp[nt], da[2 * dc + 1], bv[2], bv[3]);
      }
    }
    const bf16* vb = gvs + (lane & 7) * S + (lane >> 3) * 8;
#pragma unroll
    for (int dc = 0; dc < D / 32; ++dc) {
      uint32_t bv[4];
      band::ldsm_x4(bv, vb + dc * 32);
      band::mma_bf16(dpg, da[2 * dc], bv[0], bv[1]);
      band::mma_bf16(dpg, da[2 * dc + 1], bv[2], bv[3]);
    }
  }

  // dropout scales dp (and, for the global columns' dv, p): one Philox
  // call per four adjacent columns of a row
  const int i0 = t0 + r0 + gq;
  float pg[4] = {sg[0], sg[1], sg[2], sg[3]};  // dropped p of the global columns
  if (drop.on) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bool kp[4];
      band::keep_quad(drop, b, h, i0, i0 + 8, lo + r0 + nt * 8 + 2 * tq, tq, kp);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = kp[e] ? dp[nt][e] * drop.scale : 0.f;
    }
    bool kp[4];
    band::keep_global(drop, b, h, i0, i0 + 8, L, tq, kp);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dpg[e] = kp[e] ? dpg[e] * drop.scale : 0.f;
      pg[e] = kp[e] ? sg[e] * drop.scale : 0.f;
    }
  }
  float rd[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) rd[e >> 1] += sc[nt][e] * dp[nt][e];
#pragma unroll
  for (int e = 0; e < 4; ++e) rd[e >> 1] += sg[e] * dpg[e];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    rd[x] += __shfl_xor_sync(0xffffffffu, rd[x], 1);
    rd[x] += __shfl_xor_sync(0xffffffffu, rd[x], 2);
  }

  // ds = p (dp - row_dot), rounded to bf16 as the A fragments of dQ = dS.K;
  // the global columns' rounded ds and dropped p go to shared memory for the
  // partials of dgk and dgv
  uint32_t dsa[NT / 2][4];
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int nt = 2 * kk + hf;
      dsa[kk][2 * hf] = band::pack_bf16(sc[nt][0] * (dp[nt][0] - rd[0]),
                                        sc[nt][1] * (dp[nt][1] - rd[0]));
      dsa[kk][2 * hf + 1] = band::pack_bf16(sc[nt][2] * (dp[nt][2] - rd[1]),
                                            sc[nt][3] * (dp[nt][3] - rd[1]));
    }
  }
  // the global columns' rounded ds and dropped p
  float dsg[4], pgr[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dsg[e] = round_to<bf16>(sg[e] * (dpg[e] - rd[e >> 1]));
    pgr[e] = round_to<bf16>(pg[e]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const bf16* kb = ks + (r0 + kk * 16 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
    for (int dc = 0; dc < D / 16; ++dc) {
      uint32_t bk[4];
      band::ldsm_x4_trans(bk, kb + dc * 16);
      band::mma_bf16(o[2 * dc], dsa[kk], bk[0], bk[1]);
      band::mma_bf16(o[2 * dc + 1], dsa[kk], bk[2], bk[3]);
    }
  }
  {
    const uint32_t a[4] = {band::pack_bf16(dsg[0], dsg[1]), band::pack_bf16(dsg[2], dsg[3]), 0u,
                           0u};
    const bf16* kb = gks + (lane & 15) * S + (lane >> 4) * 8;
#pragma unroll
    for (int dc = 0; dc < D / 16; ++dc) {
      uint32_t bk[4];
      band::ldsm_x4_trans(bk, kb + dc * 16);
      band::mma_bf16(o[2 * dc], a, bk[0], bk[1]);
      band::mma_bf16(o[2 * dc + 1], a, bk[2], bk[3]);
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int i = i0 + 8 * x;
    if (i >= L) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dq + head + (size_t)i * HD + dt * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[dt][2 * x] * dq_scale, o[dt][2 * x + 1] * dq_scale);
    if (tq == 0) {
      float* st = stats + (((size_t)b * H + h) * L + i) * 3;
      st[0] = mx[x];
      st[1] = denom[x];
      st[2] = rd[x];
    }
  }

  // this tile's partials of dgk, dgv and dgout: dgk[g] += ds[., g] q,
  // dgv[g] += p_drop[., g] dout, dgout[0] += dout at mask == 2 rows (fused
  // epilogue). Each warp sums its own 16 rows in order, lanes over d, a
  // row's values shuffled from the lane that holds them; then the warps'
  // sums are added in order: short chains, where a thread summing all 64
  // rows would hold the block on one long chain of dependent loads.
  float* pw = part + warp * 3 * G * D;
  for (int g = 0; g < G; ++g) {
    float ak[2] = {0.f, 0.f}, av[2] = {0.f, 0.f}, ao[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int e = (r >> 3) * 2 + (g & 1);
      const int src = (r & 7) * 4 + (g >> 1);
      const float ds_r = __shfl_sync(0xffffffffu, (e & 2) ? ((e & 1) ? dsg[3] : dsg[2])
                                                          : ((e & 1) ? dsg[1] : dsg[0]), src);
      const float pd_r = __shfl_sync(0xffffffffu, (e & 2) ? ((e & 1) ? pgr[3] : pgr[2])
                                                          : ((e & 1) ? pgr[1] : pgr[0]), src);
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        ak[y] += ds_r * __bfloat162float(qs[(r0 + r) * S + lane + 32 * y]);
        av[y] += pd_r * __bfloat162float(dos[(r0 + r) * S + lane + 32 * y]);
      }
      if (fuse && g == 0 && mr[r0 + r] == 2) {
        const bf16* grow = dout + head + (size_t)(t0 + r0 + r) * HD;
        ao[0] += __bfloat162float(grow[lane]);
        ao[1] += __bfloat162float(grow[lane + 32]);
      }
    }
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      pw[g * D + lane + 32 * y] = ak[y];
      pw[(G + g) * D + lane + 32 * y] = av[y];
      pw[(2 * G + g) * D + lane + 32 * y] = ao[y];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 3 * G * D; idx += blockDim.x) {
    float s = part[idx];
    for (int w = 1; w < WARPS; ++w) s += part[w * 3 * G * D + idx];
    const int x = idx / (G * D);
    ws[((((size_t)x * B + b) * H + h) * n_tiles + tile) * G * D + idx - x * G * D] = s;
  }
}

// (b) key pass: a warp owns 16 keys and the 80 query rows that can see them,
// the query pass's tile with the roles of Q and K swapped: S^T = K.Q^T and
// dP^T = V.dout^T, then dK = dS^T.Q and dV = P_drop^T.dout. The warp walks
// the 80 rows in five chunks of 16, adding each chunk's products to dK and
// dV, so it holds one chunk's scores at a time; its keys' K and V fragments
// come straight from memory. Both keep the pass at 128 registers and 41 KB
// of shared memory, four blocks an SM.
__global__ void __launch_bounds__(tcb::WARPS * 32, 4)
band_bwd_key_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int32_t* __restrict__ keyloc,
                       const int32_t* __restrict__ mrow, const bf16* __restrict__ dout,
                       const float* __restrict__ stats, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int L, int H, float q_scale, int fuse,
                       Dropout drop) {
  using namespace tcb;
  drop = band::resolve(drop);
  const int HD = H * D;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int j0 = blockIdx.x * TILE;
  const int qlo = j0 - HALF;  // band row 0 holds query row qlo

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qb = reinterpret_cast<bf16*>(smem_raw);  // (BAND, S) scaled queries
  bf16* db = qb + BAND * S;                       // (BAND, S) dout as the band sees it
  // (BAND) per row: max, 1 / clamped sum, row_dot, and 1 if the row is in [0, L)
  float4* rs = reinterpret_cast<float4*>(db + BAND * S);
  uint4* xw = reinterpret_cast<uint4*>(rs + BAND);  // (WARPS, 32) Philox words

  const size_t head = (size_t)b * L * HD + (size_t)h * D;
  for (int c = threadIdx.x; c < BAND * CH; c += blockDim.x) {
    const int r = c / CH, col = (c % CH) * 8, i = qlo + r;
    const bool ok = i >= 0 && i < L;
    const size_t off = head + (size_t)(ok ? i : 0) * HD + col;
    band::cp_async16(qb + r * S + col, q + off, ok);
    band::cp_async16(db + r * S + col, dout + off,
                     ok && (!fuse || mrow[(size_t)b * L + i] == 1));
  }
  band::cp_async_commit();
  for (int r = threadIdx.x; r < BAND; r += blockDim.x) {
    const int i = qlo + r;
    const bool ok = i >= 0 && i < L;
    const float* st = stats + (((size_t)b * H + h) * L + (ok ? i : 0)) * 3;
    rs[r] = ok ? make_float4(st[0], 1.f / st[1], st[2], 1.f) : make_float4(0.f, 1.f, 0.f, 0.f);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // this thread's keys in the warp's 16: gq and gq + 8
  const int tq = lane & 3;   // and its query pair in each 8-wide tile
  const int r0 = warp * 16;  // the warp's first key in the tile; its queries are band rows r0.. r0+79

  // the A fragments of the warp's keys and values, rows past L zero
  uint32_t ka[D / 16][4], va[D / 16][4];
  bool key_ok[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = j0 + r0 + gq + 8 * x;
    key_ok[x] = j < L && keyloc[(size_t)b * L + j] != 0;
    const uint32_t* kr = reinterpret_cast<const uint32_t*>(k + head + (size_t)(j < L ? j : 0) * HD);
    const uint32_t* vr = reinterpret_cast<const uint32_t*>(v + head + (size_t)(j < L ? j : 0) * HD);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int w = (kc * 16 + y * 8 + 2 * tq) / 2;
        ka[kc][x + 2 * y] = j < L ? __ldg(kr + w) : 0u;
        va[kc][x + 2 * y] = j < L ? __ldg(vr + w) : 0u;
      }
    }
  }

  band::cp_async_wait<0>();
  for (int c = threadIdx.x; c < BAND * CH; c += blockDim.x) {
    const int i = qlo + c / CH;
    if (i >= 0 && i < L) band::scale_chunk(qb + (c / CH) * S + (c % CH) * 8, q_scale);
  }
  __syncthreads();

  float ak[D / 8][4], av[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[dt][e] = av[dt][e] = 0.f;
  uint32_t* xww = reinterpret_cast<uint32_t*>(xw + warp * 32);

#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    // this chunk's two 8-wide tiles of S^T and dP^T
    float pt[2][4], dpt[2][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int nt = 2 * kk + hf;
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[hf][e] = dpt[hf][e] = 0.f;
      const int off = (r0 + nt * 8 + (lane & 7)) * S + (lane >> 3) * 8;
#pragma unroll
      for (int dc = 0; dc < D / 32; ++dc) {
        uint32_t bq[4], bd[4];
        band::ldsm_x4(bq, qb + off + dc * 32);
        band::mma_bf16(pt[hf], ka[2 * dc], bq[0], bq[1]);
        band::mma_bf16(pt[hf], ka[2 * dc + 1], bq[2], bq[3]);
        band::ldsm_x4(bd, db + off + dc * 32);
        band::mma_bf16(dpt[hf], va[2 * dc], bd[0], bd[1]);
        band::mma_bf16(dpt[hf], va[2 * dc + 1], bd[2], bd[3]);
      }
    }
    // p, ds and the dropped p: key row kr meets band column c (query
    // qlo + r0 + c) iff |kr + HALF - c| <= HALF, the query lies in [0, L) and
    // the key is local. Dropout: the four keys of one Philox call (4
    // adjacent keys of a query) lie in four lanes here, so lane l draws the
    // words of query (l & 7) of the tile and key group (l >> 3) of the
    // warp's 16 keys, and each thread reads the words it needs from shared
    // memory.
    uint32_t dsa[4], pda[4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int nt = 2 * kk + hf;
      bool kp[4] = {true, true, true, true};
      if (drop.on) {
        xw[warp * 32 + lane] = band::dropout_words(drop, b, h, qlo + r0 + nt * 8 + (lane & 7),
                                                   j0 + r0 + 4 * (lane >> 3));
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = gq + (e >> 1) * 8;
          kp[e] = xww[(((kr >> 2) * 8) + 2 * tq + (e & 1)) * 4 + (kr & 3)] >= drop.threshold;
        }
        __syncwarp();
      }
      const float4 st[2] = {rs[r0 + nt * 8 + 2 * tq], rs[r0 + nt * 8 + 2 * tq + 1]};
      float ds[4], pd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = gq + (e >> 1) * 8;
        const int c = nt * 8 + 2 * tq + (e & 1);
        const float4 s = st[e & 1];
        const bool ok = c >= kr && c <= kr + W && s.w != 0.f && key_ok[e >> 1];
        // the query pass's p = e^(s - max) * (1 / sum), bit for bit
        const float p = ok ? band::exp_diff(pt[hf][e], s.x) * s.y : 0.f;
        const float dpv = drop.on ? (kp[e] ? dpt[hf][e] * drop.scale : 0.f) : dpt[hf][e];
        ds[e] = p * (dpv - s.z);
        pd[e] = drop.on ? (kp[e] ? p * drop.scale : 0.f) : p;
      }
      dsa[2 * hf] = band::pack_bf16(ds[0], ds[1]);
      dsa[2 * hf + 1] = band::pack_bf16(ds[2], ds[3]);
      pda[2 * hf] = band::pack_bf16(pd[0], pd[1]);
      pda[2 * hf + 1] = band::pack_bf16(pd[2], pd[3]);
    }
    // dK += dS^T.Q and dV += P_drop^T.dout over this chunk's 16 rows
    const int off = (r0 + kk * 16 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
    for (int dc = 0; dc < D / 16; ++dc) {
      uint32_t bq[4], bd[4];
      band::ldsm_x4_trans(bq, qb + off + dc * 16);
      band::mma_bf16(ak[2 * dc], dsa, bq[0], bq[1]);
      band::mma_bf16(ak[2 * dc + 1], dsa, bq[2], bq[3]);
      band::ldsm_x4_trans(bd, db + off + dc * 16);
      band::mma_bf16(av[2 * dc], pda, bd[0], bd[1]);
      band::mma_bf16(av[2 * dc + 1], pda, bd[2], bd[3]);
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = j0 + r0 + gq + 8 * x;
    if (j >= L) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const size_t off = head + (size_t)j * HD + dt * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(ak[dt][2 * x], ak[dt][2 * x + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(av[dt][2 * x], av[dt][2 * x + 1]);
    }
  }
}

// the tensor-core passes stage one global tile: G == 0 (no global column)
// takes the CUDA-core passes
bool tc_shape(int dtype, int D, int G, int window) {
  return dtype == 1 && D == tcb::D && window == tcb::W && G >= 1 && G <= tcb::GMAX;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* keyloc,
                      const void* gk, const void* gv, const void* gvalid, const void* mrow,
                      const void* dout, void* dq, void* dk, void* dv, float* dg, float* stats,
                      float* ws, int B, int L, int H, int G, float q_scale, float dq_scale,
                      int fuse, Dropout drop, cudaStream_t stream) {
  // the caller sized ``ws`` by band_attention_bwd_tile, which must be this
  // pass's tile; every bf16 operand is read and written 16 bytes at a time
  if (tile_for(tcb::D, G, tcb::W) != tcb::TILE) return cudaErrorInvalidValue;
  for (const void* p : {q, k, v, gk, gv, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk), static_cast<const void*>(dv)})
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  const int n_tiles = (L + tcb::TILE - 1) / tcb::TILE;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const int32_t* kl = static_cast<const int32_t*>(keyloc);
  const int32_t* mr = static_cast<const int32_t*>(mrow);

  const int qbytes = tcb::qsmem(G);
  cudaError_t err = cudaFuncSetAttribute(band_bwd_query_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, qbytes);
  if (err != cudaSuccess) return err;
  band_bwd_query_tc_kernel<<<dim3(n_tiles, H, B), tcb::WARPS * 32, qbytes, stream>>>(
      q_, k_, v_, kl, static_cast<const bf16*>(gk), static_cast<const bf16*>(gv),
      static_cast<const int32_t*>(gvalid), mr, do_, static_cast<bf16*>(dq), stats, ws, B, L, H,
      G, q_scale, dq_scale, fuse, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(band_bwd_key_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tcb::KSMEM);
  if (err != cudaSuccess) return err;
  band_bwd_key_tc_kernel<<<dim3(n_tiles, H, B), tcb::WARPS * 32, tcb::KSMEM, stream>>>(
      q_, k_, v_, kl, mr, do_, stats, static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H,
      q_scale, fuse, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t n = (size_t)3 * B * G * H * tcb::D;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  band_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, dg, B, H, n_tiles, G, tcb::D);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* keyloc,
                   const void* gk, const void* gv, const void* gvalid, const void* mrow,
                   const void* dout, void* dq, void* dk, void* dv, float* dg, float* stats,
                   float* ws, int B, int L, int H, int G, int window, float q_scale,
                   float dq_scale, int fuse, Dropout drop, cudaStream_t stream) {
  const int tile_q = tile_for(D, G, window);
  if (tile_q <= 0) return cudaErrorInvalidValue;
  const int n_tiles = (L + tile_q - 1) / tile_q;

  const int qsmem = query_smem_bytes(tile_q, window, G, D);
  auto qkernel = band_bwd_query_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(qkernel, cudaFuncAttributeMaxDynamicSharedMemorySize, qsmem);
  if (err != cudaSuccess) return err;
  qkernel<<<dim3(n_tiles, H, B), kWarps * 32, qsmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(keyloc), static_cast<const T*>(gk),
      static_cast<const T*>(gv), static_cast<const int32_t*>(gvalid),
      static_cast<const int32_t*>(mrow), static_cast<const T*>(dout), static_cast<T*>(dq),
      stats, ws, B, L, H, G, window, tile_q, q_scale, dq_scale, fuse, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int ksmem = key_smem_bytes(window, D);
  auto kkernel = band_bwd_key_kernel<T, D>;
  err = cudaFuncSetAttribute(kkernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ksmem);
  if (err != cudaSuccess) return err;
  kkernel<<<dim3((L + kTile - 1) / kTile, H, B), kWarps * 32, ksmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(keyloc), static_cast<const int32_t*>(mrow),
      static_cast<const T*>(dout), stats, static_cast<T*>(dk), static_cast<T*>(dv), L, H,
      window, q_scale, fuse, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t n = (size_t)3 * B * G * H * D;
  if (n == 0) return cudaSuccess;  // no global column: nothing to reduce
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  band_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, dg, B, H, n_tiles, G, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const void* keyloc,
                     const void* gk, const void* gv, const void* gvalid, const void* mrow,
                     const void* dout, void* dq, void* dk, void* dv, float* dg, float* stats,
                     float* ws, int B, int L, int H, int G, int window, float q_scale,
                     float dq_scale, int fuse, Dropout drop, cudaStream_t stream) {
#define BAND_BWD_CASE(DIM)                                                                   \
  case DIM:                                                                                  \
    return launch<T, DIM>(q, k, v, keyloc, gk, gv, gvalid, mrow, dout, dq, dk, dv, dg, stats, \
                          ws, B, L, H, G, window, q_scale, dq_scale, fuse, drop, stream);
  switch (D) {
    BAND_BWD_CASE(8)
    BAND_BWD_CASE(16)
    BAND_BWD_CASE(32)
    BAND_BWD_CASE(64)
    BAND_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef BAND_BWD_CASE
}

}  // namespace

// Query-tile height of the query pass for these sizes, or -1 when a pass's
// staging does not fit in shared memory. The caller sizes ``ws`` from it.
extern "C" int band_attention_bwd_tile(int D, int G, int window) {
  return tile_for(D, G, window);
}

// Which kernel band_attention_bwd launches for these sizes: 1 the
// tensor-core passes (bf16, D == W == 64, 1 <= G <= 8), 0 the CUDA-core ones
// (G may be 0 there: no global column).
extern "C" int band_attention_bwd_path(int dtype, int D, int G, int window) {
  return tc_shape(dtype, D, G, window) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. The dropout seed is ``seed``, or the one
// at ``seed_at`` in device memory where that is not null (band_common.cuh).
// Returns the first failing launch's cudaError_t, or 0. The tensor-core
// passes take 16-byte aligned operands and return cudaErrorMisalignedAddress
// otherwise.
extern "C" int band_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                  const void* keyloc, const void* gk, const void* gv,
                                  const void* gvalid, const void* mrow, const void* dout,
                                  void* dq, void* dk, void* dv, void* dg, void* stats, void* ws,
                                  int B, int L, int H, int D, int G, int window, float q_scale,
                                  float dq_scale, int fuse_epilogue, int dropout, uint32_t seed,
                                  const void* seed_at, uint32_t threshold, float drop_scale,
                                  void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G < 0 || window <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, drop_scale, dropout != 0,
                     static_cast<const uint32_t*>(seed_at)};
  float* dgf = static_cast<float*>(dg);
  float* stf = static_cast<float*>(stats);
  float* wsf = static_cast<float*>(ws);
  if (tc_shape(dtype, D, G, window))
    return (int)launch_tc(q, k, v, keyloc, gk, gv, gvalid, mrow, dout, dq, dk, dv, dgf, stf, wsf,
                          B, L, H, G, q_scale, dq_scale, fuse_epilogue, drop, s);
  if (dtype == 0)
    return (int)dispatch<float>(D, q, k, v, keyloc, gk, gv, gvalid, mrow, dout, dq, dk, dv, dgf,
                                stf, wsf, B, L, H, G, window, q_scale, dq_scale, fuse_epilogue,
                                drop, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(D, q, k, v, keyloc, gk, gv, gvalid, mrow, dout, dq, dk,
                                        dv, dgf, stf, wsf, B, L, H, G, window, q_scale,
                                        dq_scale, fuse_epilogue, drop, s);
  return (int)cudaErrorInvalidValue;
}
