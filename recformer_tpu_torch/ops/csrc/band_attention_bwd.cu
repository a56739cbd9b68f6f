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
// card's ratio; this first version runs on CUDA cores and reads its operands
// from shared memory once per pair, so shared-memory bandwidth limits it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_common.cuh"

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
         4 * kWarps * 3 * G * D + 4 * rows;
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
    float rd = 0.f;
    for (int c = lane; c < ncol; c += 32) {
      const float p = pw[c] / denom;
      float dp = dpw[c];
      if (drop.on) {
        const int col = c <= window ? i - half + c : L + c - window - 1;
        if (c > window || (col >= 0 && col < L))
          dp = band::dropout_keep(drop, b, h, i, col) ? dp * drop.scale : 0.f;
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
          pd = band::dropout_keep(drop, b, h, i, L + c - window - 1) ? p * drop.scale : 0.f;
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
         4 * 2 * kWarps * (window + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
band_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int32_t* __restrict__ keyloc, const int32_t* __restrict__ mrow,
                    const T* __restrict__ dout, const float* __restrict__ stats,
                    T* __restrict__ dk, T* __restrict__ dv, int L, int H, int window,
                    float q_scale, int fuse, Dropout drop) {
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
          const bool kp = band::dropout_keep(drop, b, h, i, j);
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

// dtype: 0 = float32, 1 = bfloat16. Returns the first failing launch's
// cudaError_t, or 0.
extern "C" int band_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                  const void* keyloc, const void* gk, const void* gv,
                                  const void* gvalid, const void* mrow, const void* dout,
                                  void* dq, void* dk, void* dv, void* dg, void* stats, void* ws,
                                  int B, int L, int H, int D, int G, int window, float q_scale,
                                  float dq_scale, int fuse_epilogue, int dropout, uint32_t seed,
                                  uint32_t threshold, float drop_scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || window <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, drop_scale, dropout != 0};
  float* dgf = static_cast<float*>(dg);
  float* stf = static_cast<float*>(stats);
  float* wsf = static_cast<float*>(ws);
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
