// Row-wise LayerNorm pieces shared by embed_layernorm.cu (kernels 3 and 4)
// and layernorm_bwd.cu (kernel 5): the register layout of one row held by
// one warp, vectorised row loads and stores, and the one-launch backward
// body with its deterministic in-kernel reduction of dgamma/dbeta.
//
// One warp owns one row of H = 32 * N values: lane l holds the columns
// (c * 32 + l) * V + e for chunk c and element e < V, where V elements of the
// input type make up to 16 bytes, so every load and store is coalesced and
// vectorised. Row statistics are lane sums followed by a butterfly.
//
// The backward (ln_bwd_body) replaces the TPU kernels' sequential grid,
// which carries dgamma/dbeta in one revisited output block. What bounds it
// on the H100 is HBM bytes (a few flops against 6 bytes an element in bf16
// for kernel 5, 12 for kernel 4), so the design keeps bytes in flight and
// launches once:
//   - a persistent cooperative grid: as many blocks as the card holds at
//     once (one an SM for the Recformer-base shapes), the same grid at every
//     launch of a kernel, so no tail wave; each warp walks rows warp,
//     warp + W, ... of the grid's W warps;
//   - rows in flight: every lane copies its own 16-byte pieces of a row's
//     inputs and dout into its warp's ring in shared memory with cp.async
//     (one group a row, issued together), Src::kStages rows deep, so the
//     next row is on its way while the current one is reduced and stored. A
//     lane reads back only the bytes it copied itself: cp.async.wait_group
//     is the only synchronisation a row needs;
//   - gamma staged once per block in shared memory, rounded to the input
//     type there when the caller asks for it (kernel 5, as _pln_bwd rounds
//     it), never reloaded from device memory per row;
//   - dgamma/dbeta: each lane accumulates its columns over its rows in
//     registers; the block sums its warps in warp order into its row of
//     partials in device memory; a grid barrier; then block b sums its
//     2H / G columns over the G rows in block order and writes them to dgb.
//     The order of every sum is fixed by the grid alone, so the bits never
//     depend on which block finishes first. The only atomic is the
//     barrier's arrival count, never a sum.
//
// The barrier counts arrivals per kernel (input type and row width) in
// device memory and never resets the count: a launch of G blocks adds G, so
// each launch finds a multiple of G and opens at the next one, and a CUDA
// graph replays the kernel unchanged. The count assumes that two launches of
// one kernel never run at the same time: the wrappers launch on PyTorch's
// current stream, which orders them. Launches from two streams without an
// event between them would share the count.
//
// Arithmetic uses the _rn intrinsics, so nvcc contracts no multiply-add into
// an FMA and the rounding order is the one written, as in the plain
// PyTorch versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_common.cuh"
#include "band_mma.cuh"

namespace rowln {

using band::from_float;
using band::round_to;
using band::to_float;
using band::warp_sum;

constexpr int kWarps = 8;  // rows per block of the forward, one warp each

template <typename T, int H>
struct RowLayout {
  static_assert(H % 64 == 0, "row width must be a multiple of 64");
  static constexpr int kVec =
      (H % (32 * (16 / (int)sizeof(T))) == 0) ? 16 / (int)sizeof(T) : 2;
  static constexpr int kChunks = H / (32 * kVec);
  static constexpr int kPerLane = H / 32;
  // column of the lane's i-th value
  static __device__ __forceinline__ int col(int i, int lane) {
    return ((i / kVec) * 32 + lane) * kVec + (i % kVec);
  }
};

template <typename S, int V>
struct alignas(sizeof(S) * V) Pack {
  S v[V];
};

// The lane's values of one row of S (T's layout), widened to float.
template <typename T, int H, typename S>
__device__ __forceinline__ void load_row(const S* __restrict__ row, int lane,
                                         float (&out)[H / 32]) {
  using L = RowLayout<T, H>;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    const Pack<S, L::kVec> p =
        *reinterpret_cast<const Pack<S, L::kVec>*>(row + (c * 32 + lane) * L::kVec);
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) out[c * L::kVec + e] = to_float(p.v[e]);
  }
}

template <typename T, int H>
__device__ __forceinline__ void store_row(T* __restrict__ row, int lane,
                                          const float (&in)[H / 32]) {
  using L = RowLayout<T, H>;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    Pack<T, L::kVec> p;
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) p.v[e] = from_float<T>(in[c * L::kVec + e]);
    *reinterpret_cast<Pack<T, L::kVec>*>(row + (c * 32 + lane) * L::kVec) = p;
  }
}

template <int N>
__device__ __forceinline__ float row_sum(const float (&v)[N]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s = __fadd_rn(s, v[i]);
  return warp_sum(s);
}

// The mean of a row from its sum: jnp.mean's sum / H (the embedding kernel)
// or the LayerNorm kernel's sum * (1 / H).
enum class Mean { kDivide, kScale };

template <Mean kMean>
__device__ __forceinline__ float row_mean(float sum, int H) {
  return kMean == Mean::kDivide ? __fdiv_rn(sum, (float)H)
                                : __fmul_rn(sum, __fdiv_rn(1.f, (float)H));
}

// x -> x_hat in place (two-pass variance); returns 1 / sqrt(var + eps).
template <Mean kMean, int N>
__device__ __forceinline__ float normalize(float (&x)[N], float eps) {
  constexpr int H = 32 * N;
  const float mu = row_mean<kMean>(row_sum(x), H);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = __fsub_rn(x[i], mu);
    sq = __fadd_rn(sq, __fmul_rn(x[i], x[i]));
  }
  const float var = row_mean<kMean>(warp_sum(sq), H);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = __fmul_rn(x[i], rstd);
  return rstd;
}

// ---------------------------------------------------------------------------
// The backward: one persistent launch per call
// ---------------------------------------------------------------------------

constexpr int kRingBudget = 200 * 1024;  // bytes of ring a block may take
constexpr int kTailChunk = 16;           // block rows whose loads the tail issues together
constexpr unsigned int kMaxSpins = 1u << 26;  // a grid barrier that never opens traps

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Arrivals at the grid barrier of each kernel of a library (by input type
// and row width), counted since the library was loaded: a launch of
// ``G`` blocks adds G, so a launch finds its kernel's count a multiple of G.
__device__ unsigned long long g_arrivals[2][8];

__host__ __device__ constexpr int width_index(int H) {
  return H == 64 ? 0 : H == 128 ? 1 : H == 256 ? 2 : H == 384 ? 3 : H == 512 ? 4 : H == 768 ? 5 : 6;
}

// The block shape of a backward over rows of H values of T whose input is
// Src::kRows rows of T (1 for kernel 5, the four addends for kernel 4):
// Src::kStages rows in each warp's ring, Src::kMaxWarps warps (fewer, a
// multiple of 4, where the ring would outgrow its budget).
template <typename T, int H, typename Src>
struct BwdPlan {
  static constexpr int kStages = Src::kStages;
  static constexpr int kStageElems = (Src::kRows + 1) * H;  // the input rows, then dout
  static constexpr int kWarpBytes = kStages * kStageElems * (int)sizeof(T);
  static constexpr int kWarps = cmax(4, cmin(Src::kMaxWarps, kRingBudget / kWarpBytes) / 4 * 4);
  static constexpr int kThreads = kWarps * 32;
  // shared memory: gamma (H floats), then the warps' rings, which the warps'
  // sums (2H floats a warp, never more than its ring) reuse once the rows
  // are done, and the tail's group sums after them
  static constexpr int kRingOffset = 4 * H;
  static constexpr int kSmemBytes = kRingOffset + kWarps * kWarpBytes;
  static_assert(kWarpBytes >= 8 * H, "a warp's sums outgrow its ring");
};

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// A grid barrier for a cooperative launch: every block waits here until
// all have arrived, after which the writes each block made before arriving
// are visible to all. Thread 0 releases the block's writes and counts its
// arrival, then polls the count until it reaches ``open``: the kernel's
// count before the launch (read by thread 0 before it arrives, rounded down
// to a multiple of gridDim.x) plus gridDim.x. Nothing is reset, so a CUDA
// graph can replay the kernel. A barrier still shut after kMaxSpins polls
// traps instead of hanging.
__device__ __forceinline__ void grid_barrier(unsigned long long* count,
                                             unsigned long long open) {
  __syncthreads();
  if (threadIdx.x == 0) {
    add_release(count, 1ull);
    unsigned int spins = 0;
    while (ld_acquire(count) < open)
      if (++spins == kMaxSpins) __trap();
  }
  __syncthreads();
}

// cp.async of one piece of 4, 8 or 16 bytes
template <int kBytes>
__device__ __forceinline__ void cp_async_piece(void* smem, const void* gmem) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(band::smem_addr(smem)),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(band::smem_addr(smem)),
                 "l"(gmem), "n"(kBytes)
                 : "memory");
  }
}

// The lane's pieces of one row of T (the pieces load_row reads back) into
// ``dst`` in shared memory.
template <typename T, int H>
__device__ __forceinline__ void stage_row(T* dst, const T* __restrict__ src, int lane) {
  using L = RowLayout<T, H>;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    const int at = (c * 32 + lane) * L::kVec;
    cp_async_piece<L::kVec * (int)sizeof(T)>(dst + at, src + at);
  }
}

// The backward of a LayerNorm over M rows of width H, launched as
// launch_bwd does (a cooperative grid, BwdPlan's block and shared memory).
// ``src`` stages a row's inputs (src.stage(dst, offset, lane)) and reads the
// lane's values of the forward's input back from them (src.read(staged,
// lane, x), float32); gamma is float32, rounded to T first when
// kRoundGamma; dout and dx are T. Writes dx, one row of block partials
// (partial, (gridDim.x, 2H) float32 scratch) and dgb (2H float32: dgamma,
// then dbeta):
//   m1 = mean(dy*g), m2 = mean(dy*g*x_hat), dx = rstd*((dy*g - m1) - x_hat*m2)
template <typename T, int H, Mean kMean, bool kRoundGamma, typename Src>
__device__ __forceinline__ void ln_bwd_body(const Src& src, const float* __restrict__ gamma,
                                            const T* __restrict__ dout, T* __restrict__ dx,
                                            float* __restrict__ partial,
                                            float* __restrict__ dgb, int M, float eps) {
  using P = BwdPlan<T, H, Src>;
  using L = RowLayout<T, H>;
  constexpr int N = H / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sg = reinterpret_cast<float*>(smem);  // gamma
  T* ring = reinterpret_cast<T*>(smem + P::kRingOffset);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * P::kWarps;
  unsigned long long* arrivals = &g_arrivals[sizeof(T) == 2][width_index(H)];
  unsigned long long open = 0;
  if (threadIdx.x == 0) open = (ld_relaxed(arrivals) / gridDim.x + 1) * gridDim.x;

  // 1. rows: the first kStages - 1 in flight before gamma is staged
  T* mine = ring + warp * P::kStages * P::kStageElems;
  int row = blockIdx.x * P::kWarps + warp;
#pragma unroll
  for (int s = 0; s < P::kStages - 1; ++s) {
    const int r = row + s * stride;
    if (r < M) {
      T* st = mine + s * P::kStageElems;
      src.stage(st, (size_t)r * H, lane);
      stage_row<T, H>(st + Src::kRows * H, dout + (size_t)r * H, lane);
    }
    band::cp_async_commit();
  }
  for (int h = threadIdx.x; h < H; h += P::kThreads)
    sg[h] = kRoundGamma ? round_to<T>(gamma[h]) : gamma[h];
  __syncthreads();

  float dg[N], db[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dg[i] = db[i] = 0.f;
  for (int k = 0; row < M; ++k, row += stride) {
    const int ahead = row + (P::kStages - 1) * stride;
    if (ahead < M) {
      T* st = mine + ((k + P::kStages - 1) % P::kStages) * P::kStageElems;
      src.stage(st, (size_t)ahead * H, lane);
      stage_row<T, H>(st + Src::kRows * H, dout + (size_t)ahead * H, lane);
    }
    band::cp_async_commit();
    band::cp_async_wait<P::kStages - 1>();  // this row's group has landed
    const T* st = mine + (k % P::kStages) * P::kStageElems;
    float x[N], g[N];
    src.read(st, lane, x);
    const float rstd = normalize<kMean>(x, eps);
    load_row<T, H>(st + Src::kRows * H, lane, g);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      const Pack<float, L::kVec> gam =
          *reinterpret_cast<const Pack<float, L::kVec>*>(sg + (c * 32 + lane) * L::kVec);
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) {
        const int i = c * L::kVec + e;
        dg[i] = __fadd_rn(dg[i], __fmul_rn(g[i], x[i]));
        db[i] = __fadd_rn(db[i], g[i]);
        g[i] = __fmul_rn(g[i], gam.v[e]);  // dy * gamma
        s1 = __fadd_rn(s1, g[i]);
        s2 = __fadd_rn(s2, __fmul_rn(g[i], x[i]));
      }
    }
    const float m1 = row_mean<kMean>(warp_sum(s1), H);
    const float m2 = row_mean<kMean>(warp_sum(s2), H);
#pragma unroll
    for (int i = 0; i < N; ++i)
      g[i] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(g[i], m1), __fmul_rn(x[i], m2)));
    store_row<T, H>(dx + (size_t)row * H, lane, g);
  }
  band::cp_async_wait<0>();
  __syncwarp();  // every lane has read its last row before the ring is overwritten

  // 2. the block's warps, summed in warp order, into the block's row of
  //    partials
  float* red = reinterpret_cast<float*>(mine);  // this warp's 2H sums, inside its ring
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    Pack<float, L::kVec> a, b;
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) {
      a.v[e] = dg[c * L::kVec + e];
      b.v[e] = db[c * L::kVec + e];
    }
    const int at = (c * 32 + lane) * L::kVec;
    *reinterpret_cast<Pack<float, L::kVec>*>(red + at) = a;
    *reinterpret_cast<Pack<float, L::kVec>*>(red + H + at) = b;
  }
  __syncthreads();
  constexpr int kWarpStride = P::kWarpBytes / 4;  // floats
  const float* reds = reinterpret_cast<const float*>(ring);
  float* mine_row = partial + (size_t)blockIdx.x * 2 * H;
  for (int h = 4 * threadIdx.x; h < 2 * H; h += 4 * P::kThreads) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < P::kWarps; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(reds + w * kWarpStride + h);
      s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                      __fadd_rn(s.w, v.w));
    }
    *reinterpret_cast<float4*>(mine_row + h) = s;
  }

  // 3. every block's row written
  grid_barrier(arrivals, open);

  // 4. block b sums its cols columns over the block rows in block order:
  //    groups of threads each take a contiguous range of rows, their loads
  //    kTailChunk at a time, then the groups' sums are added in order
  const int n_rows = gridDim.x;
  const int cols = (2 * H + n_rows - 1) / n_rows;
  const int c0 = blockIdx.x * cols;
  const int c1 = c0 + cols < 2 * H ? c0 + cols : 2 * H;
  if (c0 >= c1) return;
  const int groups = P::kThreads / cols > 0 ? P::kThreads / cols : 1;
  float* part = reinterpret_cast<float*>(ring);
  for (int t = threadIdx.x; t < groups * cols; t += P::kThreads) {
    const int grp = t / cols, j = t - grp * cols;
    const int lo = n_rows * grp / groups, hi = n_rows * (grp + 1) / groups;
    float s = 0.f;
    if (c0 + j < c1) {
      const float* col = partial + c0 + j;
      for (int r = lo; r < hi; r += kTailChunk) {
        float v[kTailChunk];
#pragma unroll
        for (int u = 0; u < kTailChunk; ++u)
          v[u] = r + u < hi ? __ldcg(col + (size_t)(r + u) * 2 * H) : 0.f;
#pragma unroll
        for (int u = 0; u < kTailChunk; ++u)
          if (r + u < hi) s = __fadd_rn(s, v[u]);
      }
    }
    part[t] = s;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < c1 - c0; j += P::kThreads) {
    float s = 0.f;
    for (int grp = 0; grp < groups; ++grp) s = __fadd_rn(s, part[grp * cols + j]);
    dgb[c0 + j] = s;
  }
}

// Blocks (rows of partials) of every launch of kKernel: as many as the card
// holds at once at the kernel's occupancy (a cooperative launch needs them
// all resident; a fixed grid keeps the barrier's count a multiple of it).
// Negative: minus the CUDA error.
template <typename Plan, auto kKernel>
inline int bwd_partial_rows() {
  static int resident[64] = {};  // blocks resident at once, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= 64) return -(int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Plan::kSmemBytes);
    if (err != cudaSuccess) return -(int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, Plan::kThreads,
                                                        Plan::kSmemBytes);
    if (err != cudaSuccess) return -(int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    if (per_sm <= 0) return -(int)cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  return resident[dev];
}

// One cooperative launch of the backward kernel kKernel, with
// bwd_partial_rows() blocks.
template <typename Plan, auto kKernel, typename... Args>
inline cudaError_t launch_bwd(cudaStream_t stream, Args... args) {
  const int blocks = bwd_partial_rows<Plan, kKernel>();
  if (blocks <= 0) return (cudaError_t)-blocks;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(Plan::kThreads);
  cfg.dynamicSmemBytes = Plan::kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kKernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace rowln

// Dispatch on the row widths the kernels are built for (the Python wrappers
// hold the same list, SUPPORTED_WIDTHS).
#define ROWLN_WIDTHS(CASE) CASE(64) CASE(128) CASE(256) CASE(384) CASE(512) CASE(768) CASE(1024)
