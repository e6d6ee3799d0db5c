// Cost probes P1 and P2: what bounds the port's radix-2 kernels (K1, K2,
// K3) -- the 32-bit multiplies, the shared-memory round trips of the
// stages, or the barriers between them.
//
// P1 replaces the TPU probe benchmarks/kernel_parts.py::run (kernel
// kern_mul): the same seven variants on rows of N words, each launch one
// application, each variant a kernel of its own:
//   mul       14 chained Shoup products a word, in registers;
//   bfly      28 butterflies on the fixed pair (j, j + N/2) with the
//             per-word twiddle w[j], in registers;
//   stage     28 radix-2 stages of m = 4 blocks (pairs (i 2h + r,
//             i 2h + h + r), h = N / 2m, twiddle w[i]), written back in
//             place, the row in shared memory and a barrier a stage --
//             K1's stage loop with a fixed stride;
//   stage_c   the TPU's concatenate-along-the-block-axis form of `stage`:
//             the same function and the same memory order, so on Hopper it
//             is the same kernel instantiation;
//   stage_c64 `stage` at m = 64;
//   stage_r   `stage` read, but the sums written to the first half of a
//             second buffer and the differences to the second half;
//   stage_w   the pair (j, j + N/2) read (twiddle w[j]), the value and the
//             product written interleaved by blocks (no add), to a second
//             buffer.
// P2 replaces benchmarks/kernel_phases.py::make (inner kern): K1's code
// path with one phase enabled, on rows of n words, row r on aux prime r % 3
// of the flat tables [3, n]:
//   memory    the row into shared memory (+q) and back (-q): the identity;
//   coarse    forward stages [0, log2 n - 7), then their Gentleman-Sande
//             butterflies in reverse order with the forward tables (as
//             kernel_phases.py passes only forward tables), no n^-1;
//   fine      the same on the last 7 stages.
// Every probe uses K1's fully reduced arithmetic (common.cuh), since the
// question is about K1-K3; its output is fully reduced and equals the plain
// versions of ops/probes.py bit for bit.  The TPU probe reduces lazily and
// only at the end, so its output is congruent to these mod q.
//
// Bounds (chip_smoke.py probe_bound_ms): each probe reads x and its
// twiddles once and writes out once; its 32-bit multiplies are 3 a Shoup
// product.  mul does 14 products a word, the others 28 N / 2 a row; coarse
// and fine 2 x stages x n / 2 a row.  One CTA a row, 512 threads.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using helib::add_mod;
using helib::mul_shoup;
using helib::sub_mod;

constexpr int kThreads = 512;
constexpr int kRounds = 28;   // kernel_parts.py STAGES
constexpr int kMuls = 14;

enum P1 { kMul = 0, kBfly = 1, kStage = 2, kStageR = 3, kStageC = 4,
          kStageC64 = 5, kStageW = 6 };
enum P2 { kMemory = 0, kCoarse = 1, kFine = 2 };

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
p1_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
          int log_n, const uint32_t* __restrict__ w_all,
          const uint32_t* __restrict__ wsh_all,
          const uint32_t* __restrict__ qs, int tab_rows) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << log_n;
  const int h = n >> 1;
  const size_t row = blockIdx.x;
  const size_t trow = row % static_cast<size_t>(tab_rows);
  const uint32_t q = qs[trow];
  const uint32_t* __restrict__ w = w_all + trow * n;
  const uint32_t* __restrict__ wsh = wsh_all + trow * n;
  const uint32_t* __restrict__ xr = x + row * n;
  uint32_t* __restrict__ outr = out + row * n;

  if constexpr (kVariant == kMul) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      uint32_t v = xr[j];
      const uint32_t wj = w[j], wshj = wsh[j];
#pragma unroll
      for (int i = 0; i < kMuls; ++i) v = mul_shoup(v, wj, wshj, q);
      outr[j] = v;
    }
  } else if constexpr (kVariant == kBfly) {
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
      uint32_t a = xr[j], b = xr[j + h];
      const uint32_t wj = w[j], wshj = wsh[j];
#pragma unroll 4
      for (int i = 0; i < kRounds; ++i) {
        const uint32_t t = mul_shoup(b, wj, wshj, q);
        b = sub_mod(a, t, q);
        a = add_mod(a, t, q);
      }
      outr[j] = a;
      outr[j + h] = b;
    }
  } else {
    // the staged variants: the row in shared memory, a barrier a stage;
    // stage_r and stage_w permute the row, so they write a second buffer
    constexpr bool kPermute = kVariant == kStageR || kVariant == kStageW;
    constexpr int kLogM = kVariant == kStageC64 ? 6 : 2;
    const int log_half = log_n - 1 - kLogM;
    const int half = 1 << log_half;
    uint32_t* src = smem;
    uint32_t* dst = kPermute ? smem + n : smem;
    for (int j = threadIdx.x; j < n; j += blockDim.x) src[j] = xr[j];
    __syncthreads();
    for (int i = 0; i < kRounds; ++i) {
      for (int p = threadIdx.x; p < h; p += blockDim.x) {
        const int blk = p >> log_half;
        const int r = p & (half - 1);
        if constexpr (kVariant == kStageW) {
          const uint32_t u = src[p];
          const uint32_t t = mul_shoup(src[p + h], w[p], wsh[p], q);
          const int o = (blk << (log_half + 1)) + r;
          dst[o] = u;
          dst[o + half] = t;
        } else {
          const int j0 = (blk << (log_half + 1)) + r;
          const int j1 = j0 + half;
          const uint32_t u = src[j0];
          const uint32_t t = mul_shoup(src[j1], w[blk], wsh[blk], q);
          if constexpr (kVariant == kStageR) {
            dst[(blk << log_half) + r] = add_mod(u, t, q);
            dst[h + (blk << log_half) + r] = sub_mod(u, t, q);
          } else {
            dst[j0] = add_mod(u, t, q);
            dst[j1] = sub_mod(u, t, q);
          }
        }
      }
      __syncthreads();
      if constexpr (kPermute) {
        uint32_t* tmp = src;
        src = dst;
        dst = tmp;
      }
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) outr[j] = src[j];
  }
}

// Stages [lo, hi) of the staged transform of helib_tpu/ops/ntt.py on the
// row s, forward (Cooley-Tukey, ascending) or Gentleman-Sande (descending)
// with the same table: the staged network K1-K3 ran before their register
// composites, on a range of stages.
template <bool kInverse>
__device__ __forceinline__ void stage_range(uint32_t* s, int log_n, int lo,
                                            int hi,
                                            const uint32_t* __restrict__ w,
                                            const uint32_t* __restrict__ wsh,
                                            uint32_t q) {
  const int n_half = 1 << (log_n - 1);
  for (int k = lo; k < hi; ++k) {
    const int st = kInverse ? hi - 1 - (k - lo) : k;
    const int log_half = log_n - 1 - st;
    const int half = 1 << log_half;
    const int base = 1 << st;
    for (int b = threadIdx.x; b < n_half; b += blockDim.x) {
      const int i = b >> log_half;
      const int j0 = (i << (log_half + 1)) | (b & (half - 1));
      const int j1 = j0 + half;
      const uint32_t wi = w[base + i];
      const uint32_t wshi = wsh[base + i];
      const uint32_t a = s[j0];
      const uint32_t c = s[j1];
      if constexpr (kInverse) {
        s[j0] = add_mod(a, c, q);
        s[j1] = mul_shoup(sub_mod(a, c, q), wi, wshi, q);
      } else {
        const uint32_t wv = mul_shoup(c, wi, wshi, q);
        s[j0] = add_mod(a, wv, q);
        s[j1] = sub_mod(a, wv, q);
      }
    }
    __syncthreads();
  }
}

template <int kPhase>
__global__ void __launch_bounds__(kThreads)
p2_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
          int log_n, const uint32_t* __restrict__ tw,
          const uint32_t* __restrict__ tw_sh,
          const uint32_t* __restrict__ qs, int tab_rows) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const size_t row = blockIdx.x;
  const size_t trow = row % static_cast<size_t>(tab_rows);
  const uint32_t q = qs[trow];
  const uint32_t* __restrict__ w = tw + trow * n;
  const uint32_t* __restrict__ wsh = tw_sh + trow * n;
  const uint32_t* __restrict__ xr = x + row * n;
  uint32_t* __restrict__ outr = out + row * n;

  if constexpr (kPhase == kMemory) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) s[j] = xr[j] + q;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) outr[j] = s[j] - q;
  } else {
    const int lo = kPhase == kCoarse ? 0 : log_n - 7;
    const int hi = kPhase == kCoarse ? log_n - 7 : log_n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) s[j] = xr[j];
    __syncthreads();
    stage_range<false>(s, log_n, lo, hi, w, wsh, q);
    stage_range<true>(s, log_n, lo, hi, w, wsh, q);
    for (int j = threadIdx.x; j < n; j += blockDim.x) outr[j] = s[j];
  }
}

template <class K>
int launch(K kernel, int smem, const void* x, void* out, long long rows,
           int log_n, const void* w, const void* wsh, const void* q,
           int tab_rows, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), log_n,
      static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(wsh),
      static_cast<const uint32_t*>(q), tab_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// probe 1 (P1): variant 0..6 = mul, bfly, stage, stage_r, stage_c,
// stage_c64, stage_w; probe 2 (P2): variant 0..2 = memory, coarse, fine.
// Row r of x [rows, 2^log_n] uses row r % tab_rows of the tables w/wsh
// [tab_rows, 2^log_n] and of q [tab_rows].  Returns the CUDA error code of
// the launch (cudaErrorInvalidValue for an unknown probe or variant).
int helib_probes_launch(int probe, int variant, const void* x, void* out,
                        long long rows, int log_n, const void* w,
                        const void* wsh, const void* q, int tab_rows,
                        void* stream) {
  if (rows <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int row_bytes = static_cast<int>(sizeof(uint32_t)) << log_n;
  if (probe == 1) {
    switch (variant) {
      case kMul:
        return launch(p1_kernel<kMul>, 0, x, out, rows, log_n, w, wsh, q,
                      tab_rows, st);
      case kBfly:
        return launch(p1_kernel<kBfly>, 0, x, out, rows, log_n, w, wsh, q,
                      tab_rows, st);
      case kStage:
      case kStageC:
        return launch(p1_kernel<kStage>, row_bytes, x, out, rows, log_n, w,
                      wsh, q, tab_rows, st);
      case kStageR:
        return launch(p1_kernel<kStageR>, 2 * row_bytes, x, out, rows,
                      log_n, w, wsh, q, tab_rows, st);
      case kStageC64:
        return launch(p1_kernel<kStageC64>, row_bytes, x, out, rows, log_n,
                      w, wsh, q, tab_rows, st);
      case kStageW:
        return launch(p1_kernel<kStageW>, 2 * row_bytes, x, out, rows,
                      log_n, w, wsh, q, tab_rows, st);
    }
  } else if (probe == 2) {
    switch (variant) {
      case kMemory:
        return launch(p2_kernel<kMemory>, row_bytes, x, out, rows, log_n, w,
                      wsh, q, tab_rows, st);
      case kCoarse:
        return launch(p2_kernel<kCoarse>, row_bytes, x, out, rows, log_n, w,
                      wsh, q, tab_rows, st);
      case kFine:
        return launch(p2_kernel<kFine>, row_bytes, x, out, rows, log_n, w,
                      wsh, q, tab_rows, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
