// Cost probes P1 and P2: what bounds the port's kernels (K1 .. K5, the row
// template ntt_rows.cuh) -- the 32-bit multiplies, the trips through shared
// memory, or the barriers and the cluster's traffic between composites.
//
// P1 replaces the TPU probe benchmarks/kernel_parts.py::run (kernel
// kern_mul): the same seven variants on rows of N words, one application a
// launch, each variant a kernel of its own:
//   mul       14 chained Shoup products a word;
//   bfly      28 butterflies on the pair (j, j + N/2), twiddle w[j];
//   stage     28 radix-2 stages of m = 4 blocks (pairs (i 2h + r,
//             i 2h + h + r), h = N / 2m, twiddle w[i]), written in place;
//   stage_c   the TPU's concatenate-along-the-block-axis form of `stage`:
//             the same function and the same memory order, so here one
//             instantiation with `stage`;
//   stage_c64 `stage` at m = 64;
//   stage_r   `stage` with the sums written to the first half of the row
//             and the differences to the second;
//   stage_w   the pair (j, j + N/2) (twiddle w[j]), the value and the
//             product written interleaved by blocks (no add).
// P2 replaces benchmarks/kernel_phases.py::make (inner kern): K1's pieces
// one at a time, on rows of n words (n = 2^7 .. 2^16), row r on prime r % T
// of the flat tables [T, n]:
//   memory    the row into shared memory (+q) and back (-q): the identity;
//   coarse    forward stages [0, log2 n - 7), then their Gentleman-Sande
//             butterflies in reverse order with the same forward tables (as
//             kernel_phases.py passes only forward tables), no n^-1;
//   fine      the same on the last 7 stages.
// Every output is fully reduced and equals the plain versions of
// ops/probes.py bit for bit (the TPU probes reduce lazily; P1 ends in the
// same residues, P2 in congruent ones).
//
// P1's design.  The TPU probe holds a block of rows in VMEM and relays it
// out each stage; on Hopper every variant is register-local.  mul and bfly
// act on a word or a fixed pair; stage, stage_c and stage_c64 write each
// pair (j0, j0 + h) back in place, so it meets only itself for all 28
// rounds; stage_r and stage_w permute the row, but only by rotating its top
// 3 index bits -- (blk1, blk0, side) -> (side, blk1, blk0) for stage_r, the
// inverse rotation for stage_w -- so the 8 words that share the low
// log2(h) bits form a closed orbit.  So a thread owns closed orbits for all
// rounds, with no shared memory and no barrier: four of them at
// consecutive low indices, moved as one 16-byte vector, so a warp reads and
// writes 512 contiguous bytes at each of the orbit's strides.  A round's
// permutation is a compile-time relabelling of the registers (the rotation
// has period 3: three rounds unrolled, repeated); each word's twiddle
// follows its current block (stage_w holds its 4 blocks' twiddles).  Values
// are Harvey-lazy (composite.cuh), reduced once before the store.  The
// grid covers the rows' orbits, kP1Threads a CTA, at least kP1MinBlocks
// CTAs an SM.  Bounds (chip_smoke.py probe_bound_ms, 3 multiplies a Shoup
// product): mul moves x, w, wsh and out (16 bytes a word); bfly and stage_w
// read w, wsh for half the row (12 bytes a word); the staged variants move
// 8 bytes a word against 42 multiplies, so the multiplies bound them.
//
// P2's design: K1's template itself.  The stage range runs as register
// composites of phase_schedule(lo, hi, 3) (ops/ntt2.py) with the
// composite.cuh/ntt_rows.cuh helpers: one trip through the swizzled shared
// row and one barrier a composite, the first composite reading x and the
// last writing out, the range's last forward composite and its first
// Gentleman-Sande one fused on one group in registers; memory moves 2^3
// consecutive words a thread as 16-byte vectors, as K1's last composite
// does.  The configuration is K1's (one CTA of 512 threads a row, at least
// 2 an SM) up to n = 16384, K2's at n = 32768 (1024 threads) and K3's at
// n = 65536: a cluster of 4 CTAs of 64 KB quarters, where coarse begins
// with the cross composite through distributed shared memory
// (cross_forward) and ends with cross_inverse, while memory and fine stay
// inside each CTA's quarter.  So coarse at n = 65536 against n = 16384
// measures what the cluster costs.  Bounds: x in and out (8 bytes a word)
// and the range's table entries, against 3 multiplies a butterfly; the
// distributed shared memory is on-chip traffic, not in the bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_rows.cuh"

namespace {

using helib::butterflies;
using helib::csub;
using helib::GlobalIO;
using helib::mul_lazy;

constexpr int kRounds = 28;   // kernel_parts.py STAGES
constexpr int kMuls = 14;
constexpr int kFineStages = 7;  // kernel_phases.py: the last 7 stages
constexpr int kLanes = 4;     // words a thread moves as one 16-byte vector

// P1's configuration: threads a CTA, minimum CTAs an SM, chosen on the
// H100 among 64 x 8, 128 x 4, 256 x 2, 256 x 4 and 512 x 2
// (tools/probe_times.py --set; PERF.md).
constexpr int kP1Threads = 128;
constexpr int kP1MinBlocks = 4;

enum P1 { kMul = 0, kBfly = 1, kStage = 2, kStageR = 3, kStageC = 4,
          kStageC64 = 5, kStageW = 6 };
enum P2 { kMemory = 0, kCoarse = 1, kFine = 2 };

// log2 of the number of blocks of a staged variant
__host__ __device__ constexpr int p1_log_m(int variant) {
  return variant == kStageC64 ? 6 : 2;
}

// The least log2 N a variant takes: 4 lanes of a pair or an orbit.
__host__ __device__ constexpr int p1_min_log_n(int variant) {
  return variant == kMul || variant == kBfly ? 3 : p1_log_m(variant) + 3;
}

// log2 of the threads a row of 2^log_n words takes: 4 words (mul), 4 pairs
// (bfly, the in-place stages) or 4 orbits of 8 words (stage_r, stage_w).
template <int kVariant>
__host__ __device__ constexpr int p1_log_threads(int log_n) {
  return kVariant == kMul ? log_n - 2
         : kVariant == kStageR || kVariant == kStageW ? log_n - 5
                                                      : log_n - 3;
}

// The round of stage_r on one orbit in r (index = the top 3 bits of the
// word's position): the butterflies of blocks b = 0 .. 3 on (2b, 2b + 1),
// then the relabelling (blk1, blk0, side) -> (side, blk1, blk0).
__device__ __forceinline__ void round_r(uint32_t (&r)[8],
                                        const uint32_t (&wv)[4],
                                        const uint32_t (&ws)[4], uint32_t q) {
#pragma unroll
  for (int b = 0; b < 4; ++b) butterflies<3, false>(r, 2, b, wv[b], ws[b], q);
  uint32_t t[8];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    t[b] = r[2 * b];
    t[4 + b] = r[2 * b + 1];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = t[i];
}

// The round of stage_w: (side, blk1, blk0) -> (blk1, blk0, side), the
// second half's words times the twiddle of their block.
__device__ __forceinline__ void round_w(uint32_t (&r)[8],
                                        const uint32_t (&wv)[4],
                                        const uint32_t (&ws)[4], uint32_t q) {
  uint32_t t[8];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    t[2 * b] = r[b];
    t[2 * b + 1] = mul_lazy(r[4 + b], wv[b], ws[b], q);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = t[i];
}

template <int kVariant>
__global__ void __launch_bounds__(kP1Threads, kP1MinBlocks)
p1_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
          long long rows, int log_n, const uint32_t* __restrict__ w_all,
          const uint32_t* __restrict__ wsh_all,
          const uint32_t* __restrict__ qs, int tab_rows) {
  const int log_t = p1_log_threads<kVariant>(log_n);
  const long long g =
      static_cast<long long>(blockIdx.x) * kP1Threads + threadIdx.x;
  const long long row = g >> log_t;
  if (row >= rows) return;
  const int i = static_cast<int>(g & ((1LL << log_t) - 1));
  const long long trow = row % tab_rows;
  const uint32_t q = qs[trow];
  const uint32_t q2 = 2 * q;
  const uint32_t* __restrict__ xr = x + (row << log_n);
  uint32_t* __restrict__ outr = out + (row << log_n);
  const uint32_t* __restrict__ w = w_all + (trow << log_n);
  const uint32_t* __restrict__ wsh = wsh_all + (trow << log_n);

  if constexpr (kVariant == kMul) {
    const int j = i * kLanes;
    uint32_t v[kLanes], wv[kLanes], ws[kLanes];
    GlobalIO::load(xr, v, j, 0);
    GlobalIO::load(w, wv, j, 0);
    GlobalIO::load(wsh, ws, j, 0);
#pragma unroll
    for (int m = 0; m < kMuls; ++m)
#pragma unroll
      for (int l = 0; l < kLanes; ++l) v[l] = mul_lazy(v[l], wv[l], ws[l], q);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v[l] = csub(v[l], q);
    GlobalIO::store(outr, v, j, 0);
  } else if constexpr (kVariant == kStageR || kVariant == kStageW) {
    // four orbits: lane l holds the words (p << log_half) + j + l, p < 8
    const int log_half = log_n - 3;
    const int j = i * kLanes;
    uint32_t r[kLanes][8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      uint32_t v[kLanes];
      GlobalIO::load(xr, v, (p << log_half) + j, 0);
#pragma unroll
      for (int l = 0; l < kLanes; ++l) r[l][p] = v[l];
    }
    // the twiddle and companion of block b: w[b] (stage_r), or lane l's
    // w[(b << log_half) + j + l] (stage_w)
    uint32_t wv[kLanes][4], ws[kLanes][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      uint32_t a[kLanes], c[kLanes];
      if constexpr (kVariant == kStageW) {
        GlobalIO::load(w, a, (b << log_half) + j, 0);
        GlobalIO::load(wsh, c, (b << log_half) + j, 0);
      } else {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          a[l] = __ldg(w + b);
          c[l] = __ldg(wsh + b);
        }
      }
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        wv[l][b] = a[l];
        ws[l][b] = c[l];
      }
    }
    auto round = [&] {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        if constexpr (kVariant == kStageR) {
          round_r(r[l], wv[l], ws[l], q);
        } else {
          round_w(r[l], wv[l], ws[l], q);
        }
      }
    };
    // three rounds bring every label back: unroll three, repeat
#pragma unroll 1
    for (int it = 0; it < kRounds / 3; ++it) {
      round();
      round();
      round();
    }
#pragma unroll
    for (int it = 0; it < kRounds % 3; ++it) round();
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      uint32_t v[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        v[l] = kVariant == kStageR ? csub(csub(r[l][p], q2), q)
                                   : csub(r[l][p], q);
      GlobalIO::store(outr, v, (p << log_half) + j, 0);
    }
  } else {
    // bfly: the pairs (j + l, j + l + N/2) under w[j + l]; the in-place
    // stages: pairs (j0 + l, j0 + l + half) of block blk under w[blk]
    int j0, stride;
    uint32_t wv[kLanes], ws[kLanes];
    if constexpr (kVariant == kBfly) {
      j0 = i * kLanes;
      stride = 1 << (log_n - 1);
      GlobalIO::load(w, wv, j0, 0);
      GlobalIO::load(wsh, ws, j0, 0);
    } else {
      const int log_half = log_n - 1 - p1_log_m(kVariant);
      const int blk = (i * kLanes) >> log_half;
      j0 = (blk << (log_half + 1)) + ((i * kLanes) & ((1 << log_half) - 1));
      stride = 1 << log_half;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        wv[l] = __ldg(w + blk);
        ws[l] = __ldg(wsh + blk);
      }
    }
    uint32_t a[kLanes], b[kLanes];
    GlobalIO::load(xr, a, j0, 0);
    GlobalIO::load(xr, b, j0 + stride, 0);
    uint32_t r[kLanes][2];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      r[l][0] = a[l];
      r[l][1] = b[l];
    }
#pragma unroll 4
    for (int it = 0; it < kRounds; ++it)
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        butterflies<1, false>(r[l], 0, 0, wv[l], ws[l], q);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      a[l] = csub(csub(r[l][0], q2), q);
      b[l] = csub(csub(r[l][1], q2), q);
    }
    GlobalIO::store(outr, a, j0, 0);
    GlobalIO::store(outr, b, j0 + stride, 0);
  }
}

template <int kVariant>
int p1_launch(const void* x, void* out, long long rows, int log_n,
              const void* w, const void* wsh, const void* q, int tab_rows,
              cudaStream_t stream) {
  if (log_n < p1_min_log_n(kVariant) || log_n > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = rows << p1_log_threads<kVariant>(log_n);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((threads + kP1Threads - 1) /
                                           kP1Threads));
  cfg.blockDim = dim3(kP1Threads);
  cfg.stream = stream;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, p1_kernel<kVariant>, static_cast<const uint32_t*>(x),
      static_cast<uint32_t*>(out), rows, log_n,
      static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(wsh),
      static_cast<const uint32_t*>(q), tab_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// P2 `kPhase` on a cluster of kCluster CTAs a row (ntt_rows.cuh's names:
// CTA h holds the words [h n/C, (h+1) n/C) at local stages s = global
// stage - log2 C).  Its coarse and fine phases follow
// ntt_rows_kernel's sequence of composites, over a stage range and without
// khat; a change to that sequence is mirrored here.
template <int kPhase, int kCluster, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
p2_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
          int log_n, const uint32_t* __restrict__ tw,
          const uint32_t* __restrict__ tw_sh,
          const uint32_t* __restrict__ qs, int tab_rows) {
  using namespace helib;
  constexpr int K = kMaxK;
  constexpr int c = log2_cluster(kCluster);
  constexpr bool kCross = kCluster > 1 && kPhase == kCoarse;
  uint32_t* const s = row_smem();
  const int log_loc = log_n - c;
  const long long row = blockIdx.x / kCluster;
  int h = 0;
  if constexpr (kCluster > 1)
    h = static_cast<int>(cg::this_cluster().block_rank());
  const long long t = row % tab_rows;
  const uint32_t q = qs[t];
  const uint32_t* __restrict__ w = tw + (t << log_n);
  const uint32_t* __restrict__ wsh = tw_sh + (t << log_n);
  const size_t own = static_cast<size_t>(h) << log_loc;
  const uint32_t* __restrict__ xr = x + (row << log_n);
  uint32_t* __restrict__ outr = out + (row << log_n);

  const SmemIO sm{s};
  auto sload = [&](auto& r, int base, int log_l) { sm.load(r, base, log_l); };
  auto sstore = [&](auto& r, int base, int log_l) {
    sm.store(r, base, log_l);
  };
  auto xload = [&](auto& r, int base, int log_l) {
    GlobalIO::load(xr + own, r, base, log_l);
  };
  auto ostore = [&](auto& r, int base, int log_l) {
    for (auto& v : r) v = csub(v, q);
    GlobalIO::store(outr + own, r, base, log_l);
  };

  if constexpr (kPhase == kMemory) {
    const int s0 = log_loc - K;  // groups of 2^K consecutive words
    for_each_group<K>(
        log_loc, s0, xload,
        [&](uint32_t(&r)[1 << K], int, int, int) {
          for (auto& v : r) v += q;
        },
        sstore);
    __syncthreads();
    for_each_group<K>(
        log_loc, s0, sload,
        [&](uint32_t(&r)[1 << K], int, int, int) {
          for (auto& v : r) v -= q;
        },
        [&](auto& r, int base, int log_l) {
          GlobalIO::store(outr + own, r, base, log_l);
        });
    return;
  }

  // the local stage range [lo, hi) as composites 0 .. last of
  // phase_schedule(lo, hi, K)
  const int lo = kPhase == kCoarse ? 0 : log_loc - kFineStages;
  const int hi = kPhase == kCoarse ? log_loc - kFineStages : log_loc;
  if (lo == hi) {  // coarse at n = 2^7: no stage
    for (int j = threadIdx.x; j < (1 << log_n); j += kThreads)
      outr[j] = xr[j];
    return;
  }
  const int first = sched_first<K>(hi - lo);
  const int last = (hi - lo - first) / K;

  if constexpr (kCross) cross_forward<kCluster>(s, xr, log_loc, h, w, wsh, q);
  for (int ci = 0; ci < last; ++ci) {
    if (!kCross && ci == 0) {
      composite<K, false>(log_loc, lo, ci, first, c, h, w, wsh, q, xload,
                          sstore);
    } else {
      composite<K, false>(log_loc, lo, ci, first, c, h, w, wsh, q, sload,
                          sstore);
    }
    __syncthreads();
  }

  // composite `last` on one group in registers: its forward levels, the
  // forward's < 4q brought below 2q, its Gentleman-Sande levels
  {
    const int s0 = lo + sched_s0<K>(last, first);
    dispatch_k<K>(sched_k<K>(last, first), [&](auto kc) {
      constexpr int k = decltype(kc)::value;
      auto body = [&](uint32_t(&r)[1 << k], int b, int, int) {
        const int bg = (h << s0) + b;
        levels<k, false>(r, c + s0, bg, w, wsh, q);
        for (auto& v : r) v = csub(v, 2 * q);
        levels<k, true>(r, c + s0, bg, w, wsh, q);
      };
      if (!kCross && last == 0) {  // the range's only composite
        for_each_group<k>(log_loc, s0, xload, body, ostore);
      } else {
        for_each_group<k>(log_loc, s0, sload, body, sstore);
      }
    });
  }

  for (int ci = last - 1; ci >= 0; --ci) {
    __syncthreads();
    if (!kCross && ci == 0) {
      composite<K, true>(log_loc, lo, ci, first, c, h, w, wsh, q, sload,
                         ostore);
    } else {
      composite<K, true>(log_loc, lo, ci, first, c, h, w, wsh, q, sload,
                         sstore);
    }
  }
  if constexpr (kCross)
    cross_inverse<kCluster>(s, log_loc, h, w, wsh, q,
                            [&](int a, uint32_t v) { outr[a] = csub(v, q); });
}

// P2 on one configuration: a cluster of kCluster CTAs of kThreads a row,
// at least kMinBlocks CTAs an SM, the row's 2^log_n / kCluster words of
// each CTA in dynamic shared memory.
template <int kCluster, int kThreads, int kMinBlocks>
struct P2Rows {
  template <int kPhase>
  static int run(const void* x, void* out, long long rows, int log_n,
                 const void* w, const void* wsh, const void* q, int tab_rows,
                 cudaStream_t stream) {
    const auto kernel = p2_kernel<kPhase, kCluster, kThreads, kMinBlocks>;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        helib::row_config<kCluster, kThreads>(rows, log_n, stream, &attr);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cfg.dynamicSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint32_t*>(x),
                             static_cast<uint32_t*>(out), log_n,
                             static_cast<const uint32_t*>(w),
                             static_cast<const uint32_t*>(wsh),
                             static_cast<const uint32_t*>(q), tab_rows);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }

  static int launch(int phase, const void* x, void* out, long long rows,
                    int log_n, const void* w, const void* wsh, const void* q,
                    int tab_rows, cudaStream_t stream) {
    switch (phase) {
      case kMemory:
        return run<kMemory>(x, out, rows, log_n, w, wsh, q, tab_rows, stream);
      case kCoarse:
        return run<kCoarse>(x, out, rows, log_n, w, wsh, q, tab_rows, stream);
      case kFine:
        return run<kFine>(x, out, rows, log_n, w, wsh, q, tab_rows, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

using P2Row = P2Rows<1, helib::kRowThreads, helib::kRowMinBlocks>;
using P2Row15 = P2Rows<helib::kNtt15Cluster, helib::kNtt15Threads,
                       helib::kNtt15MinBlocks>;
using P2Cluster = P2Rows<helib::kClusterSize, helib::kClusterThreads,
                         helib::kClusterMinBlocks>;

}  // namespace

extern "C" {

// probe 1 (P1): variant 0..6 = mul, bfly, stage, stage_r, stage_c,
// stage_c64, stage_w, at 2^3 <= N <= 2^15 (the staged variants from
// 2^(log2 m + 3)); probe 2 (P2): variant 0..2 = memory, coarse, fine, at
// 2^7 <= n <= 2^16.  Row r of x [rows, 2^log_n] uses row r % tab_rows of
// the tables w/wsh [tab_rows, 2^log_n] and of q [tab_rows]; x, out (and
// P1's w, wsh) start on a 16-byte boundary.  Returns the CUDA error code of
// the launch (cudaErrorInvalidValue for an unknown probe or variant or a
// size out of range).
int helib_probes_launch(int probe, int variant, const void* x, void* out,
                        long long rows, int log_n, const void* w,
                        const void* wsh, const void* q, int tab_rows,
                        void* stream) {
  if (rows <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (probe == 1) {
    switch (variant) {
      case kMul:
        return p1_launch<kMul>(x, out, rows, log_n, w, wsh, q, tab_rows, st);
      case kBfly:
        return p1_launch<kBfly>(x, out, rows, log_n, w, wsh, q, tab_rows, st);
      case kStage:
      case kStageC:
        return p1_launch<kStage>(x, out, rows, log_n, w, wsh, q, tab_rows,
                                 st);
      case kStageR:
        return p1_launch<kStageR>(x, out, rows, log_n, w, wsh, q, tab_rows,
                                  st);
      case kStageC64:
        return p1_launch<kStageC64>(x, out, rows, log_n, w, wsh, q, tab_rows,
                                    st);
      case kStageW:
        return p1_launch<kStageW>(x, out, rows, log_n, w, wsh, q, tab_rows,
                                  st);
    }
  } else if (probe == 2) {
    if (log_n < kFineStages || log_n > 16)
      return static_cast<int>(cudaErrorInvalidValue);
    if (log_n == 16)
      return P2Cluster::launch(variant, x, out, rows, log_n, w, wsh, q,
                               tab_rows, st);
    if (log_n == 15)
      return P2Row15::launch(variant, x, out, rows, log_n, w, wsh, q,
                             tab_rows, st);
    return P2Row::launch(variant, x, out, rows, log_n, w, wsh, q, tab_rows,
                         st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
