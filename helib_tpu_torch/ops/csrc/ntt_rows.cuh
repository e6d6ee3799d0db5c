// The power-of-2 NTT family as register composites: the one device template
// of K1 (conv.cu), K2 (ntt.cu), K3 (conv_aux.cu), K4 and K5 (ntt2.cu).
//
// Replaces the TPU kernels helib_tpu/ops/pallas_ntt.py::pallas_conv (K1,
// kernel body _conv_kernel), ::pallas_ntt (K2, _ntt_kernel),
// ::pallas_conv_shared (K3, _conv_kernel_shared) and
// helib_tpu/ops/pallas_ntt2.py::pallas_ntt2 (K4, _ntt2_kernel) and
// ::pallas_conv2 (K5, _conv2_kernel).  On each row of x [rows, n] uint32
// (int32 bit patterns on the torch side) one of three modes, mod the row's
// prime q_t and fully reduced:
//
//     kConv     out = iNTT(NTT(x) * khat) * n^-1   (K1, K3, K5)
//     kForward  out = NTT(x)                       (K2, K4 forward)
//     kInverse  out = iNTT(x) * n^-1               (K2, K4 inverse)
//
// with the twiddles of flat per-prime tables [T, n] (Pow2NTT.flat(): stage
// s at [2^s, 2^(s+1)), n^-1 at entry 0 of the inverse table), so the
// spectrum is in the `eval_exponents` order and needs no bit reversal (for
// the negacyclic NTT the twist lives in the stage twiddles).  The row map
// says which prime t (row of the tables and of q) and which row of khat
// [3, P, n] row r uses: RowMajor (K1, K5), AuxMajor (K3) and PrimeRows (K2,
// K4) below.
//
// Design.  A staged radix-2 network (K1-K3's first design) makes every one
// of the log2 n stages a shared-memory round trip of the row and a
// __syncthreads(); the staged cost probe of that design took 2.3-2.9x the
// time of the same butterflies held in registers (PERF.md, P1 "before").
// The cost probe P2 (probes.cu) now runs this template's own pieces.  Here
// the stages run as register composites (composite.cuh) under the port's
// schedule ops/ntt2.py schedule(log_n, K): the remainder log_n % K first,
// then composites of K levels, K a template parameter (3 on every default
// path; K4 and K5 take 1 .. 3 from HELIB_NTT_V2_K).  A composite is one
// shared-memory round trip and one barrier: at n = 32768, 5 a direction
// instead of 15.  Values are Harvey-lazy inside a composite (forward below
// 4q, inverse below 2q) and fully reduced before every store to device
// memory, so the output equals the plain versions bit for bit.  A row makes
// one trip in from device memory and one trip out: the first composite
// reads x straight from device memory and the last writes out straight to
// it (the forward's last and the inverse's first composite have L = 1, so
// a thread moves its 2^K consecutive words as 16-byte vectors), and the
// convolution runs its last forward composite, the product by khat (read
// once, 8 bytes a word) and its first inverse composite on one group in
// registers with no barrier between them.  The row lives in shared memory
// at the swizzled index swz(a) between composites.
//
// Cluster.  A row of n = 65536 words (256 KB) does not fit one CTA's shared
// memory, so a cluster of C = 2^c CTAs holds it, CTA h the words
// [h n/C, (h+1) n/C).  The first c stages pair words of different CTAs and
// run as one cross composite (0, c) whose group j < n/C is the C words
// j + t n/C.  Forward, each CTA takes 1/C of the groups, reads each word of
// x once from device memory and writes word t of its groups into CTA t's
// shared memory (distributed shared memory); inverse, each CTA reads its
// groups back from the C CTAs and writes out.  (Every CTA reading all of x
// and keeping its own part, as the staged kernel did, was 20 % slower on the
// H100; PERF.md.)  Between the two, each CTA runs the local schedule
// schedule(log_n - c, K) on its part: local composite (s0, k) is global
// stage c + s0 and local block b is global block (h << s0) + b, which
// selects the twiddles.  Cluster barriers: before the first remote write
// (every CTA of the cluster has started) and after the cross forward
// composite; before the cross inverse composite and after it (no CTA exits
// while another still reads its shared memory).  With C = 4 the cross
// composite is (0, 2) and each quarter of a 65536-word row runs
// schedule(14, K).
//
// Occupancy, chosen on the H100 among the candidates PERF.md lists (all
// bit-identical), and fixed below (kRow*, kCluster*, kNtt15*):
//   * one CTA a row: 512 threads, __launch_bounds__ minimum 2 CTAs an SM
//     (64 registers) and the default shared-memory carveout.  At n = 16384
//     that is K5's time; forcing the largest carveout cost 7 % (the L1 that
//     serves the twiddle and khat reads shrinks), 256 threads x 3 CTAs 2 %,
//     1024 threads 14 %;
//   * n = 65536: a cluster of 4 CTAs of 64 KB, 256 threads and a minimum of
//     3 CTAs an SM (92 clusters resident), 11 % faster than the best 2-CTA
//     cluster (1024 threads, 66 clusters resident) and 22 % than 512-thread
//     2-CTA clusters (K3);
//   * the NTT at n = 32768 (K2 and K4 on the CKKS m=65536 path): one CTA a
//     row of 1024 threads (64 registers, one 128 KB row an SM).  The other
//     candidates took 3 % (4-CTA clusters of 32 KB quarters, 256 threads,
//     4 CTAs an SM) to 40 % (2-CTA clusters of 64 KB halves, 256 threads,
//     3 CTAs an SM, 198 rows resident) longer; one CTA of 512 threads 11 %.
//
// Bounds (hebench/counts.py conv_bound_ms, ntt_bound_ms): the convolution moves
// x in and out (8n bytes a row) and its khat and khat_sh rows (8n bytes)
// against 3 (n log2 n + 2n) 32-bit multiplies -- the multiplies bound K1's
// n = 16384 rows, the bytes K3's n = 65536 rows; the NTT moves 8n bytes a
// row against about 1.5 log2 n multiplies a word, so the bytes bound it.

#pragma once

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "composite.cuh"

namespace helib {

namespace cg = cooperative_groups;

enum Mode : int { kConv, kForward, kInverse };

constexpr int kMaxK = 3;  // ops/ntt2.py K_MAX: the largest composite

// The shipped configurations: threads a CTA and minimum CTAs an SM of the
// one-CTA-a-row kernel (n <= 32768); cluster size, threads a CTA and
// minimum CTAs an SM of the cluster kernel (n = 65536); the same three of
// the power-of-2 NTT at n = 32768.
constexpr int kRowThreads = 512;
constexpr int kRowMinBlocks = 2;
constexpr int kClusterSize = 4;
constexpr int kClusterThreads = 256;
constexpr int kClusterMinBlocks = 3;
constexpr int kNtt15Cluster = 1;
constexpr int kNtt15Threads = 1024;
constexpr int kNtt15MinBlocks = 1;

// The k of composite 0 of schedule(log_n, K); composite c > 0 covers
// stages [first + (c - 1) K, first + c K).
template <int K>
__device__ __forceinline__ int sched_first(int log_n) {
  const int rem = log_n % K;
  return rem ? rem : K;
}

template <int K>
__device__ __forceinline__ int sched_s0(int c, int first) {
  return c == 0 ? 0 : first + (c - 1) * K;
}

template <int K>
__device__ __forceinline__ int sched_k(int c, int first) {
  return c == 0 ? first : K;
}

// K1, K5: x [..., 3, P, n]; row r uses aux prime (r / P) mod 3 and
// spectral row r mod 3P.
struct RowMajor {
  __device__ static void of(long long row, int P, long long, int& t,
                            long long& krow) {
    krow = row % (3LL * P);
    t = static_cast<int>(krow / P);
  }
};

// K3: x [3, ..., P, n]; row r uses aux prime t = r / (rows / 3) and
// spectral row t P + r mod P.
struct AuxMajor {
  __device__ static void of(long long row, int P, long long rows, int& t,
                            long long& krow) {
    t = static_cast<int>(row / (rows / 3));
    krow = static_cast<long long>(t) * P + row % P;
  }
};

// K2, K4: x [..., P, n]; row r uses prime t = r mod P, row t of the flat
// tables [P, n] and of q [P] (no khat).
struct PrimeRows {
  __device__ static void of(long long row, int P, long long, int& t,
                            long long& krow) {
    t = static_cast<int>(row % P);
    krow = 0;
  }
};

__host__ __device__ constexpr int log2_cluster(int cluster) {
  return cluster == 4 ? 2 : cluster == 2 ? 1 : 0;
}

// This CTA's part of the row: the kernel's dynamic shared memory.
__device__ __forceinline__ uint32_t* row_smem() {
  extern __shared__ uint32_t s[];
  return s;
}

// The launch configuration of `rows` rows of 2^log_n words, a cluster of
// kCluster CTAs of kThreads a row, each holding 2^log_n / kCluster words in
// dynamic shared memory.
template <int kCluster, int kThreads>
cudaLaunchConfig_t row_config(long long rows, int log_n, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(uint32_t) << (log_n - log2_cluster(kCluster));
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster > 1 ? 1 : 0;  // one CTA a row: a plain launch
  return cfg;
}

// Composite ci of phase_schedule(lo, lo + stages, K) (ops/ntt2.py; first
// = sched_first<K>(stages)) on this CTA's part, CTA h of a cluster of 2^c:
// levels at global stage c + s0 and global block (h << s0) + b; each group
// from load(r, base, log_l) to store(...).  The kernels run all log_loc
// stages (lo = 0); the cost probe P2 (probes.cu) a part of them.
template <int K, bool kInverse, class Load, class Store>
__device__ __forceinline__ void composite(int log_loc, int lo, int ci,
                                          int first, int c, int h,
                                          const uint32_t* __restrict__ w,
                                          const uint32_t* __restrict__ wsh,
                                          uint32_t q, Load&& load,
                                          Store&& store) {
  const int s0 = lo + sched_s0<K>(ci, first);
  dispatch_k<K>(sched_k<K>(ci, first), [&](auto kc) {
    constexpr int k = decltype(kc)::value;
    for_each_group<k>(
        log_loc, s0, load,
        [&](uint32_t(&r)[1 << k], int b, int, int) {
          levels<k, kInverse>(r, c + s0, (h << s0) + b, w, wsh, q);
        },
        store);
  });
}

// The cross composite (0, c) of a cluster of kCluster = 2^c CTAs, forward:
// CTA h takes the groups j in [h share, (h+1) share), reads the words
// j + u n/C of each from the row xr and writes word u into CTA u's shared
// memory.
template <int kCluster>
__device__ __forceinline__ void cross_forward(uint32_t* s,
                                              const uint32_t* __restrict__ xr,
                                              int log_loc, int h,
                                              const uint32_t* __restrict__ w,
                                              const uint32_t* __restrict__ wsh,
                                              uint32_t q) {
  constexpr int c = log2_cluster(kCluster);
  cg::cluster_group cluster = cg::this_cluster();
  const int share = 1 << (log_loc - c);
  const int j0 = h * share;
  uint32_t* dst[kCluster];
#pragma unroll
  for (int u = 0; u < kCluster; ++u) dst[u] = cluster.map_shared_rank(s, u);
  cluster.sync();
  for (int j = j0 + threadIdx.x; j < j0 + share; j += blockDim.x) {
    uint32_t r[kCluster];
#pragma unroll
    for (int u = 0; u < kCluster; ++u) r[u] = xr[j + (u << log_loc)];
    levels<c, false>(r, 0, 0, w, wsh, q);
#pragma unroll
    for (int u = 0; u < kCluster; ++u) dst[u][swz(j)] = r[u];
  }
  cluster.sync();
}

// The cross composite (0, c), inverse: CTA h reads its groups back from the
// CTAs' shared memory and hands word j + u n/C to store(a, value).
template <int kCluster, class Store>
__device__ __forceinline__ void cross_inverse(uint32_t* s, int log_loc, int h,
                                              const uint32_t* __restrict__ w,
                                              const uint32_t* __restrict__ wsh,
                                              uint32_t q, Store&& store) {
  constexpr int c = log2_cluster(kCluster);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = 1 << (log_loc - c);
  const int j0 = h * share;
  const uint32_t* src[kCluster];
#pragma unroll
  for (int u = 0; u < kCluster; ++u) src[u] = cluster.map_shared_rank(s, u);
  for (int j = j0 + threadIdx.x; j < j0 + share; j += blockDim.x) {
    uint32_t r[kCluster];
#pragma unroll
    for (int u = 0; u < kCluster; ++u) r[u] = src[u][swz(j)];
    levels<c, true>(r, 0, 0, w, wsh, q);
#pragma unroll
    for (int u = 0; u < kCluster; ++u) store(j + (u << log_loc), r[u]);
  }
  cluster.sync();
}

// probes.cu p2_kernel runs this body's sequence of composites (cross
// forward, forward composites, the fused composite, inverse composites,
// cross inverse) over a stage range and without khat: a change to the
// sequence here is mirrored there.
template <class Map, int kMode, int K, int kCluster, int kThreads,
          int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ntt_rows_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                int log_n, int P, long long rows,
                const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ tw_sh,
                const uint32_t* __restrict__ itw,
                const uint32_t* __restrict__ itw_sh,
                const uint32_t* __restrict__ khat,
                const uint32_t* __restrict__ khat_sh,
                const uint32_t* __restrict__ qs) {
  static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4,
                "a cluster of 1, 2 or 4 CTAs");
  static_assert(K >= 1 && K <= 3, "composites of 1 .. 3 levels");
  constexpr bool kFwd = kMode != kInverse;  // runs forward levels
  constexpr bool kInv = kMode != kForward;  // runs inverse levels
  constexpr int c = log2_cluster(kCluster);
  uint32_t* const s = row_smem();
  const int n = 1 << log_n;
  const int log_loc = log_n - c;
  const long long row = blockIdx.x / kCluster;
  int h = 0;  // this CTA's part of the row
  if constexpr (kCluster > 1)
    h = static_cast<int>(cg::this_cluster().block_rank());
  int t;
  long long krow;
  Map::of(row, P, rows, t, krow);
  const uint32_t q = qs[t];
  const size_t trow = static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ w_f = kFwd ? tw + trow : nullptr;
  const uint32_t* __restrict__ wsh_f = kFwd ? tw_sh + trow : nullptr;
  const uint32_t* __restrict__ w_i = kInv ? itw + trow : nullptr;
  const uint32_t* __restrict__ wsh_i = kInv ? itw_sh + trow : nullptr;
  const size_t own = static_cast<size_t>(h) << log_loc;
  const uint32_t* __restrict__ xr = x + row * n;
  uint32_t* __restrict__ outr = out + row * n;
  const uint32_t ninv = kInv ? w_i[0] : 0;
  const uint32_t ninv_sh = kInv ? wsh_i[0] : 0;

  const SmemIO sm{s};
  auto sload = [&](auto& r, int base, int log_l) { sm.load(r, base, log_l); };
  auto sstore = [&](auto& r, int base, int log_l) {
    sm.store(r, base, log_l);
  };
  auto xload = [&](auto& r, int base, int log_l) {
    GlobalIO::load(xr + own, r, base, log_l);
  };
  auto reduce = [&](uint32_t v) {
    return kMode == kForward ? csub(csub(v, 2 * q), q)
                             : csub(mul_lazy(v, ninv, ninv_sh, q), q);
  };
  auto ostore = [&](auto& r, int base, int log_l) {
    for (auto& v : r) v = reduce(v);
    GlobalIO::store(outr + own, r, base, log_l);
  };
  const int first = sched_first<K>(log_loc);
  const int last = (log_loc - first) / K;  // the last local composite

  // forward: the cross composite, x -> the CTAs' shared memory, then local
  // composites 0 .. last-1 (with one CTA a row the first reads x)
  if constexpr (kFwd) {
    if constexpr (kCluster > 1)
      cross_forward<kCluster>(s, xr, log_loc, h, w_f, wsh_f, q);
    for (int ci = 0; ci < last; ++ci) {
      if (kCluster == 1 && ci == 0) {
        composite<K, false>(log_loc, 0, ci, first, c, h, w_f, wsh_f, q, xload,
                            sstore);
      } else {
        composite<K, false>(log_loc, 0, ci, first, c, h, w_f, wsh_f, q, sload,
                            sstore);
      }
      __syncthreads();
    }
  }

  // composite `last` on one group in registers: the last forward composite
  // (to out in kForward), the product by khat and the first inverse
  // composite (from x in kInverse)
  {
    const int s0 = sched_s0<K>(last, first);
    const size_t krow_n = static_cast<size_t>(krow) * n + own;
    dispatch_k<K>(sched_k<K>(last, first), [&](auto kc) {
      constexpr int k = decltype(kc)::value;
      auto body = [&](uint32_t(&r)[1 << k], int b, int base, int log_l) {
        const int bg = (h << s0) + b;
        if constexpr (kFwd) levels<k, false>(r, c + s0, bg, w_f, wsh_f, q);
        if constexpr (kMode == kConv) {
#pragma unroll
          for (int i = 0; i < (1 << k); ++i) {
            const size_t a = krow_n + base + (i << log_l);
            r[i] = mul_lazy(r[i], __ldg(khat + a), __ldg(khat_sh + a), q);
          }
        }
        if constexpr (kInv) levels<k, true>(r, c + s0, bg, w_i, wsh_i, q);
      };
      const bool one = kCluster == 1 && last == 0;  // the row's only one
      const bool in_x = kMode == kInverse || one;
      const bool to_out = kMode == kForward || one;
      if (in_x && to_out) {
        for_each_group<k>(log_loc, s0, xload, body, ostore);
      } else if (in_x) {
        for_each_group<k>(log_loc, s0, xload, body, sstore);
      } else if (to_out) {
        for_each_group<k>(log_loc, s0, sload, body, ostore);
      } else {
        for_each_group<k>(log_loc, s0, sload, body, sstore);
      }
    });
  }

  // inverse: local composites last-1 .. 0 (with one CTA a row the last
  // writes out), then the cross composite, the CTAs' shared memory -> out
  if constexpr (kInv) {
    for (int ci = last - 1; ci >= 0; --ci) {
      __syncthreads();
      if (kCluster == 1 && ci == 0) {
        composite<K, true>(log_loc, 0, ci, first, c, h, w_i, wsh_i, q, sload,
                           ostore);
      } else {
        composite<K, true>(log_loc, 0, ci, first, c, h, w_i, wsh_i, q, sload,
                           sstore);
      }
    }
    if constexpr (kCluster > 1)
      cross_inverse<kCluster>(s, log_loc, h, w_i, wsh_i, q,
                              [&](int a, uint32_t v) { outr[a] = reduce(v); });
  }
}

// The launch of one configuration: `rows` rows of 2^log_n words, a cluster
// of kCluster CTAs a row, each holding 2^log_n / kCluster words in dynamic
// shared memory.  Pointers a mode does not read may be null: kForward
// reads tw, tw_sh and q; kInverse itw, itw_sh and q.
template <class Map, int kMode, int K, int kCluster, int kThreads,
          int kMinBlocks>
struct Rows {
  static auto kernel() {
    return ntt_rows_kernel<Map, kMode, K, kCluster, kThreads, kMinBlocks>;
  }

  static cudaLaunchConfig_t config(long long rows, int log_n,
                                   cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
    return row_config<kCluster, kThreads>(rows, log_n, stream, attr);
  }

  static cudaError_t prepare(const cudaLaunchConfig_t& cfg) {
    return cudaFuncSetAttribute(kernel(),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(cfg.dynamicSmemBytes));
  }

  static int launch(const void* x, void* out, long long rows, int log_n,
                    int P, const void* tw, const void* tw_sh, const void* itw,
                    const void* itw_sh, const void* khat, const void* khat_sh,
                    const void* q, cudaStream_t stream) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(rows, log_n, stream, &attr);
    cudaError_t err = prepare(cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(
        &cfg, kernel(), static_cast<const uint32_t*>(x),
        static_cast<uint32_t*>(out), log_n, P, rows,
        static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tw_sh),
        static_cast<const uint32_t*>(itw),
        static_cast<const uint32_t*>(itw_sh),
        static_cast<const uint32_t*>(khat),
        static_cast<const uint32_t*>(khat_sh),
        static_cast<const uint32_t*>(q));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
};

// The power-of-2 NTT of K2 (K = 3) and K4 (K = its composite cap) in mode
// kForward or kInverse on the shipped configuration of its size: one CTA
// of 512 threads a row up to n = 16384, one of 1024 (kNtt15*) at
// n = 32768, K3's 4-CTA cluster at n = 65536.
// w/wsh are the flat tables of that direction.
template <int kMode, int K>
struct NttRows {
  template <int kCluster, int kThreads, int kMinBlocks>
  using At = Rows<PrimeRows, kMode, K, kCluster, kThreads, kMinBlocks>;
  using Small = At<1, kRowThreads, kRowMinBlocks>;
  using N15 = At<kNtt15Cluster, kNtt15Threads, kNtt15MinBlocks>;
  using N16 = At<kClusterSize, kClusterThreads, kClusterMinBlocks>;

  static int launch(const void* x, void* out, long long rows, int log_n,
                    int P, const void* w, const void* wsh, const void* q,
                    cudaStream_t s) {
    const void* tw = kMode == kForward ? w : nullptr;
    const void* tw_sh = kMode == kForward ? wsh : nullptr;
    const void* itw = kMode == kInverse ? w : nullptr;
    const void* itw_sh = kMode == kInverse ? wsh : nullptr;
    if (log_n == 16)
      return N16::launch(x, out, rows, log_n, P, tw, tw_sh, itw, itw_sh,
                         nullptr, nullptr, q, s);
    if (log_n == 15)
      return N15::launch(x, out, rows, log_n, P, tw, tw_sh, itw, itw_sh,
                         nullptr, nullptr, q, s);
    return Small::launch(x, out, rows, log_n, P, tw, tw_sh, itw, itw_sh,
                         nullptr, nullptr, q, s);
  }
};

// helib_ntt_launch / helib_ntt2_launch: rows of 2^log_n words,
// 3 <= log_n <= 16, forward (inverse = 0) or inverse.
template <int K>
int launch_ntt(const void* x, void* out, long long rows, int log_n, int P,
               const void* w, const void* wsh, const void* q, int inverse,
               void* stream) {
  if (rows <= 0) return 0;
  if (log_n < 3 || log_n > 16) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return inverse
             ? NttRows<kInverse, K>::launch(x, out, rows, log_n, P, w, wsh,
                                            q, s)
             : NttRows<kForward, K>::launch(x, out, rows, log_n, P, w, wsh,
                                            q, s);
}

}  // namespace helib
