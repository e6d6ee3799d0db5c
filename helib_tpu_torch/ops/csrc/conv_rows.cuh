// The Bluestein convolution as register composites: the one device template
// of K1 (conv.cu, row-major) and K3 (conv_aux.cu, aux-major).
//
// Replaces the TPU kernels helib_tpu/ops/pallas_ntt.py::pallas_conv (K1,
// kernel body _conv_kernel) and ::pallas_conv_shared (K3, kernel body
// _conv_kernel_shared).  For each row of x it computes
//
//     out = iNTT(NTT(x) * khat) * n^-1   mod q_t
//
// with the twiddles of the flat per-aux-prime tables [3, n] (Pow2NTT.flat():
// stage s at [2^s, 2^(s+1)), n^-1 at entry 0 of the inverse table), so the
// spectrum is in the `eval_exponents` order of khat and needs no bit
// reversal.  x and out are [rows, n] uint32 (int32 bit patterns on the torch
// side).  K1 and K3 differ only in the row map -- which aux prime t and which
// row of khat [3, P, n] row r uses (RowMajor, AuxMajor below) -- and in K3's
// thread-block cluster at n = 65536.
//
// Design.  The staged radix-2 network of common.cuh ntt_stages (which K2
// still runs) makes every one of the 2 log2 n stages a shared-memory round
// trip of the row and a __syncthreads(); the cost probes (probes.cu) put
// such a stage at about 3x the same butterflies held in registers.  Here the
// stages run as K5's register composites (composite.cuh) under the port's
// schedule ops/ntt2.py schedule(log_n, 3): the remainder log_n % 3 first,
// then composites of 3 levels.  A composite is one shared-memory round trip
// and one barrier: at n = 16384, 5 a direction instead of 14.  Values are
// Harvey-lazy inside a composite (forward below 4q, inverse below 2q) and
// fully reduced before every store to device memory, so the output equals
// conv_plain / conv_aux_plain bit for bit.  The first forward composite
// reads x straight from device memory; the last forward composite, the
// product by khat (read once, 8 bytes a word) and the first inverse
// composite cover the same stages and run on one group in registers with no
// barrier between them; the last inverse composite writes out times n^-1
// straight to device memory.  The row lives in shared memory at the swizzled
// index swz(a) between composites.
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
// schedule(log_n - c, 3) on its part: local composite (s0, k) is global stage
// c + s0 and local block b is global block (h << s0) + b, which selects the
// twiddles.  Four cluster barriers: before the first remote write (every CTA
// of the cluster has started), after the cross forward composite, before the
// cross inverse composite, and after it (no CTA exits while another still
// reads its shared memory).  With C = 2 this is exactly schedule(16, 3),
// whose k = 1 remainder falls on stage 0; with C = 4 the cross composite is
// (0, 2) and each quarter runs schedule(14, 3).
//
// Occupancy, chosen on the H100 among the candidates PERF.md lists (all
// bit-identical), and fixed below (kRow*, kCluster*):
//   * one CTA a row: 512 threads, __launch_bounds__ minimum 2 CTAs an SM
//     (64 registers, as K5) and the default shared-memory carveout.  At
//     n = 16384 that is K5's time; forcing the largest carveout cost 7 %
//     (the L1 that serves the twiddle and khat reads shrinks), 256 threads
//     x 3 CTAs 2 %, 1024 threads 14 %;
//   * n = 65536: a cluster of 4 CTAs of 64 KB, 256 threads and a minimum of
//     3 CTAs an SM (80 registers; 92 clusters resident), 11 % faster than
//     the best 2-CTA cluster (1024 threads, 66 clusters resident) and 22 %
//     than 512-thread 2-CTA clusters.
//
// Bound, unchanged (chip_smoke.py conv_bound_ms): a row moves x in and out
// (8n bytes) and its khat and khat_sh rows (8n bytes) against
// 3 (n log2 n + 2n) 32-bit multiplies: the multiplies bound K1's n = 16384
// rows, the bytes K3's n = 65536 rows.

#pragma once

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "composite.cuh"

namespace helib {

namespace cg = cooperative_groups;

constexpr int kConvK = 3;  // ops/ntt2.py K_MAX: the largest composite

// The shipped configurations: threads a CTA and minimum CTAs an SM of the
// one-CTA-a-row kernel (n <= 32768); cluster size, threads a CTA and
// minimum CTAs an SM of the cluster kernel (n = 65536).
constexpr int kRowThreads = 512;
constexpr int kRowMinBlocks = 2;
constexpr int kClusterSize = 4;
constexpr int kClusterThreads = 256;
constexpr int kClusterMinBlocks = 3;

// The k of composite 0 of schedule(log_n, kConvK); composite c > 0 covers
// stages [first + (c - 1) kConvK, first + c kConvK).
__device__ __forceinline__ int sched_first(int log_n) {
  const int rem = log_n % kConvK;
  return rem ? rem : kConvK;
}

__device__ __forceinline__ int sched_s0(int c, int first) {
  return c == 0 ? 0 : first + (c - 1) * kConvK;
}

__device__ __forceinline__ int sched_k(int c, int first) {
  return c == 0 ? first : kConvK;
}

// K1: x [..., 3, P, n]; row r uses aux prime (r / P) mod 3 and spectral row
// r mod 3P.
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

__host__ __device__ constexpr int log2_cluster(int cluster) {
  return cluster == 4 ? 2 : cluster == 2 ? 1 : 0;
}

template <class Map, int kCluster, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv_rows_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int log_n, int P, long long rows,
                 const uint32_t* __restrict__ tw,
                 const uint32_t* __restrict__ tw_sh,
                 const uint32_t* __restrict__ itw,
                 const uint32_t* __restrict__ itw_sh,
                 const uint32_t* __restrict__ khat,
                 const uint32_t* __restrict__ khat_sh,
                 const uint32_t* __restrict__ aux_q) {
  static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4,
                "a cluster of 1, 2 or 4 CTAs");
  constexpr int c = log2_cluster(kCluster);
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const int log_loc = log_n - c;
  const long long row = blockIdx.x / kCluster;
  int h = 0;  // this CTA's part of the row
  if constexpr (kCluster > 1)
    h = static_cast<int>(cg::this_cluster().block_rank());
  int t;
  long long krow;
  Map::of(row, P, rows, t, krow);
  const uint32_t q = aux_q[t];
  const uint32_t* __restrict__ w_f = tw + static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ wsh_f = tw_sh + static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ w_i = itw + static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ wsh_i = itw_sh + static_cast<size_t>(t) * n;
  const size_t own = static_cast<size_t>(h) << log_loc;
  const uint32_t* __restrict__ kh = khat + krow * n + own;
  const uint32_t* __restrict__ khsh = khat_sh + krow * n + own;
  const uint32_t* __restrict__ xr = x + row * n;
  uint32_t* __restrict__ outr = out + row * n;
  const uint32_t ninv = w_i[0];
  const uint32_t ninv_sh = wsh_i[0];

  auto sload = [&](int a) { return s[swz(a)]; };
  auto sstore = [&](int a, uint32_t v) { s[swz(a)] = v; };
  auto gload = [&](int a) { return xr[a]; };
  auto gstore = [&](int a, uint32_t v) {
    outr[a] = csub(mul_lazy(v, ninv, ninv_sh, q), q);
  };
  const int first = sched_first(log_loc);
  const int last = (log_loc - first) / kConvK;  // the last local composite

  // the cross composite (0, c), forward: x -> the CTAs' shared memory
  if constexpr (kCluster > 1) {
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
      levels<c, false>(r, 0, 0, w_f, wsh_f, q);
#pragma unroll
      for (int u = 0; u < kCluster; ++u) dst[u][swz(j)] = r[u];
    }
    cluster.sync();
  }

  // forward composites 0 .. last-1 of this CTA's part
  for (int ci = 0; ci < last; ++ci) {
    const int s0 = sched_s0(ci, first);
    dispatch_k<kConvK>(sched_k(ci, first), [&](auto kc) {
      constexpr int k = decltype(kc)::value;
      auto body = [&](uint32_t(&r)[1 << k], int b, int, int) {
        levels<k, false>(r, c + s0, (h << s0) + b, w_f, wsh_f, q);
      };
      if (kCluster == 1 && ci == 0) {
        for_each_group<k>(log_loc, s0, gload, body, sstore);
      } else {
        for_each_group<k>(log_loc, s0, sload, body, sstore);
      }
    });
    __syncthreads();
  }

  // the last forward composite, the product by khat and the first inverse
  // composite on one group in registers
  {
    const int s0 = sched_s0(last, first);
    dispatch_k<kConvK>(sched_k(last, first), [&](auto kc) {
      constexpr int k = decltype(kc)::value;
      auto body = [&](uint32_t(&r)[1 << k], int b, int base, int log_l) {
        const int bg = (h << s0) + b;
        levels<k, false>(r, c + s0, bg, w_f, wsh_f, q);
#pragma unroll
        for (int i = 0; i < (1 << k); ++i) {
          const int a = base + (i << log_l);
          r[i] = mul_lazy(r[i], __ldg(kh + a), __ldg(khsh + a), q);
        }
        levels<k, true>(r, c + s0, bg, w_i, wsh_i, q);
      };
      if (kCluster == 1 && last == 0) {
        for_each_group<k>(log_loc, s0, gload, body, gstore);
      } else {
        for_each_group<k>(log_loc, s0, sload, body, sstore);
      }
    });
  }

  // inverse composites last-1 .. 0 of this CTA's part
  for (int ci = last - 1; ci >= 0; --ci) {
    __syncthreads();
    const int s0 = sched_s0(ci, first);
    dispatch_k<kConvK>(sched_k(ci, first), [&](auto kc) {
      constexpr int k = decltype(kc)::value;
      auto body = [&](uint32_t(&r)[1 << k], int b, int, int) {
        levels<k, true>(r, c + s0, (h << s0) + b, w_i, wsh_i, q);
      };
      if (kCluster == 1 && ci == 0) {
        for_each_group<k>(log_loc, s0, sload, body, gstore);
      } else {
        for_each_group<k>(log_loc, s0, sload, body, sstore);
      }
    });
  }

  // the cross composite (0, c), inverse: the CTAs' shared memory -> out
  if constexpr (kCluster > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int share = 1 << (log_loc - c);
    const int j0 = h * share;
    const uint32_t* src[kCluster];
#pragma unroll
    for (int u = 0; u < kCluster; ++u)
      src[u] = cluster.map_shared_rank(s, u);
    for (int j = j0 + threadIdx.x; j < j0 + share; j += blockDim.x) {
      uint32_t r[kCluster];
#pragma unroll
      for (int u = 0; u < kCluster; ++u) r[u] = src[u][swz(j)];
      levels<c, true>(r, 0, 0, w_i, wsh_i, q);
#pragma unroll
      for (int u = 0; u < kCluster; ++u) gstore(j + (u << log_loc), r[u]);
    }
    cluster.sync();
  }
}

// The launch of one configuration: `rows` rows of 2^log_n words, a cluster
// of kCluster CTAs a row, each holding 2^log_n / kCluster words in dynamic
// shared memory.
template <class Map, int kCluster, int kThreads, int kMinBlocks>
struct ConvRows {
  static auto kernel() {
    return conv_rows_kernel<Map, kCluster, kThreads, kMinBlocks>;
  }

  static cudaLaunchConfig_t config(long long rows, int log_n,
                                   cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows * kCluster));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes =
        sizeof(uint32_t) << (log_n - log2_cluster(kCluster));
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = kCluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = kCluster > 1 ? 1 : 0;  // one CTA a row: a plain launch
    return cfg;
  }

  static cudaError_t prepare(const cudaLaunchConfig_t& cfg) {
    return cudaFuncSetAttribute(kernel(),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(cfg.dynamicSmemBytes));
  }

  static int launch(const void* x, void* out, long long rows, int log_n,
                    int P, const void* tw, const void* tw_sh, const void* itw,
                    const void* itw_sh, const void* khat, const void* khat_sh,
                    const void* aux_q, cudaStream_t stream) {
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
        static_cast<const uint32_t*>(aux_q));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }

  // How many clusters of this configuration at 2^log_n words the card holds
  // at once (cudaOccupancyMaxActiveClusters).
  static int max_clusters(int log_n, int* clusters) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(kCluster, log_n, nullptr, &attr);
    cudaError_t err = prepare(cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(clusters, kernel(), &cfg));
  }
};

}  // namespace helib
