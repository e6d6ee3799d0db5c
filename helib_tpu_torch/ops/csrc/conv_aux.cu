// Fused cyclic convolution mod an auxiliary prime on the aux-major layout:
// the Bluestein hot loop for every transform size but B = 16384.
//
// Replaces the TPU kernel helib_tpu/ops/pallas_ntt.py::pallas_conv_shared
// (kernel body _conv_kernel_shared, wrapper apply_conv_aux).  For each row of
// x it computes, as conv.cu does,
//
//     out = iNTT(NTT(x) * khat) * n^-1   mod q_t
//
// with the staged radix-2 network of helib_tpu/ops/ntt.py (ntt_pow2_fwd /
// ntt_pow2_inv, common.cuh ntt_stages), so the spectrum is in the
// `eval_exponents` order of khat and no bit reversal is needed.
//
// Layout.  x and out are [rows, n] uint32 (int32 bit patterns on the torch
// side), the flattening of the aux-major [3, ..., P, n]: row r belongs to aux
// prime t = r / (rows / 3) and reads spectral row t * P + r % P of khat
// [3, P, n], so khat is never broadcast over the lead dims in memory.  The
// stage tables are the flat per-aux-prime rows [3, n] that conv.cu reads
// (Pow2NTT.flat(): stage s at [2^s, 2^(s+1)), n^-1 at entry 0 of the
// inverse table).
//
// Design.  n <= 32768: one CTA per row with the whole row in dynamic shared
// memory (at most 128 KB), as conv.cu.  n = 65536 (256 KB a row, above the
// 227 KB a CTA may hold): a cluster of two CTAs per row, each holding one
// 128 KB half.  The staged network splits cleanly there:
//   * forward stage 0 pairs (j, j + n/2) with the single twiddle tw[1]; each
//     CTA reads both halves from device memory and keeps only its own output
//     half (u + w v for half 0, u - w v for half 1): no exchange;
//   * forward stages 1 .. 15, the khat product and inverse stages 15 .. 1
//     stay inside one half; half h's local block i is the global block
//     h 2^(s-1) + i, which selects the twiddle (ntt_stages' first/boff);
//   * inverse stage 0 (u = a + b, v = (a - b) w) needs the partner's half:
//     after a cluster barrier each CTA reads it through distributed shared
//     memory and writes its own output half times n^-1; a second cluster
//     barrier keeps either CTA from exiting while its partner still reads.
// The kernel is templated on the cluster size (1 or 2); 4 would serve
// n = 131072.  Every value stays fully reduced after each 32-bit Shoup
// product, so the output equals the plain torch version bit for bit.
//
// Bound.  A row moves x in and out back (8n bytes) and its khat and khat_sh
// rows (8n bytes; the tables, 16n bytes per aux prime, are shared by all its
// rows through L2), against 3 (n log2 n + 2n) 32-bit multiplies: at
// n = 65536, 1 MB (0.31 us at 3.35 TB/s) against 3.5 M multiplies (0.21 us at
// 16.75 T/s), so the card's memory bounds it.  This simple version is set
// instead by the shared-memory traffic (4 accesses a butterfly), the 32 stage
// barriers and one CTA a SM; register-resident radix-4/8 stages, TMA and
// several rows a CTA are later work.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using helib::add_mod;
using helib::mul_shoup;
using helib::ntt_stages;
using helib::sub_mod;

constexpr int kThreads = 512;

template <int kCluster>
__global__ void __launch_bounds__(kThreads)
conv_aux_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                int log_n, int P, long long rows_per_prime,
                const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ tw_sh,
                const uint32_t* __restrict__ itw,
                const uint32_t* __restrict__ itw_sh,
                const uint32_t* __restrict__ khat,
                const uint32_t* __restrict__ khat_sh,
                const uint32_t* __restrict__ aux_q) {
  static_assert(kCluster == 1 || kCluster == 2, "cluster of 1 or 2 CTAs");
  extern __shared__ uint32_t s[];
  constexpr int kSplit = kCluster == 2 ? 1 : 0;  // log2(kCluster)
  const int n = 1 << log_n;
  const int log_loc = log_n - kSplit;
  const int n_loc = 1 << log_loc;
  const long long row = blockIdx.x / kCluster;
  int h = 0;  // this CTA's half of the row
  if constexpr (kCluster == 2)
    h = static_cast<int>(cg::this_cluster().block_rank());
  const int t = static_cast<int>(row / rows_per_prime);
  const size_t krow = static_cast<size_t>(t) * P + static_cast<int>(row % P);
  const uint32_t q = aux_q[t];
  const uint32_t* __restrict__ w_f = tw + static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ wsh_f = tw_sh + static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ w_i = itw + static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ wsh_i = itw_sh + static_cast<size_t>(t) * n;
  const size_t own = static_cast<size_t>(h) * n_loc;  // this CTA's part
  const uint32_t* __restrict__ kh = khat + krow * n + own;
  const uint32_t* __restrict__ khsh = khat_sh + krow * n + own;
  const uint32_t* __restrict__ xr = x + static_cast<size_t>(row) * n;
  uint32_t* __restrict__ outr = out + static_cast<size_t>(row) * n + own;

  if constexpr (kCluster == 1) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) s[j] = xr[j];
  } else {
    // forward stage 0 across the halves: twiddle tw[2^0 + 0]
    const uint32_t w1 = w_f[1];
    const uint32_t w1sh = wsh_f[1];
    for (int j = threadIdx.x; j < n_loc; j += blockDim.x) {
      const uint32_t u = xr[j];
      const uint32_t wv = mul_shoup(xr[j + n_loc], w1, w1sh, q);
      s[j] = h == 0 ? add_mod(u, wv, q) : sub_mod(u, wv, q);
    }
  }
  __syncthreads();

  ntt_stages<false>(s, log_loc, w_f, wsh_f, q, kSplit, h);

  for (int j = threadIdx.x; j < n_loc; j += blockDim.x)
    s[j] = mul_shoup(s[j], kh[j], khsh[j], q);
  __syncthreads();

  ntt_stages<true>(s, log_loc, w_i, wsh_i, q, kSplit, h);

  const uint32_t ninv = w_i[0];
  const uint32_t ninv_sh = wsh_i[0];
  if constexpr (kCluster == 1) {
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      outr[j] = mul_shoup(s[j], ninv, ninv_sh, q);
  } else {
    // inverse stage 0 across the halves: half 0 gets a + b, half 1
    // (a - b) itw[1], with a from half 0 and b from half 1
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const uint32_t* peer = cluster.map_shared_rank(s, h ^ 1);
    const uint32_t w1 = w_i[1];
    const uint32_t w1sh = wsh_i[1];
    for (int j = threadIdx.x; j < n_loc; j += blockDim.x) {
      const uint32_t mine = s[j];
      const uint32_t other = peer[j];
      const uint32_t v = h == 0 ? add_mod(mine, other, q)
                                : mul_shoup(sub_mod(other, mine, q), w1, w1sh,
                                            q);
      outr[j] = mul_shoup(v, ninv, ninv_sh, q);
    }
    cluster.sync();
  }
}

template <int kCluster>
cudaLaunchConfig_t config(long long rows, int log_n, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(uint32_t) << (log_n - (kCluster == 2));
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster > 1 ? 1 : 0;  // one CTA a row: a plain launch
  return cfg;
}

template <int kCluster>
int launch(const void* x, void* out, long long rows, int log_n, int P,
           const void* tw, const void* tw_sh, const void* itw,
           const void* itw_sh, const void* khat, const void* khat_sh,
           const void* aux_q, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<kCluster>(rows, log_n, stream, &attr);
  cudaError_t err = cudaFuncSetAttribute(
      conv_aux_kernel<kCluster>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg.dynamicSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(
      &cfg, conv_aux_kernel<kCluster>, static_cast<const uint32_t*>(x),
      static_cast<uint32_t*>(out), log_n, P, rows / 3,
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tw_sh),
      static_cast<const uint32_t*>(itw), static_cast<const uint32_t*>(itw_sh),
      static_cast<const uint32_t*>(khat),
      static_cast<const uint32_t*>(khat_sh),
      static_cast<const uint32_t*>(aux_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the convolution of `rows` rows (a multiple of 3, aux-major) of
// length 2^log_n on `stream`; log_n = 16 runs one 2-CTA cluster a row.
// Returns the CUDA error code of the launch (0 on success); the kernel runs
// asynchronously and allocates nothing.
int helib_conv_aux_launch(const void* x, void* out, long long rows,
                          int log_n, int P, const void* tw, const void* tw_sh,
                          const void* itw, const void* itw_sh,
                          const void* khat, const void* khat_sh,
                          const void* aux_q, void* stream) {
  if (rows <= 0) return 0;
  if (rows % 3 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return log_n == 16
             ? launch<2>(x, out, rows, log_n, P, tw, tw_sh, itw, itw_sh, khat,
                         khat_sh, aux_q, s)
             : launch<1>(x, out, rows, log_n, P, tw, tw_sh, itw, itw_sh, khat,
                         khat_sh, aux_q, s);
}

// The number of 2-CTA clusters of the n = 65536 kernel the card can hold at
// once (cudaOccupancyMaxActiveClusters) in *clusters; returns the CUDA error
// code.  0 clusters means the launch cannot run on this card.
int helib_conv_aux_max_clusters(int* clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<2>(2, 16, nullptr, &attr);
  cudaError_t err = cudaFuncSetAttribute(
      conv_aux_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg.dynamicSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, conv_aux_kernel<2>, &cfg));
}

}  // extern "C"
