// The v2 (block-list) schedule of the power-of-2 NTT on Hopper: the device
// code of K4 and K5 (ntt2.cu), kept apart from common.cuh so that K1, K2
// and K3 compile exactly as before.
//
// A composite (s0, k) covers global stages [s0, s0 + k).  Its groups are
// the 2^k words  base + t * L,  t < 2^k,  with L = n / 2^(s0 + k) and
// base = b * n / 2^s0 + j0 for block b < 2^s0 and j0 < L; group g is
// (b, j0) = (g / L, g % L), so consecutive threads take consecutive j0 and
// a warp reads 32 consecutive words whenever L >= 32.  One thread loads its
// group into registers, runs the k levels there, and stores it back: one
// barrier per composite instead of one per stage.
//
// Values inside a composite are Harvey-lazy, as the TPU kernel keeps them
// (pallas_ntt2.py _fwd_composite / _inv_composite): forward levels take and
// give values below 4q, inverse levels below 2q.  Every prime is below 2^30,
// so 4q < 2^32, and mul_lazy gives [0, 2q) for any 32-bit input.  The
// kernels reduce fully before every store to device memory, so their output
// equals the fully reduced plain versions bit for bit.
//
// The row lives in shared memory between composites at the swizzled index
// a ^ ((a >> 5) & 31): it permutes each 32-word row, so the coalesced
// copies stay free of bank conflicts, and it spreads the groups of a warp
// over the banks when L < 32.  (A simulation of the warps' addresses puts
// the k = 3 schedules at 1.7 shared-memory wavefronts an access on average
// with it, 3.4 without.)

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace helib {

constexpr int kMaxComposites = 16;

// The host's schedule: composite c covers stages [s0[c], s0[c] + k[c]).
struct Schedule {
  int count;
  int s0[kMaxComposites];
  int k[kMaxComposites];
};

template <int V>
struct IntC {
  static constexpr int value = V;
};

__device__ __forceinline__ int swz(int a) { return a ^ ((a >> 5) & 31); }

__device__ __forceinline__ uint32_t csub(uint32_t v, uint32_t q) {
  return v >= q ? v - q : v;
}

// a * w mod q in [0, 2q) for any 32-bit a (wsh = floor(w 2^32 / q)).
__device__ __forceinline__ uint32_t mul_lazy(uint32_t a, uint32_t w,
                                             uint32_t wsh, uint32_t q) {
  return a * w - __umulhi(a, wsh) * q;
}

// Calls f(IntC<k>{}) for the runtime k in 1..K, so each composite size
// has its own fully unrolled code.
template <int K, class F>
__device__ __forceinline__ void dispatch_k(int k, F&& f) {
  if (k == K) {
    f(IntC<K>{});
  } else if constexpr (K > 1) {
    dispatch_k<K - 1>(k, f);
  }
}

// The butterflies of level j, class c (the pairs t, t + 2^(k-1-j) with
// t >> (k - j) == c) under the twiddle (wv, wsv).
template <int k, bool kInverse>
__device__ __forceinline__ void butterflies(uint32_t (&r)[1 << k], int j,
                                            int c, uint32_t wv, uint32_t wsv,
                                            uint32_t q) {
  const uint32_t q2 = 2 * q;
  const int stride = 1 << (k - 1 - j);
#pragma unroll
  for (int o = 0; o < stride; ++o) {
    const int t = (c << (k - j)) + o;
    if constexpr (kInverse) {
      const uint32_t a = r[t];
      const uint32_t d = r[t + stride];
      r[t] = csub(a + d, q2);
      r[t + stride] = mul_lazy(a + q2 - d, wv, wsv, q);
    } else {
      const uint32_t u = csub(r[t], q2);
      const uint32_t v = mul_lazy(r[t + stride], wv, wsv, q);
      r[t] = u + v;
      r[t + stride] = u + q2 - v;
    }
  }
}

// The k levels of composite (s0, k) on one group held in r, block b.
// Forward (Cooley-Tukey, levels ascending) on inputs below 4q; inverse
// (Gentleman-Sande, levels descending) on inputs below 2q.
template <int k, bool kInverse>
__device__ __forceinline__ void levels(uint32_t (&r)[1 << k], int s0, int b,
                                       const uint32_t* __restrict__ w,
                                       const uint32_t* __restrict__ wsh,
                                       uint32_t q) {
#pragma unroll
  for (int jj = 0; jj < k; ++jj) {
    const int j = kInverse ? k - 1 - jj : jj;
    const int base = (1 << (s0 + j)) + (b << j);
#pragma unroll
    for (int c = 0; c < (1 << j); ++c)
      butterflies<k, kInverse>(r, j, c, __ldg(w + base + c),
                               __ldg(wsh + base + c), q);
  }
}

// Runs composite (s0, k) over every group of the row, threads striding
// over the groups: r[t] = load(word), body(r, b, base, log_l), then
// store(word, r[t]) for word = base + t * L.
template <int k, class Load, class Body, class Store>
__device__ __forceinline__ void for_each_group(int log_n, int s0, Load&& load,
                                               Body&& body, Store&& store) {
  const int log_l = log_n - s0 - k;
  const int groups = 1 << (log_n - k);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int b = g >> log_l;
    const int base = (b << (log_n - s0)) | (g & ((1 << log_l) - 1));
    uint32_t r[1 << k];
#pragma unroll
    for (int t = 0; t < (1 << k); ++t) r[t] = load(base + (t << log_l));
    body(r, b, base, log_l);
#pragma unroll
    for (int t = 0; t < (1 << k); ++t) store(base + (t << log_l), r[t]);
  }
}

}  // namespace helib
