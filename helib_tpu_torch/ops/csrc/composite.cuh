// The register composites of the power-of-2 NTT on Hopper: the device
// helpers of the row template ntt_rows.cuh (K1 .. K5).
//
// A composite (s0, k) covers global stages [s0, s0 + k).  Its groups are
// the 2^k words  base + t * L,  t < 2^k,  with L = n / 2^(s0 + k) and
// base = b * n / 2^s0 + j0 for block b < 2^s0 and j0 < L; group g is
// (b, j0) = (g / L, g % L), so consecutive threads take consecutive j0 and
// a warp reads 32 consecutive words whenever L >= 32.  One thread loads its
// group into registers, runs the k levels there, and stores it back: one
// barrier per composite instead of one per stage.  Where L = 1 (the last
// composite of a row) a group is 2^k consecutive words, which a thread moves
// to and from device memory as 16-byte vectors (GlobalIO).
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

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace helib {

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

// A group's words in shared memory, at the swizzled index.
struct SmemIO {
  uint32_t* s;

  template <size_t N>
  __device__ __forceinline__ void load(uint32_t (&r)[N], int base,
                                       int log_l) const {
#pragma unroll
    for (int t = 0; t < static_cast<int>(N); ++t)
      r[t] = s[swz(base + (t << log_l))];
  }

  template <size_t N>
  __device__ __forceinline__ void store(const uint32_t (&r)[N], int base,
                                        int log_l) const {
#pragma unroll
    for (int t = 0; t < static_cast<int>(N); ++t)
      s[swz(base + (t << log_l))] = r[t];
  }
};

// A group's words in device memory at p (16-byte aligned): with L = 1 the
// group is N consecutive words, moved as 16-byte (N >= 4) or 8-byte
// vectors; otherwise word by word, a warp's threads on consecutive words.
struct GlobalIO {
  template <size_t N>
  __device__ __forceinline__ static void load(const uint32_t* __restrict__ p,
                                              uint32_t (&r)[N], int base,
                                              int log_l) {
    if constexpr (N >= 4) {
      if (log_l == 0) {
        const uint4* v = reinterpret_cast<const uint4*>(p + base);
#pragma unroll
        for (int i = 0; i < static_cast<int>(N) / 4; ++i) {
          const uint4 w = v[i];
          r[4 * i] = w.x;
          r[4 * i + 1] = w.y;
          r[4 * i + 2] = w.z;
          r[4 * i + 3] = w.w;
        }
        return;
      }
    } else if constexpr (N == 2) {
      if (log_l == 0) {
        const uint2 w = *reinterpret_cast<const uint2*>(p + base);
        r[0] = w.x;
        r[1] = w.y;
        return;
      }
    }
#pragma unroll
    for (int t = 0; t < static_cast<int>(N); ++t) r[t] = p[base + (t << log_l)];
  }

  template <size_t N>
  __device__ __forceinline__ static void store(uint32_t* __restrict__ p,
                                               const uint32_t (&r)[N],
                                               int base, int log_l) {
    if constexpr (N >= 4) {
      if (log_l == 0) {
        uint4* v = reinterpret_cast<uint4*>(p + base);
#pragma unroll
        for (int i = 0; i < static_cast<int>(N) / 4; ++i)
          v[i] = make_uint4(r[4 * i], r[4 * i + 1], r[4 * i + 2],
                            r[4 * i + 3]);
        return;
      }
    } else if constexpr (N == 2) {
      if (log_l == 0) {
        *reinterpret_cast<uint2*>(p + base) = make_uint2(r[0], r[1]);
        return;
      }
    }
#pragma unroll
    for (int t = 0; t < static_cast<int>(N); ++t) p[base + (t << log_l)] = r[t];
  }
};

// Runs composite (s0, k) over every group of a part of 2^log_n words,
// threads striding over the groups: load(r, base, log_l), body(r, b, base,
// log_l), store(r, base, log_l), where group word t is base + t * L.
template <int k, class Load, class Body, class Store>
__device__ __forceinline__ void for_each_group(int log_n, int s0, Load&& load,
                                               Body&& body, Store&& store) {
  const int log_l = log_n - s0 - k;
  const int groups = 1 << (log_n - k);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int b = g >> log_l;
    const int base = (b << (log_n - s0)) | (g & ((1 << log_l) - 1));
    uint32_t r[1 << k];
    load(r, base, log_l);
    body(r, b, base, log_l);
    store(r, base, log_l);
  }
}

}  // namespace helib
