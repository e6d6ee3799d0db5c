// Code shared by the port's kernels (conv.cu, ntt.cu, conv_aux.cu): fully
// reduced 32-bit modular arithmetic, the staged radix-2 power-of-2 NTT on a
// row held in shared memory, and the error-string export of each library.
//
// Residues are uint32 values below a prime q < 2^30 (int32 bit patterns on
// the torch side).  Every function returns a value in [0, q), so a kernel
// built from them equals the plain torch version (ops/modops.py, ops/ntt.py)
// bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace helib {

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t r = a + b;  // a, b < q < 2^30: no wrap
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t r = a + q - b;
  return r >= q ? r - q : r;
}

// a * w mod q with the Shoup companion wsh = floor(w 2^32 / q); for any
// 32-bit a the wrapped difference lies in [0, 2q).
__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w,
                                              uint32_t wsh, uint32_t q) {
  const uint32_t hi = __umulhi(a, wsh);
  const uint32_t r = a * w - hi * q;
  return r >= q ? r - q : r;
}

// The staged transforms of helib_tpu/ops/ntt.py (ntt_pow2_fwd /
// ntt_pow2_inv) on the row s[0, 2^log_n), all threads of the CTA taking
// part.  Forward stage st pairs (j, j + n/2^(st+1)) inside block
// i = j / (n/2^st) with twiddle w[2^st + i], so the output is in
// `eval_exponents` order without a bit reversal; the inverse runs the same
// pairs in reverse stage order (its n^-1 product is left to the caller).
// w/wsh are one prime's flat table and its Shoup companions
// (Pow2NTT.flat()).  Each stage ends in a barrier.
//
// A CTA that holds one of 2^first equal parts of a longer row (a cluster,
// conv_aux.cu) runs that row's stages first .. first + log_n - 1, which stay
// inside its part: local stage st is global stage first + st, and its local
// block i is the global block boff * 2^st + i, where boff is the part's
// index.  first = boff = 0 is the whole row.
template <bool kInverse>
__device__ __forceinline__ void ntt_stages(uint32_t* s, int log_n,
                                           const uint32_t* __restrict__ w,
                                           const uint32_t* __restrict__ wsh,
                                           uint32_t q, int first = 0,
                                           int boff = 0) {
  const int n_half = 1 << (log_n - 1);
  for (int k = 0; k < log_n; ++k) {
    const int st = kInverse ? log_n - 1 - k : k;
    const int log_half = log_n - 1 - st;
    const int half = 1 << log_half;
    const int base = (1 << (first + st)) + (boff << st);
    for (int b = threadIdx.x; b < n_half; b += blockDim.x) {
      const int i = b >> log_half;
      const int j0 = (i << (log_half + 1)) | (b & (half - 1));
      const int j1 = j0 + half;
      const uint32_t wi = w[base + i];
      const uint32_t wshi = wsh[base + i];
      if (kInverse) {
        const uint32_t a = s[j0];
        const uint32_t c = s[j1];
        s[j0] = add_mod(a, c, q);
        s[j1] = mul_shoup(sub_mod(a, c, q), wi, wshi, q);
      } else {
        const uint32_t u = s[j0];
        const uint32_t wv = mul_shoup(s[j1], wi, wshi, q);
        s[j0] = add_mod(u, wv, q);
        s[j1] = sub_mod(u, wv, q);
      }
    }
    __syncthreads();
  }
}

}  // namespace helib

// Each source including this header is its own shared library (loaded
// RTLD_LOCAL by ops/_build.py), so each exports this symbol once.
extern "C" const char* helib_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
