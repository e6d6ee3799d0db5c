// Code shared by the port's kernel sources: the error-string export of each
// library (every source includes this header), and the fully reduced 32-bit
// modular arithmetic of the cost probes' staged stages (probes.cu).
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

}  // namespace helib

// Each source including this header is its own shared library (loaded
// RTLD_LOCAL by ops/_build.py), so each exports this symbol once.
extern "C" const char* helib_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
