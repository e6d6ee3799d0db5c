// Fused negacyclic power-of-2 NTT over the RNS rows of a ring element.
//
// Replaces the TPU kernel helib_tpu/ops/pallas_ntt.py::pallas_ntt (kernel
// body _ntt_kernel, wrapper apply_ntt).  For each row of x it computes the
// forward transform (coefficients -> evaluations in `eval_exponents` order)
// or the inverse (evaluations -> coefficients, n^-1 included) mod the row's
// prime, fully reduced, with the staged radix-2 network of
// helib_tpu/ops/ntt.py (ntt_pow2_fwd / ntt_pow2_inv): forward stage s pairs
// (j, j + n/2^(s+1)) inside block i = j / (n/2^s) with twiddle tw[2^s + i];
// the inverse runs the same pairs in reverse stage order with the inverse
// twiddles.  The negacyclic twist lives inside the stage twiddles (root of
// order 2n, first exponent n), so there is no separate psi multiply and no
// bit reversal.
//
// Layout.  x and out are [rows, n] uint32 (int32 bit patterns on the torch
// side), the flattening of [..., P, n]: row r belongs to prime r mod P and
// reads row r mod P of the flat tables [P, n] (Pow2NTT.flat(): stage s at
// [2^s, 2^(s+1)), n^-1 at entry 0 of the inverse table) and of q [P].
//
// Design.  K1's kernel (conv.cu) without the pointwise product: one CTA per
// row keeps the row in dynamic shared memory (n = 32768 words is 128 KB,
// above the 48 KB default, hence the opt-in attribute; it leaves one CTA per
// SM), runs log2(n) butterfly stages with a barrier between stages and
// writes the row back.  Every value stays fully reduced (< q) after each
// 32-bit Shoup product, so the output equals the plain torch version bit for
// bit.  Device memory sees each word of x once and of out once (8 bytes a
// word) against about 1.5 log2(n) 32-bit multiplies a word, so the card's
// memory bounds it (at n = 32768: 8 B against 22.5 multiplies, 2.4 ns
// against 1.3 ns a word); the shared-memory traffic (4 accesses a butterfly)
// and the 15 stage barriers set the time of this simple version.
// Register-resident radix-4/8 stages, several rows a CTA and n = 65536
// (a cluster or two passes) are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using helib::mul_shoup;
using helib::ntt_stages;

constexpr int kThreads = 512;

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
           int log_n, int P, const uint32_t* __restrict__ tw,
           const uint32_t* __restrict__ tw_sh,
           const uint32_t* __restrict__ qs) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const size_t row = blockIdx.x;
  const int prow = static_cast<int>(row % static_cast<size_t>(P));
  const uint32_t q = qs[prow];
  const uint32_t* __restrict__ w = tw + static_cast<size_t>(prow) * n;
  const uint32_t* __restrict__ wsh = tw_sh + static_cast<size_t>(prow) * n;
  const uint32_t* __restrict__ xr = x + row * n;
  uint32_t* __restrict__ outr = out + row * n;

  for (int j = threadIdx.x; j < n; j += blockDim.x) s[j] = xr[j];
  __syncthreads();

  ntt_stages<kInverse>(s, log_n, w, wsh, q);

  if (kInverse) {
    const uint32_t ninv = w[0];
    const uint32_t ninv_sh = wsh[0];
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      outr[j] = mul_shoup(s[j], ninv, ninv_sh, q);
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) outr[j] = s[j];
  }
}

template <bool kInverse>
int launch(const void* x, void* out, long long rows, int log_n, int P,
           const void* tw, const void* tw_sh, const void* q, void* stream) {
  const int smem = static_cast<int>(sizeof(uint32_t)) << log_n;
  cudaError_t err = cudaFuncSetAttribute(
      ntt_kernel<kInverse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_kernel<kInverse><<<static_cast<unsigned>(rows), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), log_n, P,
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tw_sh),
      static_cast<const uint32_t*>(q));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the forward (inverse = 0) or inverse transform of `rows` rows of
// length 2^log_n on `stream`; tw/tw_sh are the flat tables of that
// direction.  Returns the CUDA error code of the launch (0 on success); the
// kernel runs asynchronously and allocates nothing.
int helib_ntt_launch(const void* x, void* out, long long rows, int log_n,
                     int P, const void* tw, const void* tw_sh, const void* q,
                     int inverse, void* stream) {
  if (rows <= 0) return 0;
  return inverse ? launch<true>(x, out, rows, log_n, P, tw, tw_sh, q, stream)
                 : launch<false>(x, out, rows, log_n, P, tw, tw_sh, q,
                                 stream);
}

}  // extern "C"
