// Fused cyclic convolution mod an auxiliary prime: the Bluestein hot loop.
//
// Replaces the TPU kernel helib_tpu/ops/pallas_ntt.py::pallas_conv
// (kernel body _conv_kernel).  For each row of x it computes
//
//     out = iNTT(NTT(x) * khat) * n^-1   mod q_t
//
// with the staged radix-2 network of helib_tpu/ops/ntt.py (ntt_pow2_fwd /
// ntt_pow2_inv): forward stage s pairs (j, j + n/2^(s+1)) inside block
// i = j / (n/2^s) with twiddle tw[2^s + i], so the spectrum is in the same
// `eval_exponents` order as khat and no bit reversal is needed.
//
// Layout.  x and out are [rows, n] uint32 (int32 bit patterns on the torch
// side), the flattening of [..., 3, P, n]: row r belongs to aux prime
// t = (r / P) % 3 and reads spectral row r % (3P) of khat [3, P, n], so the
// kernel is never broadcast over the batch in memory.  The stage tables are
// the flat per-aux-prime rows [3, n] of Pow2NTT.flat(): stage s at
// [2^s, 2^(s+1)), n^-1 at entry 0 of the inverse table.
//
// Design.  One CTA per row keeps the whole row in dynamic shared memory
// (n = 16384 words is 64 KB, above the 48 KB default, hence the opt-in
// attribute), runs log2(n) forward butterfly stages with a barrier between
// stages, the pointwise Shoup multiply by khat, log2(n) inverse stages, the
// n^-1 multiply, and writes the row back.  Every value is kept fully reduced
// (< q) with 32-bit Shoup products (__umulhi), so the output equals the
// plain torch version bit for bit.  Device memory is touched once per word
// (x in, out back, khat and the tables read through L1/L2); the arithmetic is
// about 3 (n log2 n + 2n) 32-bit multiplies per row, comparable to the bytes
// at n = 16384, and the stage barriers and shared-memory traffic come on top.
// TMA, wgmma, clusters and multi-row CTAs are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

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

__global__ void __launch_bounds__(kThreads)
conv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
            int log_n, int P,
            const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
            const uint32_t* __restrict__ itw,
            const uint32_t* __restrict__ itw_sh,
            const uint32_t* __restrict__ khat,
            const uint32_t* __restrict__ khat_sh,
            const uint32_t* __restrict__ aux_q) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const int n_half = n >> 1;
  const size_t row = blockIdx.x;
  const int krow = static_cast<int>(row % (3 * static_cast<size_t>(P)));
  const int t = krow / P;
  const uint32_t q = aux_q[t];
  const uint32_t* __restrict__ w_f = tw + static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ wsh_f = tw_sh + static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ w_i = itw + static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ wsh_i = itw_sh + static_cast<size_t>(t) * n;
  const uint32_t* __restrict__ kh = khat + static_cast<size_t>(krow) * n;
  const uint32_t* __restrict__ khsh = khat_sh + static_cast<size_t>(krow) * n;
  const uint32_t* __restrict__ xr = x + row * n;
  uint32_t* __restrict__ outr = out + row * n;

  for (int j = threadIdx.x; j < n; j += blockDim.x) s[j] = xr[j];
  __syncthreads();

  // forward: stage st has 2^st blocks of 2 * half words
  for (int st = 0; st < log_n; ++st) {
    const int log_half = log_n - 1 - st;
    const int half = 1 << log_half;
    const int base = 1 << st;
    for (int b = threadIdx.x; b < n_half; b += blockDim.x) {
      const int i = b >> log_half;
      const int j0 = (i << (log_half + 1)) | (b & (half - 1));
      const int j1 = j0 + half;
      const uint32_t u = s[j0];
      const uint32_t wv = mul_shoup(s[j1], w_f[base + i], wsh_f[base + i], q);
      s[j0] = add_mod(u, wv, q);
      s[j1] = sub_mod(u, wv, q);
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < n; j += blockDim.x)
    s[j] = mul_shoup(s[j], kh[j], khsh[j], q);
  __syncthreads();

  // inverse: the same pairs in reverse stage order
  for (int st = log_n - 1; st >= 0; --st) {
    const int log_half = log_n - 1 - st;
    const int half = 1 << log_half;
    const int base = 1 << st;
    for (int b = threadIdx.x; b < n_half; b += blockDim.x) {
      const int i = b >> log_half;
      const int j0 = (i << (log_half + 1)) | (b & (half - 1));
      const int j1 = j0 + half;
      const uint32_t a = s[j0];
      const uint32_t c = s[j1];
      s[j0] = add_mod(a, c, q);
      s[j1] = mul_shoup(sub_mod(a, c, q), w_i[base + i], wsh_i[base + i], q);
    }
    __syncthreads();
  }

  const uint32_t ninv = w_i[0];
  const uint32_t ninv_sh = wsh_i[0];
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    outr[j] = mul_shoup(s[j], ninv, ninv_sh, q);
}

}  // namespace

extern "C" {

// Launches the convolution of `rows` rows of length 2^log_n on `stream`.
// Returns the CUDA error code of the launch (0 on success); the kernel runs
// asynchronously and allocates nothing.
int helib_conv_launch(const void* x, void* out, long long rows, int log_n,
                      int P, const void* tw, const void* tw_sh,
                      const void* itw, const void* itw_sh, const void* khat,
                      const void* khat_sh, const void* aux_q, void* stream) {
  if (rows <= 0) return 0;
  const int smem = static_cast<int>(sizeof(uint32_t)) << log_n;
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_kernel<<<static_cast<unsigned>(rows), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), log_n, P,
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tw_sh),
      static_cast<const uint32_t*>(itw), static_cast<const uint32_t*>(itw_sh),
      static_cast<const uint32_t*>(khat),
      static_cast<const uint32_t*>(khat_sh),
      static_cast<const uint32_t*>(aux_q));
  return static_cast<int>(cudaGetLastError());
}

const char* helib_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
