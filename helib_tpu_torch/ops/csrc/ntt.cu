// K2: the fused negacyclic power-of-2 NTT over the RNS rows of a ring
// element.
//
// Replaces the TPU kernel helib_tpu/ops/pallas_ntt.py::pallas_ntt (kernel
// body _ntt_kernel, wrapper apply_ntt).  For each row of x it computes the
// forward transform (coefficients -> evaluations in `eval_exponents` order)
// or the inverse (evaluations -> coefficients, n^-1 included) mod the row's
// prime, fully reduced, as the staged radix-2 network of
// helib_tpu/ops/ntt.py (ntt_pow2_fwd / ntt_pow2_inv) does: forward stage s
// pairs (j, j + n/2^(s+1)) inside block i = j / (n/2^s) with twiddle
// tw[2^s + i]; the inverse runs the same pairs in reverse stage order with
// the inverse twiddles.  x and out are [rows, n] uint32, the flattening of
// [..., P, n]: row r belongs to prime r mod P and reads row r mod P of the
// flat tables [P, n] (Pow2NTT.flat()) and of q [P].
//
// The device code is ntt_rows.cuh's template in its forward and inverse
// modes, instantiated with the PrimeRows map and composites of 3 levels:
// 5 shared-memory round trips and barriers a direction at n = 32768 instead
// of the staged network's 15, Harvey-lazy butterflies instead of full
// reductions, x read by the first composite and out written by the last
// with no copy loop (16-byte vectors where a thread's words are
// consecutive).  Sizes: one CTA of 512 threads a row up to n = 16384; at
// n = 32768 (the CKKS m=65536 path) one CTA of 1024 threads a row, the
// fastest of the candidates PERF.md lists; at n = 65536 (m = 131072) K3's
// cluster of 4 CTAs of 64 KB a row.  The bound (hebench/counts.py
// ntt_bound_ms) is the card's memory: 8 bytes a word against about
// 1.5 log2 n 32-bit multiplies.

#include "ntt_rows.cuh"

extern "C" {

// Launches the forward (inverse = 0) or inverse transform of `rows` rows of
// length 2^log_n (3 <= log_n <= 16) on `stream`; tw/tw_sh are the flat
// tables of that direction.  Returns the CUDA error code of the launch (0
// on success); the kernel runs asynchronously and allocates nothing.
int helib_ntt_launch(const void* x, void* out, long long rows, int log_n,
                     int P, const void* tw, const void* tw_sh, const void* q,
                     int inverse, void* stream) {
  return helib::launch_ntt<helib::kMaxK>(x, out, rows, log_n, P, tw, tw_sh,
                                         q, inverse, stream);
}

}  // extern "C"
