// K1: the fused cyclic convolution mod an auxiliary prime on the row-major
// layout, the Bluestein hot loop of the B = 16384 transforms (m = 4097 ..
// 8191, the m=8009 main path).
//
// Replaces the TPU kernel helib_tpu/ops/pallas_ntt.py::pallas_conv (kernel
// body _conv_kernel, wrapper apply_conv).  x and out are [rows, n] uint32,
// the flattening of [..., 3, P, n]: row r belongs to aux prime
// t = (r / P) mod 3 and reads spectral row r mod 3P of khat [3, P, n], so
// khat is never broadcast over the batch in memory.
//
// The device code is ntt_rows.cuh's template in its convolution mode,
// instantiated with the row-major map, composites of at most 3 levels and
// one CTA a row (n <= 32768, the row in at most 128 KB of dynamic shared
// memory).  Against a staged radix-2 network (a barrier after each of the
// 2 log2 n stages): register composites of 3 levels under ops/ntt2.py
// schedule(log_n, 3), 5 barriers a direction at n = 16384 instead of 14,
// the khat product fused between the last forward and the first inverse
// composite -- K5's design (K5 is the same instantiation at k <= 3,
// ntt2.cu).  Occupancy: 512 threads, at least 2 CTAs an SM (64 registers),
// the default carveout (kRowThreads, kRowMinBlocks; PERF.md has the
// candidates tried).  The bound is unchanged (hebench/counts.py
// conv_bound_ms): at n = 16384 the 3 (n log2 n + 2n) 32-bit multiplies a
// row, not its 16n bytes.

#include "ntt_rows.cuh"

namespace {

using OneCta = helib::Rows<helib::RowMajor, helib::kConv, helib::kMaxK, 1,
                           helib::kRowThreads, helib::kRowMinBlocks>;

}  // namespace

extern "C" {

// Launches the convolution of `rows` rows of length 2^log_n (3 <= log_n <=
// 15) on `stream`.  Returns the CUDA error code of the launch (0 on
// success); the kernel runs asynchronously and allocates nothing.
int helib_conv_launch(const void* x, void* out, long long rows, int log_n,
                      int P, const void* tw, const void* tw_sh,
                      const void* itw, const void* itw_sh, const void* khat,
                      const void* khat_sh, const void* aux_q, void* stream) {
  if (rows <= 0) return 0;
  if (log_n < 3 || log_n > 15) return static_cast<int>(cudaErrorInvalidValue);
  return OneCta::launch(x, out, rows, log_n, P, tw, tw_sh, itw, itw_sh, khat,
                        khat_sh, aux_q, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
