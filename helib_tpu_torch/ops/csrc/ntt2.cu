// K4 and K5: the power-of-2 NTT and the Bluestein convolution under the v2
// (block-list) schedule with a cap k on the composites.
//
// K4 replaces the TPU kernel helib_tpu/ops/pallas_ntt2.py::pallas_ntt2
// (kernel body _ntt2_kernel, wrapper apply_ntt2) and computes what K2
// (ntt.cu) computes; K5 replaces pallas_ntt2.py::pallas_conv2 (kernel body
// _conv2_kernel, wrapper apply_conv2) and computes what K1 (conv.cu)
// computes.  The work and the bounds are K2's and K1's (hebench/counts.py
// ntt_bound_ms, conv_bound_ms).
//
// There is no device body here: both are ntt_rows.cuh's template, with
// the composites of ops/ntt2.py schedule(log_n, k) for k = 1, 2 or 3
// (HELIB_NTT_V2_K).  K4 is K2's instantiation (PrimeRows, forward and
// inverse, the same configuration of each size, n = 8 .. 65536) with K = k;
// K5 is K1's (RowMajor, the convolution, one CTA a row, n = 8 .. 32768)
// with K = k.  At k = 3 they are K2's and K1's code.

#include "ntt_rows.cuh"

namespace {

template <int K>
int conv(const void* x, void* out, long long rows, int log_n, int P,
         const void* tw, const void* tw_sh, const void* itw,
         const void* itw_sh, const void* khat, const void* khat_sh,
         const void* q, cudaStream_t s) {
  return helib::Rows<helib::RowMajor, helib::kConv, K, 1, helib::kRowThreads,
                     helib::kRowMinBlocks>::launch(x, out, rows, log_n, P, tw,
                                                   tw_sh, itw, itw_sh, khat,
                                                   khat_sh, q, s);
}

}  // namespace

extern "C" {

// K4: helib_ntt_launch's transform under schedule(log_n, k), 1 <= k <= 3.
// Returns the CUDA error code of the launch (0 on success,
// cudaErrorInvalidValue for a k or log_n out of range).
int helib_ntt2_launch(const void* x, void* out, long long rows, int log_n,
                      int P, const void* tw, const void* tw_sh, const void* q,
                      int inverse, int k, void* stream) {
  switch (k) {
    case 1:
      return helib::launch_ntt<1>(x, out, rows, log_n, P, tw, tw_sh, q,
                                  inverse, stream);
    case 2:
      return helib::launch_ntt<2>(x, out, rows, log_n, P, tw, tw_sh, q,
                                  inverse, stream);
    case 3:
      return helib::launch_ntt<3>(x, out, rows, log_n, P, tw, tw_sh, q,
                                  inverse, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5: helib_conv_launch's convolution under schedule(log_n, k),
// 1 <= k <= 3, 3 <= log_n <= 15.
int helib_ntt2_launch_conv(const void* x, void* out, long long rows,
                           int log_n, int P, const void* tw,
                           const void* tw_sh, const void* itw,
                           const void* itw_sh, const void* khat,
                           const void* khat_sh, const void* aux_q, int k,
                           void* stream) {
  if (rows <= 0) return 0;
  if (log_n < 3 || log_n > 15 || k < 1 || k > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return k == 1   ? conv<1>(x, out, rows, log_n, P, tw, tw_sh, itw, itw_sh,
                            khat, khat_sh, aux_q, s)
         : k == 2 ? conv<2>(x, out, rows, log_n, P, tw, tw_sh, itw, itw_sh,
                            khat, khat_sh, aux_q, s)
                  : conv<3>(x, out, rows, log_n, P, tw, tw_sh, itw, itw_sh,
                            khat, khat_sh, aux_q, s);
}

}  // extern "C"
