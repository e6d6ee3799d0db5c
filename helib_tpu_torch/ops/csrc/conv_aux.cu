// K3: the fused cyclic convolution mod an auxiliary prime on the aux-major
// layout, the Bluestein hot loop of every transform size but B = 16384
// (B = 65536 at m = 32003 and 31775, 4096 at m = 1271).
//
// Replaces the TPU kernel helib_tpu/ops/pallas_ntt.py::pallas_conv_shared
// (kernel body _conv_kernel_shared, wrapper apply_conv_aux).  x and out are
// [rows, n] uint32, the flattening of the aux-major [3, ..., P, n]: row r
// belongs to aux prime t = r / (rows / 3) and reads spectral row
// t P + r mod P of khat [3, P, n].
//
// The device code is ntt_rows.cuh's template in its convolution mode,
// instantiated with the aux-major map and composites of at most 3 levels: one CTA a row up to n = 32768 (as K1), and at n = 65536 a
// cluster of 4 CTAs a row, each holding a 64 KB quarter in dynamic shared
// memory.  Against a staged radix-2 network on a 2-CTA cluster (15 barriers
// a direction in each CTA, and every CTA reading all of x for the stage
// across the halves):
//   * register composites of 3 levels, 5 local composites a direction
//     (schedule(14, 3) on each quarter);
//   * stages 0 and 1, the only ones across the CTAs, as one cross
//     composite that reads each word of x once: each CTA takes a quarter of
//     its groups and writes word t of each into CTA t's shared memory; the
//     inverse reads each group once through distributed shared memory and
//     writes out times n^-1;
//   * occupancy: 256 threads and 3 CTAs an SM (80 registers, 92 clusters
//     resident) instead of one 512-thread CTA an SM.
// PERF.md has the candidates tried.  The bound is unchanged
// (hebench/counts.py conv_bound_ms): at n = 65536 the 16n bytes a row moves,
// not its multiplies.

#include "ntt_rows.cuh"

namespace {

template <int kCluster, int kThreads, int kMinBlocks>
using Conv = helib::Rows<helib::AuxMajor, helib::kConv, helib::kMaxK,
                         kCluster, kThreads, kMinBlocks>;
using OneCta = Conv<1, helib::kRowThreads, helib::kRowMinBlocks>;
using Cluster = Conv<helib::kClusterSize, helib::kClusterThreads,
                     helib::kClusterMinBlocks>;

}  // namespace

extern "C" {

// Launches the convolution of `rows` rows (a multiple of 3, aux-major) of
// length 2^log_n (3 <= log_n <= 16) on `stream`; log_n = 16 runs one
// cluster a row.  Returns the CUDA error code of the launch (0 on success);
// the kernel runs asynchronously and allocates nothing.
int helib_conv_aux_launch(const void* x, void* out, long long rows,
                          int log_n, int P, const void* tw, const void* tw_sh,
                          const void* itw, const void* itw_sh,
                          const void* khat, const void* khat_sh,
                          const void* aux_q, void* stream) {
  if (rows <= 0) return 0;
  if (rows % 3 != 0 || log_n < 3 || log_n > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return log_n == 16 ? Cluster::launch(x, out, rows, log_n, P, tw, tw_sh, itw,
                                       itw_sh, khat, khat_sh, aux_q, s)
                     : OneCta::launch(x, out, rows, log_n, P, tw, tw_sh, itw,
                                      itw_sh, khat, khat_sh, aux_q, s);
}

}  // extern "C"
