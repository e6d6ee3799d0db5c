// K4 and K5: the power-of-2 NTT and the Bluestein convolution under the v2
// (block-list) schedule.
//
// K4 replaces the TPU kernel helib_tpu/ops/pallas_ntt2.py::pallas_ntt2
// (kernel body _ntt2_kernel, wrapper apply_ntt2) and computes what K2
// (ntt.cu) computes: for each row of x the negacyclic forward transform in
// `eval_exponents` order, or the inverse with n^-1, mod the row's prime,
// fully reduced.  K5 replaces pallas_ntt2.py::pallas_conv2 (kernel body
// _conv2_kernel, wrapper apply_conv2) and computes what K1 (conv.cu)
// computes: iNTT(NTT(x) * khat) * n^-1 mod the row's auxiliary prime.  The
// work is the same as K2's and K1's, so are the bounds (chip_smoke.py
// ntt_bound_ms, conv_bound_ms): K2's bytes at n = 32768 and K1's 32-bit
// multiplies at n = 16384.
//
// Layout as K2 and K1: x and out are [rows, n] uint32.  K4: row r uses
// prime r mod P and rows r mod P of the flat tables [P, n]
// (Pow2NTT.flat(): stage s at [2^s, 2^(s+1)), n^-1 at entry 0 of the
// inverse table).  K5: row r uses aux prime (r / P) mod 3, the flat aux
// tables [3, n] and spectral row r mod 3P of khat [3, P, n].
//
// Design.  K2 and K1 run one radix-2 stage at a time over the row in shared
// memory: every stage is a full shared-memory round trip of the row and a
// __syncthreads() (15 a direction at n = 32768).  Here the host passes the
// schedule of composites (s0, k), k <= K (ops/ntt2.py schedule()), and each
// composite is one round trip and one barrier: a thread loads a group of
// 2^k words into registers, runs the k butterfly levels there with the
// twiddles read through the read-only cache, and writes it back
// (composite.cuh).  At n = 32768 and K = 3 that is 5 barriers a direction.
// The first forward composite reads x straight from device memory and the
// last inverse composite writes out straight to it (both with L >= 32 when
// n >= 2^(k+5), so a warp touches 32 consecutive words).  K5 runs its last
// forward composite, the product by khat and its first inverse composite
// (the same stages, so the same thread holds the same words) on one group
// in registers, with no barrier in between (pallas_ntt2.py:186-202).  The
// kernels are templated on K, the largest composite of the schedule; each
// k <= K has its own unrolled code.  One CTA a row with 512 threads and the
// row in dynamic shared memory (n = 32768 words is 128 KB, above the 48 KB
// default, hence the opt-in attribute).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "composite.cuh"

namespace {

using helib::csub;
using helib::dispatch_k;
using helib::for_each_group;
using helib::kMaxComposites;
using helib::levels;
using helib::mul_lazy;
using helib::Schedule;
using helib::swz;

constexpr int kThreads = 512;
constexpr int kMaxK = 3;  // ops/ntt2.py K_MAX

template <int K, bool kInverse>
__global__ void __launch_bounds__(kThreads)
ntt2_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
            int log_n, int P, const uint32_t* __restrict__ tw,
            const uint32_t* __restrict__ tw_sh,
            const uint32_t* __restrict__ qs, Schedule sch) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const size_t row = blockIdx.x;
  const int prow = static_cast<int>(row % static_cast<size_t>(P));
  const uint32_t q = qs[prow];
  const uint32_t q2 = 2 * q;
  const uint32_t* __restrict__ w = tw + static_cast<size_t>(prow) * n;
  const uint32_t* __restrict__ wsh = tw_sh + static_cast<size_t>(prow) * n;
  const uint32_t* __restrict__ xr = x + row * n;
  uint32_t* __restrict__ outr = out + row * n;

  auto sload = [&](int a) { return s[swz(a)]; };
  auto sstore = [&](int a, uint32_t v) { s[swz(a)] = v; };

  if constexpr (!kInverse) {
    for (int c = 0; c < sch.count; ++c) {
      const int s0 = sch.s0[c];
      dispatch_k<K>(sch.k[c], [&](auto kc) {
        constexpr int k = decltype(kc)::value;
        auto body = [&](uint32_t(&r)[1 << k], int b, int, int) {
          levels<k, false>(r, s0, b, w, wsh, q);
        };
        if (c == 0) {
          for_each_group<k>(log_n, s0, [&](int a) { return xr[a]; }, body,
                            sstore);
        } else {
          for_each_group<k>(log_n, s0, sload, body, sstore);
        }
      });
      __syncthreads();
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      outr[j] = csub(csub(s[swz(j)], q2), q);
  } else {
    const uint32_t ninv = w[0];
    const uint32_t ninv_sh = wsh[0];
    for (int j = threadIdx.x; j < n; j += blockDim.x) s[swz(j)] = xr[j];
    __syncthreads();
    for (int c = sch.count - 1; c >= 0; --c) {
      const int s0 = sch.s0[c];
      dispatch_k<K>(sch.k[c], [&](auto kc) {
        constexpr int k = decltype(kc)::value;
        auto body = [&](uint32_t(&r)[1 << k], int b, int, int) {
          levels<k, true>(r, s0, b, w, wsh, q);
        };
        if (c == 0) {
          for_each_group<k>(log_n, s0, sload, body, [&](int a, uint32_t v) {
            outr[a] = csub(mul_lazy(v, ninv, ninv_sh, q), q);
          });
        } else {
          for_each_group<k>(log_n, s0, sload, body, sstore);
        }
      });
      if (c > 0) __syncthreads();
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
conv2_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             int log_n, int P, const uint32_t* __restrict__ tw,
             const uint32_t* __restrict__ tw_sh,
             const uint32_t* __restrict__ itw,
             const uint32_t* __restrict__ itw_sh,
             const uint32_t* __restrict__ khat,
             const uint32_t* __restrict__ khat_sh,
             const uint32_t* __restrict__ aux_q, Schedule sch) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
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
  const uint32_t ninv = w_i[0];
  const uint32_t ninv_sh = wsh_i[0];
  const int last = sch.count - 1;

  auto gload = [&](int a) { return xr[a]; };
  auto sload = [&](int a) { return s[swz(a)]; };
  auto sstore = [&](int a, uint32_t v) { s[swz(a)] = v; };
  auto gstore = [&](int a, uint32_t v) {
    outr[a] = csub(mul_lazy(v, ninv, ninv_sh, q), q);
  };

  // forward composites 0 .. last-1
  for (int c = 0; c < last; ++c) {
    const int s0 = sch.s0[c];
    dispatch_k<K>(sch.k[c], [&](auto kc) {
      constexpr int k = decltype(kc)::value;
      auto body = [&](uint32_t(&r)[1 << k], int b, int, int) {
        levels<k, false>(r, s0, b, w_f, wsh_f, q);
      };
      if (c == 0) {
        for_each_group<k>(log_n, s0, gload, body, sstore);
      } else {
        for_each_group<k>(log_n, s0, sload, body, sstore);
      }
    });
    __syncthreads();
  }

  // the last forward composite, the product by khat and the first inverse
  // composite on one group in registers
  {
    const int s0 = sch.s0[last];
    dispatch_k<K>(sch.k[last], [&](auto kc) {
      constexpr int k = decltype(kc)::value;
      auto body = [&](uint32_t(&r)[1 << k], int b, int base, int log_l) {
        levels<k, false>(r, s0, b, w_f, wsh_f, q);
#pragma unroll
        for (int i = 0; i < (1 << k); ++i) {
          const int a = base + (i << log_l);
          r[i] = mul_lazy(r[i], __ldg(kh + a), __ldg(khsh + a), q);
        }
        levels<k, true>(r, s0, b, w_i, wsh_i, q);
      };
      if (last == 0) {
        for_each_group<k>(log_n, s0, gload, body, gstore);
      } else {
        for_each_group<k>(log_n, s0, sload, body, sstore);
      }
    });
  }

  // inverse composites last-1 .. 0
  for (int c = last - 1; c >= 0; --c) {
    __syncthreads();
    const int s0 = sch.s0[c];
    dispatch_k<K>(sch.k[c], [&](auto kc) {
      constexpr int k = decltype(kc)::value;
      auto body = [&](uint32_t(&r)[1 << k], int b, int, int) {
        levels<k, true>(r, s0, b, w_i, wsh_i, q);
      };
      if (c == 0) {
        for_each_group<k>(log_n, s0, sload, body, gstore);
      } else {
        for_each_group<k>(log_n, s0, sload, body, sstore);
      }
    });
  }
}

template <int K>
int launch_k(int conv, const void* x, void* out, long long rows, int log_n,
             int P, const void* tw, const void* tw_sh, const void* itw,
             const void* itw_sh, const void* khat, const void* khat_sh,
             const void* q, int inverse, const Schedule& sch,
             cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(uint32_t)) << log_n;
  const auto* xp = static_cast<const uint32_t*>(x);
  auto* op = static_cast<uint32_t*>(out);
  const auto* a = static_cast<const uint32_t*>(tw);
  const auto* ash = static_cast<const uint32_t*>(tw_sh);
  const auto* qp = static_cast<const uint32_t*>(q);
  const unsigned grid = static_cast<unsigned>(rows);
  cudaError_t err;
  if (conv) {
    err = cudaFuncSetAttribute(
        conv2_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv2_kernel<K><<<grid, kThreads, smem, stream>>>(
        xp, op, log_n, P, a, ash, static_cast<const uint32_t*>(itw),
        static_cast<const uint32_t*>(itw_sh),
        static_cast<const uint32_t*>(khat),
        static_cast<const uint32_t*>(khat_sh), qp, sch);
  } else if (inverse) {
    err = cudaFuncSetAttribute(ntt2_kernel<K, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ntt2_kernel<K, true><<<grid, kThreads, smem, stream>>>(
        xp, op, log_n, P, a, ash, qp, sch);
  } else {
    err = cudaFuncSetAttribute(ntt2_kernel<K, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ntt2_kernel<K, false><<<grid, kThreads, smem, stream>>>(
        xp, op, log_n, P, a, ash, qp, sch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// conv = 0: K4 on `rows` rows of length 2^log_n, tw/tw_sh the flat tables
// of the direction `inverse` (itw..khat_sh unused).  conv = 1: K5, tw..itw_sh
// the forward and inverse flat aux tables, khat/khat_sh the spectral
// kernels, q the aux primes.  sched holds `count` pairs (s0, k) covering
// stages [0, log_n) in order, each k in 1..3.  Returns the CUDA error code
// of the launch (0 on success, cudaErrorInvalidValue for a bad schedule);
// the kernel runs asynchronously and allocates nothing.
int helib_ntt2_launch(int conv, const void* x, void* out, long long rows,
                      int log_n, int P, const void* tw, const void* tw_sh,
                      const void* itw, const void* itw_sh, const void* khat,
                      const void* khat_sh, const void* q, int inverse,
                      const int* sched, int count, void* stream) {
  if (rows <= 0) return 0;
  if (count < 1 || count > kMaxComposites)
    return static_cast<int>(cudaErrorInvalidValue);
  Schedule sch{};
  sch.count = count;
  int K = 0, next = 0;
  for (int c = 0; c < count; ++c) {
    sch.s0[c] = sched[2 * c];
    sch.k[c] = sched[2 * c + 1];
    if (sch.s0[c] != next || sch.k[c] < 1 || sch.k[c] > kMaxK)
      return static_cast<int>(cudaErrorInvalidValue);
    next += sch.k[c];
    K = sch.k[c] > K ? sch.k[c] : K;
  }
  if (next != log_n) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1:
      return launch_k<1>(conv, x, out, rows, log_n, P, tw, tw_sh, itw,
                         itw_sh, khat, khat_sh, q, inverse, sch, st);
    case 2:
      return launch_k<2>(conv, x, out, rows, log_n, P, tw, tw_sh, itw,
                         itw_sh, khat, khat_sh, q, inverse, sch, st);
    default:
      return launch_k<3>(conv, x, out, rows, log_n, P, tw, tw_sh, itw,
                         itw_sh, khat, khat_sh, q, inverse, sch, st);
  }
}

}  // extern "C"
