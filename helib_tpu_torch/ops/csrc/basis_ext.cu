// basis_ext: the RNS basis extension (fast base conversion) of a block of
// residues onto other moduli, in one launch.  For x [B, kd, N] on the
// source primes d_i (D their product) and the target moduli q_t [T]:
//
//   y_i   = x_i c_i mod d_i,                  c_i = (D/d_i)^-1 mod d_i
//   z     = sum_i y_i (1/d_i) in float64, left to right
//   alpha = floor(z) + (z - floor(z) >= 1/2)
//   out_t = (sum_i y_i M[i][t] - alpha (D mod q_t)) mod q_t,
//                                             M[i][t] = D/d_i mod q_t
//   frac  = z - alpha (float64, when asked)
//
// the balanced CRT lift of dcrt: the key switch's digit extension and the
// scaled mod-down, whose mod-p^r correction is one more target row under
// the modulus p^r.  ops/basis_ext.py builds the tables and holds the kernel
// to basis_ext_plain, the same arithmetic as torch ops, bit for bit.
//
// Replaces no TPU kernel: helib_tpu/dcrt.py leaves the lift to XLA as jnp
// ops.  The port ran it as ~14 int64 elementwise torch kernels a source
// prime, each over the whole [B, T, N] output.
//
// Bound on the H100: the integer multiply-adds.  At 65 -> 259 rows and
// N = 32003 a lift is 539 M 32x32->64 multiply-adds against 41.5 MB read
// and written once (12.4 us at 3.35 TB/s).  The batched CKKS lift, 5 -> 20
// rows on [16, 32768], is 52 M multiply-adds and 52 MB: there the bytes.
//
// Design.  A CTA of 256 threads takes 128 columns (the batch folded into
// the columns) and a tile of 8 RT target rows, RT rows a warp.  Source rows
// go through shared memory 16 at a time: y for the CTA's columns (each
// thread reduces x, read coalesced along n, by Shoup) and the 16 x 8 RT
// tile of M.  A lane holds 4 columns (lane + 32 j) x RT targets of sums in
// 64 bits: a product is below 2^60, so a residue below 2^30 and 16
// products stay below 2^64, and each sum is reduced once a chunk (by
// floor((2^64 - 1) / q), below 2 q before one conditional subtraction).
// The first 128 threads carry one column's z each across the chunks, every
// product and sum rounded on its own (__dmul_rn, __dadd_rn: no fused
// multiply-add, as the plain version's separate torch kernels).  After the
// last chunk alpha goes through shared memory, each sum takes alpha (q_t -
// D mod q_t) and one last reduction, and a warp stores 32 consecutive
// columns of a target row.  Each target tile recomputes y and z, 1/(8 RT)
// of its multiply-adds; RT (4, 2 or 1) is chosen at launch from kd and T,
// the padded target rows against that recompute.  56, 64 and 77 registers
// at RT = 1, 2, 4, no spills: a cap of 64 for a fourth CTA an SM took 10 %
// off at 65 -> 259 rows (0.02 ms, under 0.1 % of a request) but spilled 24
// bytes at RT = 4.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;             // columns a CTA
constexpr int kLaneCols = kCols / 32;  // columns a lane
constexpr int kChunk = 16;             // source rows staged at once

struct Args {
  const uint32_t* x;
  uint32_t* out;
  double* frac;
  long long cols;     // B N
  long long x_batch;  // elements from one batch entry of x to the next
  int n, kd, T, t_tiles;
  const uint32_t* d;
  const uint32_t* c;
  const uint32_t* c_sh;
  const double* inv_d;
  const uint32_t* q;
  const uint32_t* M;
  const uint32_t* D_mod;
};

// a mod q for any a < 2^64 and 2 <= q < 2^30, mu = floor((2^64 - 1) / q).
// With mu q = 2^64 - 1 - s, 0 <= s < q: a mu / 2^64 = a / q - a (1 + s) /
// (q 2^64), less than a / q by under 1, so floor(a mu / 2^64) is floor(a /
// q) or one below it and a - floor(a mu / 2^64) q lies in [0, 2 q): its low
// 32 bits are it
__device__ __forceinline__ uint32_t reduce(uint64_t a, uint32_t q,
                                           uint64_t mu) {
  const uint32_t r = static_cast<uint32_t>(a) -
                     static_cast<uint32_t>(__umul64hi(a, mu)) * q;
  return r >= q ? r - q : r;
}

constexpr size_t smem_bytes(int tt) {
  // mu [tt] (8 bytes each, first for alignment), q [tt], q - D mod q [tt],
  // y [kChunk][kCols], M [kChunk][tt], alpha [kCols]
  return 8 * tt + 4 * (2 * tt + kChunk * kCols + kChunk * tt + kCols);
}

template <int RT>
__global__ void __launch_bounds__(kThreads) lift(Args a) {
  constexpr int kTT = kWarps * RT;
  extern __shared__ uint32_t s[];
  uint64_t* t_mu = reinterpret_cast<uint64_t*>(s);
  uint32_t* t_q = s + 2 * kTT;
  uint32_t* t_neg = t_q + kTT;
  uint32_t* ys = t_neg + kTT;
  uint32_t* ms = ys + kChunk * kCols;
  uint32_t* al = ms + kChunk * kTT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = static_cast<int>(blockIdx.x % a.t_tiles);
  const long long col0 =
      static_cast<long long>(blockIdx.x / a.t_tiles) * kCols;
  const int t0 = tile * kTT;

  for (int j = tid; j < kTT; j += kThreads) {
    const int t = t0 + j;
    // a padded row: any modulus, its M and D mod q zero, never stored
    const uint32_t q = t < a.T ? a.q[t] : 2u;
    t_q[j] = q;
    t_mu[j] = ~0ull / q;
    t_neg[j] = t < a.T ? q - a.D_mod[t] : 0u;
  }

  // the column this thread stages (rows srow, srow + 2, ...)
  const int sc = tid % kCols, srow = tid / kCols;
  const long long gs = col0 + sc;
  const bool live = gs < a.cols;
  const long long xoff = live ? (gs / a.n) * a.x_batch + gs % a.n : 0;

  uint64_t acc[RT][kLaneCols];
#pragma unroll
  for (int k = 0; k < RT; ++k)
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) acc[k][j] = 0;
  double z = 0.0;  // column col0 + tid's, for tid < kCols

  for (int i0 = 0; i0 < a.kd; i0 += kChunk) {
    const int rows = a.kd - i0 < kChunk ? a.kd - i0 : kChunk;
    __syncthreads();  // the last chunk's reads are done
    for (int r = srow; r < kChunk; r += kThreads / kCols) {
      uint32_t y = 0;
      if (r < rows && live) {
        const int i = i0 + r;
        const uint32_t xv = a.x[xoff + static_cast<long long>(i) * a.n];
        const uint32_t di = a.d[i];
        const uint32_t v = xv * a.c[i] - __umulhi(xv, a.c_sh[i]) * di;
        y = v >= di ? v - di : v;
      }
      ys[r * kCols + sc] = y;
    }
    for (int e = tid; e < kChunk * kTT; e += kThreads) {
      const int r = e / kTT, t = t0 + e % kTT;
      ms[e] = r < rows && t < a.T
                  ? a.M[static_cast<long long>(i0 + r) * a.T + t]
                  : 0u;
    }
    __syncthreads();
    if (tid < kCols)
      for (int r = 0; r < rows; ++r)
        z = __dadd_rn(z, __dmul_rn(static_cast<double>(ys[r * kCols + tid]),
                                   a.inv_d[i0 + r]));
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      uint32_t yv[kLaneCols];
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        yv[j] = ys[r * kCols + lane + 32 * j];
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const uint32_t mv = ms[r * kTT + warp * RT + k];
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j)
          acc[k][j] += static_cast<uint64_t>(mv) * yv[j];
      }
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int j0 = warp * RT + k;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        acc[k][j] = reduce(acc[k][j], t_q[j0], t_mu[j0]);
    }
  }

  if (tid < kCols) {
    const double f = floor(z);
    const double alpha = __dadd_rn(f, __dsub_rn(z, f) >= 0.5 ? 1.0 : 0.0);
    al[tid] = static_cast<uint32_t>(alpha);
    if (a.frac != nullptr && tile == 0 && col0 + tid < a.cols)
      a.frac[col0 + tid] = __dsub_rn(z, alpha);
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kLaneCols; ++j) {
    const int c = lane + 32 * j;
    const long long g = col0 + c;
    if (g >= a.cols) continue;
    uint32_t* o = a.out + (g / a.n) * a.T * a.n + g % a.n;
    const uint64_t alpha = al[c];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int j0 = warp * RT + k, t = t0 + j0;
      if (t < a.T)
        o[static_cast<long long>(t) * a.n] =
            reduce(acc[k][j] + alpha * t_neg[j0], t_q[j0], t_mu[j0]);
    }
  }
}

template <int RT>
cudaError_t run(Args a, cudaStream_t stream) {
  constexpr int kTT = kWarps * RT;
  a.t_tiles = (a.T + kTT - 1) / kTT;
  const long long ctas = (a.cols + kCols - 1) / kCols * a.t_tiles;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(kTT);
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelEx(&cfg, lift<RT>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// RT of the least work a column: per target tile kd (8 RT + 12)
// multiply-add equivalents (the products, and y and z recomputed) and 10 an
// output row (the last reduction and the store), padded rows included
int targets_a_warp(int kd, int T) {
  int best = 4;
  long long best_cost = -1;
  for (int rt = 4; rt >= 1; rt /= 2) {
    const long long tiles = (T + 8 * rt - 1) / (8 * rt);
    const long long cost =
        tiles * (static_cast<long long>(kd) * (8 * rt + 12) + 10 * 8 * rt);
    if (best_cost < 0 || cost < best_cost) best = rt, best_cost = cost;
  }
  return best;
}

}  // namespace

extern "C" {

// out [batch, T, n] (int32 residues) = the lift of x [batch, kd, n] (batch
// entries x_batch elements apart, rows n apart) from the source primes
// d [kd] onto the moduli q [T] (2 <= q < 2^30), with c, c_sh [kd] (c_i and
// its Shoup companion mod d_i), inv_d [kd] (float64 1/d_i), M [kd, T] and
// D_mod [T]; frac [batch, n] float64 z - alpha, or null.  One launch on
// `stream`; returns the CUDA error code (0 on success),
// cudaErrorInvalidValue for a shape it does not take.  Allocates nothing.
int helib_basis_ext_launch(const void* x, void* out, void* frac,
                           long long batch, long long x_batch, int kd, int T,
                           int n, const void* d, const void* c,
                           const void* c_sh, const void* inv_d, const void* q,
                           const void* M, const void* D_mod, void* stream) {
  if (batch == 0) return 0;
  if (batch < 0 || kd < 1 || T < 1 || n < 1 ||
      (batch > 1 && x_batch < static_cast<long long>(kd) * n))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const uint32_t*>(x);
  a.out = static_cast<uint32_t*>(out);
  a.frac = static_cast<double*>(frac);
  a.cols = batch * n;
  a.x_batch = x_batch;
  a.n = n;
  a.kd = kd;
  a.T = T;
  a.t_tiles = 0;
  a.d = static_cast<const uint32_t*>(d);
  a.c = static_cast<const uint32_t*>(c);
  a.c_sh = static_cast<const uint32_t*>(c_sh);
  a.inv_d = static_cast<const double*>(inv_d);
  a.q = static_cast<const uint32_t*>(q);
  a.M = static_cast<const uint32_t*>(M);
  a.D_mod = static_cast<const uint32_t*>(D_mod);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (targets_a_warp(kd, T)) {
    case 4: return static_cast<int>(run<4>(a, st));
    case 2: return static_cast<int>(run<2>(a, st));
    default: return static_cast<int>(run<1>(a, st));
  }
}

}  // extern "C"
