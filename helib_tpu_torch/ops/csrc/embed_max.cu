// embed_max: the largest value of a real coefficient vector's canonical
// embedding, max over j in Z_m^* of |sum_k x_k zeta_m^(jk)|, one value a
// row, in float64 from float32 coefficients: norms.py `_largest` on the
// card.  The measured noise of a BGV modulus switch (Ctxt.mod_down_to)
// calls it on the scale-down remainder of each ciphertext part.
//
// Replaces no TPU kernel: helib_tpu measures that noise on the host (a
// numpy FFT of length m after copying each remainder), and the port did the
// same until this kernel, with the card idle.  Here the host reads back one
// float64 a part.
//
// Design.  One chirp-z (Bluestein) transform for every m: with
// c_k = exp(-i pi k^2 / m), F(j) = conj(c_j) sum_k (x_k c_k) conj(c_(j-k)),
// so |F(j)| = |(a * b)_j| for a_k = x_k c_k (k < n) and b_t = conj(c_t)
// (-n < t < m), a cyclic convolution of length L = 2^log_l >= n + m - 1
// (L = 16384 at m = 8009).  At a power-of-2 m the row has n = m/2
// coefficients and the same formula runs over the odd j, the negacyclic
// spectrum.  The convolution is FFT_L, a product with the transform of b
// (a table, 1/L folded in), FFT_L^-1, as a four-step transform over
// L = L1 x L2 in three launches whose data stays in L2 (the cache):
//
//   1. cols_fwd: a_k for k = k1 L2 + k2, the length-L1 FFT of each column
//      k2, the twiddle w_L^(k2 j1); writes work[j1][k2].
//   2. rows_conv: the length-L2 FFT of each row j1 (X[j1 + L1 j2]), the
//      product with bhat[j1][j2], the inverse FFT over j2 and the twiddle
//      w_L^(-j1 t2); writes work[j1][t2] in place.
//   3. cols_inv_max: the inverse length-L1 FFT of each column t2, giving
//      p[t2 + L2 t1]; |p_t| over t < m with gcd(t, m) = 1 is maxed in
//      registers, then across the CTA, then across CTAs by an atomic max on
//      the bits of the non-negative float64 (order-free, so deterministic).
//      The spectrum is never written to device memory.
//
// Each CTA holds G sequences of one sub-FFT of N points in shared memory,
// interleaved (element i of sequence g at i G + g), with G N = 512 (or
// G = 1 for N > 512), so each of the 256 threads moves two elements and
// does one butterfly a stage: many small CTAs (64 a launch at m = 8009, two
// rows) rather than a few long ones.  A sequence is loaded in bit-reversed
// order and transformed in place by radix-2 butterflies, one barrier a
// stage, their twiddles w_N^j (j < N/2) staged in shared memory beside the
// tile from the one table w_L^k (w_N is a power of w_L).  The tables (chirp
// [n], bhat [L1][L2], twiddles [L], the mask of Z_m^* [m]) are built once an
// m on the host in float64 (ops/embed_max.py).
//
// Bound on the H100: latency.  At m = 8009 with two rows the work is ~5
// MFLOP in float64 (two FFTs of 16384 points a row) and ~0.7 MB of inputs
// and tables, read once: 0.15 us at 34 TFLOP/s and 0.21 us at 3.35 TB/s,
// against a few us a launch.  Three launches keep the row's 256 KB out of
// any one CTA's shared memory; their intermediate 0.5 MB stays in the 50 MB
// L2.  Within a launch the time is the chain of dependent accesses: one
// global read, one table read, a barrier and a shared-memory round trip a
// stage, one global write; no stage reads device memory.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLogTile = 9;              // G N = 512 complex doubles a CTA
constexpr int kMaxLogN = 11;             // a sub-FFT of at most 2048 points
constexpr int kMaxLogL = 2 * kMaxLogN;   // L1, L2 <= 2^kMaxLogN

struct alignas(16) Cplx {
  double re, im;
};

__device__ __forceinline__ Cplx cmul(Cplx a, Cplx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// a * conj(b)
__device__ __forceinline__ Cplx cmul_conj(Cplx a, Cplx b) {
  return {a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im};
}

__device__ __forceinline__ Cplx* tile_smem() {
  extern __shared__ uint32_t s[];
  return reinterpret_cast<Cplx*>(s);
}

__device__ __forceinline__ int bit_reverse(int v, int bits) {
#ifdef __CUDA_ARCH__
  return bits ? static_cast<int>(__brev(static_cast<unsigned>(v)) >>
                                 (32 - bits))
              : 0;
#else
  int r = 0;
  for (int i = 0; i < bits; ++i, v >>= 1) r = (r << 1) | (v & 1);
  return r;
#endif
}

// log2 of the sequences a CTA holds of a sub-FFT of 2^log_n points, out of
// 2^log_seqs
inline int log_group(int log_n, int log_seqs) {
  const int fill = log_n < kLogTile ? kLogTile - log_n : 0;
  return fill < log_seqs ? fill : log_seqs;
}

// Shared memory of a CTA: the tile of 2^(log_n + log_g) elements and the
// 2^log_n / 2 twiddles of its sub-FFT, at least the kThreads doubles of
// the last launch's reduction.
inline size_t smem_bytes(int log_n, int log_g) {
  const size_t tile =
      sizeof(Cplx) * ((1 << (log_n + log_g)) + ((1 << log_n) >> 1));
  return tile > sizeof(double) * kThreads ? tile : sizeof(double) * kThreads;
}

// w_N^j for j < N/2 (N = 2^log_n) into tws, from tw = w_L^k, k < 2^log_l.
__device__ __forceinline__ void stage_twiddles(Cplx* tws, const Cplx* tw,
                                               int log_n, int log_l) {
  for (int j = threadIdx.x; j < ((1 << log_n) >> 1); j += kThreads)
    tws[j] = tw[j << (log_l - log_n)];
}

// In-place radix-2 FFT of length 2^log_n on the tile's 2^log_g interleaved
// sequences, each loaded in bit-reversed order; natural order out.  Forward
// is sum_k x_k w^(jk) with w = exp(-2 pi i / N); kInverse conjugates the
// twiddles (no 1/N).  tws: w_N^j, j < N/2.
template <bool kInverse>
__device__ void fft_tile(Cplx* s, const Cplx* tws, int log_n, int log_g) {
  const int half = (1 << (log_n + log_g)) >> 1;   // butterflies a stage
  for (int log_h = 0; log_h < log_n; ++log_h) {
    const int h = 1 << log_h;
    for (int e = threadIdx.x; e < half; e += kThreads) {
      const int g = e & ((1 << log_g) - 1);
      const int b = e >> log_g;
      const int j = b & (h - 1);
      const int i0 = ((b - j) << 1) + j;
      const Cplx w = tws[j << (log_n - log_h - 1)];   // w_(2h)^j
      Cplx* p0 = s + ((i0 << log_g) + g);
      Cplx* p1 = p0 + (h << log_g);
      const Cplx u = *p0;
      const Cplx v = kInverse ? cmul_conj(*p1, w) : cmul(*p1, w);
      *p0 = {u.re + v.re, u.im + v.im};
      *p1 = {u.re - v.re, u.im - v.im};
    }
    __syncthreads();
  }
}

struct Shape {
  int n, m, log_l, log_l1, log_l2, log_g1, log_g2;
};

// Launch 1: the columns' forward FFTs.  CTA (r, c) holds columns
// k2 in [c G1, (c + 1) G1) of row r.
__global__ void __launch_bounds__(kThreads)
    cols_fwd(const float* __restrict__ x, double* __restrict__ out,
             Cplx* __restrict__ work, const Cplx* __restrict__ chirp,
             const Cplx* __restrict__ tw, Shape sh) {
  Cplx* s = tile_smem();
  Cplx* tws = s + (1 << (sh.log_l1 + sh.log_g1));
  const int chunks = 1 << (sh.log_l2 - sh.log_g1);
  const long long r = blockIdx.x / chunks;
  const int k2_0 = (blockIdx.x % chunks) << sh.log_g1;
  const int gm = (1 << sh.log_g1) - 1;
  const int count = 1 << (sh.log_l1 + sh.log_g1);
  if (k2_0 == 0 && threadIdx.x == 0) out[r] = 0.0;
  const float* xr = x + r * sh.n;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int g = e & gm, k1 = e >> sh.log_g1;
    const int k = (k1 << sh.log_l2) + k2_0 + g;
    Cplx v = {0.0, 0.0};
    if (k < sh.n) {
      const double xv = static_cast<double>(xr[k]);
      const Cplx c = chirp[k];
      v = {xv * c.re, xv * c.im};
    }
    s[(bit_reverse(k1, sh.log_l1) << sh.log_g1) + g] = v;
  }
  stage_twiddles(tws, tw, sh.log_l1, sh.log_l);
  __syncthreads();
  fft_tile<false>(s, tws, sh.log_l1, sh.log_g1);
  Cplx* wr = work + (r << sh.log_l);
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int g = e & gm, j1 = e >> sh.log_g1;
    const int k2 = k2_0 + g;
    wr[(j1 << sh.log_l2) + k2] = cmul(s[e], tw[k2 * j1]);
  }
}

// Launch 2: each row's forward FFT, the product with bhat, the inverse FFT.
// CTA (r, c) holds rows j1 in [c G2, (c + 1) G2) of row r's work.
__global__ void __launch_bounds__(kThreads)
    rows_conv(Cplx* __restrict__ work, const Cplx* __restrict__ bhat,
              const Cplx* __restrict__ tw, Shape sh) {
  Cplx* s = tile_smem();
  Cplx* tws = s + (1 << (sh.log_l2 + sh.log_g2));
  const int chunks = 1 << (sh.log_l1 - sh.log_g2);
  const long long r = blockIdx.x / chunks;
  const int j1_0 = (blockIdx.x % chunks) << sh.log_g2;
  const int lm = (1 << sh.log_l2) - 1;
  const int count = 1 << (sh.log_l2 + sh.log_g2);
  Cplx* wr = work + (r << sh.log_l) + (static_cast<long long>(j1_0)
                                       << sh.log_l2);
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int k2 = e & lm, g = e >> sh.log_l2;
    s[(bit_reverse(k2, sh.log_l2) << sh.log_g2) + g] = wr[e];
  }
  stage_twiddles(tws, tw, sh.log_l2, sh.log_l);
  __syncthreads();
  fft_tile<false>(s, tws, sh.log_l2, sh.log_g2);
  // X[j1 + L1 j2] sits at j2 G2 + g; multiply by bhat and move it to the
  // bit-reversed place the inverse FFT reads, a pair of places a thread
  const Cplx* br = bhat + (static_cast<long long>(j1_0) << sh.log_l2);
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int g = e >> sh.log_l2, p = e & lm;
    const int q = bit_reverse(p, sh.log_l2);
    if (p > q) continue;
    const int ip = (p << sh.log_g2) + g, iq = (q << sh.log_g2) + g;
    const Cplx a = cmul(s[ip], br[(g << sh.log_l2) + p]);
    const Cplx b = cmul(s[iq], br[(g << sh.log_l2) + q]);
    s[ip] = b;
    s[iq] = a;
  }
  __syncthreads();
  fft_tile<true>(s, tws, sh.log_l2, sh.log_g2);
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int t2 = e & lm, g = e >> sh.log_l2;
    wr[e] = cmul_conj(s[(t2 << sh.log_g2) + g], tw[(j1_0 + g) * t2]);
  }
}

// Launch 3: the columns' inverse FFTs and the max of |p_t| over Z_m^*.
__global__ void __launch_bounds__(kThreads)
    cols_inv_max(const Cplx* __restrict__ work,
                 const uint8_t* __restrict__ mask,
                 const Cplx* __restrict__ tw, double* __restrict__ out,
                 Shape sh) {
  Cplx* s = tile_smem();
  Cplx* tws = s + (1 << (sh.log_l1 + sh.log_g1));
  const int chunks = 1 << (sh.log_l2 - sh.log_g1);
  const long long r = blockIdx.x / chunks;
  const int t2_0 = (blockIdx.x % chunks) << sh.log_g1;
  const int gm = (1 << sh.log_g1) - 1;
  const int count = 1 << (sh.log_l1 + sh.log_g1);
  const Cplx* wr = work + (r << sh.log_l);
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int g = e & gm, j1 = e >> sh.log_g1;
    s[(bit_reverse(j1, sh.log_l1) << sh.log_g1) + g] =
        wr[(j1 << sh.log_l2) + t2_0 + g];
  }
  stage_twiddles(tws, tw, sh.log_l1, sh.log_l);
  __syncthreads();
  fft_tile<true>(s, tws, sh.log_l1, sh.log_g1);
  double best = 0.0;   // of |p_t|^2
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int t = t2_0 + (e & gm) + ((e >> sh.log_g1) << sh.log_l2);
    if (t < sh.m && mask[t]) {
      const Cplx v = s[e];
      best = fmax(best, v.re * v.re + v.im * v.im);
    }
  }
  __syncthreads();   // the tile becomes the reduction's scratch
  double* red = reinterpret_cast<double*>(s);
  red[threadIdx.x] = best;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k)
      red[threadIdx.x] = fmax(red[threadIdx.x], red[threadIdx.x + k]);
    __syncthreads();
  }
  if (threadIdx.x == 0)
    atomicMax(reinterpret_cast<unsigned long long*>(out + r),
              static_cast<unsigned long long>(__double_as_longlong(
                  sqrt(red[0]))));
}

template <class... K, class... A>
cudaError_t run(void (*kern)(K...), long long ctas, size_t smem,
                cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// out[r] = max over j in Z_m^* of |sum_(k<n) x[r][k] zeta_m^(jk)| for the
// `rows` rows of x [rows, n] (float32); out [rows] float64; work
// [rows, 2^log_l] complex doubles of scratch; chirp [n], bhat [L1][L2],
// tw [2^log_l] complex doubles and mask [m] bytes from ops/embed_max.py
// (L1 = 2^(log_l / 2), L2 = 2^log_l / L1).  Three launches on `stream`;
// returns the CUDA error code (0 on success), cudaErrorInvalidValue for a
// shape the kernels do not take.  Allocates nothing.
int helib_embed_max_launch(const void* x, void* out, void* work,
                           long long rows, int n, int m, int log_l,
                           const void* chirp, const void* bhat,
                           const void* tw, const void* mask, void* stream) {
  if (rows <= 0) return 0;
  if (n < 1 || m < n || log_l < 1 || log_l > kMaxLogL ||
      (1LL << log_l) < static_cast<long long>(n) + m - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.n = n;
  sh.m = m;
  sh.log_l = log_l;
  sh.log_l1 = log_l / 2;
  sh.log_l2 = log_l - sh.log_l1;
  sh.log_g1 = log_group(sh.log_l1, sh.log_l2);
  sh.log_g2 = log_group(sh.log_l2, sh.log_l1);
  const size_t smem1 = smem_bytes(sh.log_l1, sh.log_g1);
  const size_t smem2 = smem_bytes(sh.log_l2, sh.log_g2);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* cx = static_cast<const float*>(x);
  auto* cout = static_cast<double*>(out);
  auto* cw = static_cast<Cplx*>(work);
  const auto* ctw = static_cast<const Cplx*>(tw);
  cudaError_t err =
      run(cols_fwd, rows << (sh.log_l2 - sh.log_g1), smem1, st, cx, cout, cw,
          static_cast<const Cplx*>(chirp), ctw, sh);
  if (err == cudaSuccess)
    err = run(rows_conv, rows << (sh.log_l1 - sh.log_g2), smem2, st, cw,
              static_cast<const Cplx*>(bhat), ctw, sh);
  if (err == cudaSuccess)
    err = run(cols_inv_max, rows << (sh.log_l2 - sh.log_g1), smem1, st,
              static_cast<const Cplx*>(cw),
              static_cast<const uint8_t*>(mask), ctw, cout, sh);
  return static_cast<int>(err);
}

}  // extern "C"
