"""Canonical-embedding norms (helib_tpu.norms; role of HElib's norms.cpp).

`embeddingLargestCoeff` (reference norms.h:85) = L-infinity norm of the
canonical embedding: max_j |f(zeta_m^j)| over primitive m-th roots of unity.
Host-side complex FFT; used by noise measurement (SecKey.noise_of,
debugging.check_noise, the fhe_stats ratios), the "Bounded" rejection
samplers (reference sample.cpp `sampleSmallBounded` etc., which resample
until the canonical norm is below a high-probability bound) and the
measured mod-switch noise.
"""

from __future__ import annotations

import math

import numpy as np


def _largest(arr: np.ndarray, m: int, pow2: bool) -> float:
    """max_j |f(zeta^j)| of a float64 coefficient vector.

    For pow2 contexts `arr` has length N=m/2 and the ring is X^N+1
    (primitive 2N-th roots); otherwise the coefficients are mod X^m-1 and
    the max is over the primitive m-th root spectrum."""
    if pow2:
        N = len(arr)
        zeta = np.exp(1j * np.pi / N)
        b = arr.astype(np.complex128) * zeta ** np.arange(N)
        return float(np.max(np.abs(np.fft.ifft(b) * N)))
    full = np.zeros(m, dtype=np.float64)
    full[: len(arr)] = arr
    spec = np.fft.fft(full)
    prim = np.array([j for j in range(1, m) if math.gcd(j, m) == 1])
    return float(np.max(np.abs(spec[prim])))


def _log2(mx: float) -> float:
    return math.log2(mx) if mx > 0 else float("-inf")


def embedding_largest_coeff(coeffs, m: int, pow2: bool) -> float:
    """max_j |f(zeta^j)| over primitive m-th roots, linear domain, of
    integer (possibly bignum) coefficients (reference norms.cpp
    embeddingLargestCoeff)."""
    return _largest(np.asarray([float(int(v)) for v in coeffs],
                               dtype=np.float64), m, pow2)


def embedding_largest_coeff_log2(coeffs, m: int, pow2: bool) -> float:
    return _log2(embedding_largest_coeff(coeffs, m, pow2))


def embedding_largest_float_log2(arr, m: int, pow2: bool) -> float:
    """The same spectrum max for FLOAT coefficient vectors (the exact
    mod-switch measurement, whose delta/D coefficients are O(1) reals)."""
    return _log2(_largest(np.asarray(arr, dtype=np.float64), m, pow2))


def embedding_norm_log2_scaled(mant: np.ndarray, exp2: np.ndarray,
                               m: int, pow2: bool) -> float:
    """log2 canonical norm from frexp-form coefficients (value_i =
    mant_i * 2^exp2_i) -- the native CRT kernel's output format, which
    avoids float overflow for > 1000-bit values.  Coefficients more than
    ~2^-200 below the largest are negligible for the L-infinity spectrum
    max."""
    nz = mant != 0.0
    if not np.any(nz):
        return float("-inf")
    shift = int(np.max(exp2[nz]))
    scaled = np.where(nz, mant * np.exp2(np.clip(exp2 - shift, -1000, 0)),
                      0.0)
    mx = _largest(scaled, m, pow2)
    return (math.log2(mx) + shift) if mx > 0 else float("-inf")
