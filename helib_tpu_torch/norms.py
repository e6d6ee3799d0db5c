"""Canonical-embedding norms (helib_tpu.norms; role of HElib's norms.cpp).

`embeddingLargestCoeff` (reference norms.h:85) = L-infinity norm of the
canonical embedding: max_j |f(zeta_m^j)| over primitive m-th roots of unity.
Host-side complex FFT; used by the "Bounded" rejection samplers (reference
sample.cpp `sampleSmallBounded` etc., which resample until the canonical
norm is below a high-probability bound) and the measured mod-switch noise.
"""

from __future__ import annotations

import math

import numpy as np


def embedding_largest_float_log2(arr, m: int, pow2: bool) -> float:
    """log2 max_j |f(zeta^j)| of a float coefficient vector.

    For pow2 contexts `arr` has length N=m/2 and the ring is X^N+1
    (primitive 2N-th roots); otherwise the coefficients are mod X^m-1 and
    the max is over the primitive m-th root spectrum."""
    arr = np.asarray(arr, dtype=np.float64)
    if pow2:
        N = len(arr)
        zeta = np.exp(1j * np.pi / N)
        b = arr.astype(np.complex128) * zeta ** np.arange(N)
        mx = float(np.max(np.abs(np.fft.ifft(b) * N)))
    else:
        full = np.zeros(m, dtype=np.float64)
        full[: len(arr)] = arr
        spec = np.fft.fft(full)
        prim = np.array([j for j in range(1, m) if math.gcd(j, m) == 1])
        mx = float(np.max(np.abs(spec[prim])))
    return math.log2(mx) if mx > 0 else float("-inf")


def embedding_largest_coeff_log2(coeffs, m: int, pow2: bool) -> float:
    """The same for integer (possibly bignum) coefficients."""
    return embedding_largest_float_log2([float(int(v)) for v in coeffs], m,
                                        pow2)
