"""Cyclotomic polynomial Phi_m(X) over Z, host-side, exact.

Role equivalent: the Phi_m computation inside HElib's PAlgebra
(src/PAlgebra.cpp).  Small m: iterated exact polynomial
division of X^m - 1 by Phi_d for proper divisors d | m, with Python ints.
Large m: radical reduction Phi_m(X) = Phi_{rad(m)}(X^{m/rad(m)}) plus
numpy-vectorized synthetic division (int64; verified by evaluation at a
random point modulo a 62-bit prime, which catches any overflow).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .numbth import divisors, prime_factors
from ..exceptions import assert_true


def _polydiv_exact(num: list[int], den: list[int]) -> list[int]:
    """Exact division of integer polynomials (num = q * den). Coeff lists low->high."""
    num = list(num)
    dn = len(den) - 1
    qn = len(num) - 1 - dn
    q = [0] * (qn + 1)
    lead = den[-1]
    assert_true(lead in (1, -1), 'invariant: lead in (1, -1)')
    for i in range(qn, -1, -1):
        c = num[i + dn] // lead
        q[i] = c
        if c:
            for j, dj in enumerate(den):
                num[i + j] -= c * dj
    assert_true(all(v == 0 for v in num[: dn + 1]) or all(v == 0 for v in num), num[:8])
    return q


def _polydiv_exact_np(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """Exact division, vectorized synthetic-division inner step (int64)."""
    num = num.astype(np.int64).copy()
    dn = len(den) - 1
    qn = len(num) - 1 - dn
    q = np.zeros(qn + 1, dtype=np.int64)
    assert_true(den[-1] == 1, 'invariant: den[-1] == 1')
    for i in range(qn, -1, -1):
        c = num[i + dn]
        q[i] = c
        if c:
            num[i:i + dn + 1] -= c * den
    assert_true(not num[:dn + 1].any() or not num.any(), 'invariant: not num[:dn + 1].any() or not num.any()')
    return q


@lru_cache(maxsize=256)
def cyclotomic_poly(m: int) -> tuple[int, ...]:
    """Coefficients of Phi_m(X), low->high, exact integers."""
    if m == 1:
        return (-1, 1)
    rad = 1
    for q in prime_factors(m):
        rad *= q
    if rad != m:
        # Phi_m(X) = Phi_rad(X^{m/rad})
        base = cyclotomic_poly(rad)
        s = m // rad
        out = [0] * (s * (len(base) - 1) + 1)
        out[::s] = base
        return tuple(out)
    if m <= 1024:
        # X^m - 1 = prod_{d|m} Phi_d
        num = [0] * (m + 1)
        num[0], num[m] = -1, 1
        for d in divisors(m):
            if d == m:
                continue
            num = _polydiv_exact(num, list(cyclotomic_poly(d)))
        return tuple(num)
    # large squarefree m: numpy divisions, then exact verification
    num = np.zeros(m + 1, dtype=np.int64)
    num[0], num[m] = -1, 1
    for d in divisors(m):
        if d == m:
            continue
        num = _polydiv_exact_np(num, np.array(cyclotomic_poly(d),
                                              dtype=np.int64))
    # verify (X^m - 1)(x) == prod Phi_d(x) mod a 62-bit prime at random x
    # (catches any int64 overflow in the divisions)
    P = (1 << 61) - 1
    rng = np.random.default_rng(m)
    x = int(rng.integers(2, P - 1))
    lhs = (pow(x, m, P) - 1) % P
    rhs = 1
    for d in divisors(m):
        coeffs = num if d == m else cyclotomic_poly(d)
        acc = 0
        for c in reversed(list(coeffs)):
            acc = (acc * x + int(c)) % P
        rhs = rhs * acc % P
    assert_true(lhs == rhs, "cyclotomic verification failed (overflow?)")
    return tuple(int(v) for v in num)
