"""LWE security estimation (affine fit) + parameter search
(helib_tpu.security).

Role of HElib's lweEstimateSecurity / FindM (src/Context.cpp:34-115,
include/helib/Context.h:34-90): affine approximations to the Albrecht et
al. lwe-estimator (Aug-2020 fits, HElib's
misc/estimator/lwe-estimator.sage) on X = n / log2(1/alpha).
"""

from __future__ import annotations

import math

MIN_SK_HWT = 120
BOOT_DFLT_SK_HWT = MIN_SK_HWT

_HWGTS = [120, 150, 180, 210, 240, 270, 300, 330, 360, 390, 420, 450]
_SLOPES = [2.4, 2.67, 2.83, 3.0, 3.1, 3.3, 3.3, 3.35, 3.4, 3.45, 3.5, 3.55]
_CNSTRMS = [19, 13, 10, 6, 3, 1, -3, -4, -5, -7, -10, -12]


def lwe_estimate_security(n: int, log2_alpha_inv: float, hwt: int) -> float:
    """Security level estimate; 0 if below-minimum sparse weight."""
    if hwt < 0 or (0 < hwt < MIN_SK_HWT):
        return 0.0
    if hwt == 0:
        slope, const = 3.8, -20.0
    else:
        idx = min((hwt - 120) // 30, len(_HWGTS) - 1)
        if idx >= len(_HWGTS) - 1:
            slope, const = _SLOPES[-1], _CNSTRMS[-1]
        else:
            a = (hwt - _HWGTS[idx]) / (_HWGTS[idx + 1] - _HWGTS[idx])
            slope = _SLOPES[idx] + a * (_SLOPES[idx + 1] - _SLOPES[idx])
            const = _CNSTRMS[idx] + a * (_CNSTRMS[idx + 1] - _CNSTRMS[idx])
    x = n / log2_alpha_inv
    return max(0.0, slope * x + const)


def context_security(ctx, hwt: int = 0) -> float:
    """Security of a built context: n = phi(m), alpha = stdev*sqrt(2pi)/Q
    with Q including the special primes (the key-switching modulus)."""
    log2_q = ctx.log2_q(ctx.L) + ctx.log2_special()
    log2_alpha_inv = log2_q - math.log2(ctx.stdev * math.sqrt(2 * math.pi))
    return lwe_estimate_security(ctx.phi_m, log2_alpha_inv, hwt)


def find_m(k: int, nbits: int, p: int = 2, d: int = 0,
           candidates=None) -> int:
    """Smallest m from a candidate list giving >= k bits of security for a
    modulus of `nbits` bits, with ord_m(p) divisible constraint d if given
    (role of reference FindM, Context.cpp:116)."""
    from .nt.numbth import phi_n, mult_order
    if candidates is None:
        candidates = [1023, 2047, 4095, 8191, 16383, 21845, 32767, 45551,
                      65535] + [2**i for i in range(10, 18)]
    for m in sorted(candidates):
        if p > 0 and math.gcd(m, p) != 1:
            continue
        if d and p > 0 and mult_order(p, m) % d != 0:
            continue
        sec = lwe_estimate_security(phi_n(m), nbits, 0)
        if sec >= k:
            return m
    raise ValueError("no m found for requested security")
