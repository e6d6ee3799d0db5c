"""Cleartext-polynomial evaluation on ciphertexts (Paterson-Stockmeyer)
(helib_tpu.algos.polyeval).

HElib's polyEval (src/polyEval.cpp, include/helib/polyEval.h): a lazy cache
of ciphertext powers and a degree-balanced baby-step/giant-step evaluation.
"""

from __future__ import annotations

import math

import numpy as np


class CtxtPowers:
    """Lazy cache of x^i (HElib's DynamicCtxtPowers, polyEval.h:45)."""

    def __init__(self, x, key):
        self.sk = key
        self.cache = {1: x}

    def get(self, i: int):
        if i in self.cache:
            return self.cache[i]
        # split as balanced as possible to minimize depth
        a = 1 << (i.bit_length() - 1)
        if a == i:
            a = i // 2
        b = i - a
        out = self.get(a).multiply(self.get(b), self.sk)
        self.cache[i] = out
        return out


def poly_eval(coeffs, x, key):
    """Evaluate sum coeffs[i]*x^i homomorphically (BGV, scalar coeffs mod
    p^r).  Paterson-Stockmeyer: degree-n poly with ~2*sqrt(n) ctxt mults."""
    pr = x.ptxt_space
    coeffs = [int(c) % pr for c in coeffs]
    while coeffs and coeffs[-1] == 0:
        coeffs.pop()
    n = len(coeffs) - 1
    if n <= 0:
        out = x.copy()
        out.mul_constant_poly(np.zeros(1, dtype=np.int64))
        if coeffs:
            out.add_constant_poly(np.array([coeffs[0]], dtype=np.int64))
        return out
    powers = CtxtPowers(x, key)
    k = max(1, int(math.isqrt(n)))
    # giant steps: P(x) = sum_j B_j(x) * (x^k)^j, deg B_j < k
    blocks = [coeffs[i:i + k] for i in range(0, len(coeffs), k)]

    def eval_block(bl):
        """sum bl[i] x^i with baby powers; returns Ctxt or ('const', c)."""
        acc = None
        for i, c in enumerate(bl):
            if c == 0:
                continue
            if i == 0:
                continue
            t = powers.get(i).copy()
            t.mul_constant_poly(np.array([c], dtype=np.int64))
            acc = t if acc is None else acc.add(t)
        return acc, (bl[0] if bl else 0)

    # Horner over giant steps with xk = x^k
    xk = powers.get(k) if len(blocks) > 1 else None
    result = None
    for bl in reversed(blocks):
        acc, c0 = eval_block(bl)
        if result is not None:
            result = result.multiply(xk, key)
        if acc is not None:
            result = acc if result is None else result.add(acc)
        if c0:
            if result is None:
                z = x.copy()
                z.mul_constant_poly(np.zeros(1, dtype=np.int64))
                result = z
            result.add_constant_poly(np.array([c0], dtype=np.int64))
        if result is None:
            z = x.copy()
            z.mul_constant_poly(np.zeros(1, dtype=np.int64))
            result = z
    return result


def ctxt_power(x, e: int, key):
    """x^e (HElib's Ctxt::power, polyEval.cpp:392)."""
    return CtxtPowers(x, key).get(e)
