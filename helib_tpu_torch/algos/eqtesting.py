"""Equality testing helpers (HElib's src/eqtesting.cpp).

mapTo01: x -> x^{p^d - 1}, which is 0 for x=0 and 1 otherwise in each slot
(Fermat in GF(p^d)); computed with Frobenius maps so only ~log(p)+d ctxt
mults are needed (HElib's eqtesting.cpp:48)."""

from __future__ import annotations

from .polyeval import ctxt_power
from ..exceptions import assert_true


def map_to_01(ea, ctxt, key):
    ctx = ea.ctx
    p, d = ctx.p, ea.d
    assert_true(ctx.r == 1, "mapTo01 requires plaintext space p (r=1)")
    out = ctxt
    if p > 2:
        out = ctxt_power(out, p - 1, key)     # x^{p-1}
    # now out = x^{p-1}; compute norm: prod_{i<d} sigma_{p^i}(out)
    # = x^{(p-1)(1+p+...+p^{d-1})} = x^{p^d-1}
    if d > 1:
        acc = out
        frob = out
        for i in range(1, d):
            frob = frob.copy().frobenius(1, key)
            acc = acc.multiply(frob, key)
        out = acc
    return out


def incremental_zero_test(ea, ctxts: list, key):
    """For a list of bit ciphertexts b_1..b_k, return z_i = prod_{j<=i}
    (1 - b_j): z_i = 1 iff all of b_1..b_i are zero (HElib's
    incrementalZeroTest, eqtesting.cpp:134)."""
    import numpy as np
    out = []
    acc = None
    for b in ctxts:
        nb = b.copy()
        nb.mul_constant_poly(np.full(1, -1, dtype=np.int64))
        nb.add_constant_poly(np.ones(1, dtype=np.int64))
        acc = nb if acc is None else acc.multiply(nb, key)
        out.append(acc.copy())
    return out
