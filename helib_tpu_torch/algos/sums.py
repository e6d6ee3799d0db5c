"""Slot-summation helpers: totalSums / runningSums.

helib_tpu.algos.sums: HElib's totalSums/runningSums
(include/helib/EncryptedArray.h:2566-2624, src/EncryptedArray.cpp)."""

from __future__ import annotations

import numpy as np
from ..exceptions import assert_true


def total_sums(ea, ctxt, key):
    """Every slot becomes the sum of all slots (log-depth rotate+add)."""
    n = ea.nslots
    out = ctxt
    e = 1
    # binary ladder: maintains `out` = sum of e consecutive rotations
    bits = []
    v = n
    while v > 1:
        bits.append(v & 1)
        v >>= 1
    for b in reversed(bits):
        out = out.copy().add(_rot(ea, out, e, key))
        e *= 2
        if b:
            out = ctxt.copy().add(_rot(ea, out, 1, key))
            e += 1
    assert_true(e == n, 'invariant: e == n')
    return out


def running_sums(ea, ctxt, key):
    """Slot j becomes sum of slots 0..j (reference runningSums)."""
    n = ea.nslots
    out = ctxt
    shift = 1
    while shift < n:
        shifted = _shift(ea, out, shift, key)
        out = out.copy().add(shifted)
        shift *= 2
    return out


def _rot(ea, ctxt, amt, key):
    return ea.rotate(ctxt.copy(), amt, key)


def _shift(ea, ctxt, amt, key):
    """Global non-cyclic shift by amt (zero-fill below)."""
    rotated = ea.rotate(ctxt.copy(), amt, key)
    # mask out slots with linear index < amt
    mask = np.zeros(ea.nslots, dtype=np.int64)
    mask[amt:] = 1
    rotated.mul_constant_poly(ea.encode(list(mask)))
    return rotated
