"""Small user-facing helpers mirroring HElib's header-only utilities:
SumRegister (SumRegister.h:30), zeroValue (zeroValue.h), CtPtrs-style
aggregation over lists of ciphertexts (CtPtrs.h), Matrix views (Matrix.h)."""

from __future__ import annotations

import numpy as np


def zero_like(ctxt):
    """A fresh encryption-of-zero shaped like ctxt (HElib's zeroValue)."""
    out = ctxt.copy()
    out.mul_constant_poly(np.zeros(1, dtype=np.int64))
    return out


def one_like(ea, ctxt):
    out = zero_like(ctxt)
    out.add_constant_poly(np.ones(1, dtype=np.int64))
    return out


class SumRegister:
    """Balanced-tree accumulator for many additions (HElib's
    SumRegister.h:30): keeps log-depth adds instead of a linear chain."""

    def __init__(self):
        self.levels: list = []

    def add(self, ctxt):
        cur = ctxt
        i = 0
        while True:
            if i >= len(self.levels):
                self.levels.append(cur)
                return
            if self.levels[i] is None:
                self.levels[i] = cur
                return
            cur = self.levels[i].copy().add(cur)
            self.levels[i] = None
            i += 1

    def result(self):
        acc = None
        for v in self.levels:
            if v is None:
                continue
            acc = v if acc is None else acc.add(v)
        return acc


def inner_product(ctxts_a: list, ctxts_b: list, sk):
    """<a, b> over ciphertext vectors (HElib's innerProduct,
    Ctxt.h:1488-1526)."""
    reg = SumRegister()
    for x, y in zip(ctxts_a, ctxts_b):
        reg.add(x.multiply(y, sk))
    return reg.result()


def total_product(ctxts: list, sk):
    """Balanced product tree (HElib's totalProduct)."""
    items = list(ctxts)
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(items[i].multiply(items[i + 1], sk))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def incremental_product(ctxts: list, sk):
    """In-place prefix products: ctxts[i] <- prod(ctxts[0..i]) in log depth
    (HElib's incrementalProduct, Ctxt.h:1488-1526)."""
    n = len(ctxts)
    i = 1
    while i < n:
        for j in range(n - 1, i - 1, -1):
            ctxts[j] = ctxts[j].multiply(ctxts[j - i], sk)
        i *= 2
    return ctxts


def multiply_by2(ctxt, other1, other2, sk):
    """Triple product ctxt*other1*other2 with the multiplication order chosen
    by capacity (HElib's Ctxt::multiplyBy2, Ctxt.cpp:1776): pair the two
    highest-capacity operands first so the scarcest budget is spent in a
    single final multiplication."""
    ops = sorted([ctxt, other1, other2], key=lambda c: c.capacity())
    # ops[0] has the least capacity: multiply the other two first.
    hi = ops[1].multiply(ops[2], sk)
    return ops[0].multiply(hi, sk)
