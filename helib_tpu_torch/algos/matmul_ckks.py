"""CKKS encrypted-vector x cleartext-matrix product.

helib_tpu.algos.matmul_ckks: HElib's MatMul_CKKS / MatMul_CKKS_Complex
(include/helib/matmul.h:200-247, src/matmul.cpp CKKS paths): diagonal
method with BSGS over slot rotations, complex constants encoded on the fly.
"""

from __future__ import annotations

import math

import numpy as np


class MatMulCKKS:
    """nslots x nslots real/complex matrix acting on the slot vector."""

    def __init__(self, ea, get):
        self.ea = ea
        self.get = get            # get(i, j) -> complex
        self.n = ea.nslots

    def _diag(self, i: int, rotated_by: int = 0) -> np.ndarray:
        n = self.n
        out = np.zeros(n, dtype=np.complex128)
        for e in range(n):
            out[e] = self.get(e, (e - i) % n)
        if rotated_by:
            out = np.roll(out, -rotated_by)
        return out

    def apply(self, ctxt, key, bsgs: bool | None = None):
        ea, n = self.ea, self.n
        if bsgs is None:
            bsgs = n >= 16
        if not bsgs:
            acc = None
            for i in range(n):
                dg = self._diag(i)
                if not np.any(dg):
                    continue
                rot = ea.rotate(ctxt.copy(), i, key) if i else ctxt
                t = ea.mul_const(rot, dg)
                acc = t if acc is None else acc.add(t)
            return acc
        g = max(1, int(math.isqrt(n)))
        nj = (n + g - 1) // g
        baby = [ctxt]
        for l in range(1, g):
            baby.append(ea.rotate(ctxt.copy(), l, key))
        acc = None
        for j in range(nj):
            inner = None
            for l in range(g):
                i = g * j + l
                if i >= n:
                    break
                dg = self._diag(i, rotated_by=g * j)
                if not np.any(dg):
                    continue
                t = ea.mul_const(baby[l], dg)
                inner = t if inner is None else inner.add(t)
            if inner is None:
                continue
            if g * j:
                inner = ea.rotate(inner, g * j, key)
            acc = inner if acc is None else acc.add(inner)
        return acc
