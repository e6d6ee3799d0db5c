"""CKKS plaintext mirror (helib_tpu.ckks_ptxt; role of HElib's Ptxt<CKKS>):
the complex-slot oracle the CKKS tests hold decryptions against."""

from __future__ import annotations

import numpy as np


class PtxtCKKS:
    def __init__(self, ea, slots=None):
        self.ea = ea
        z = np.zeros(ea.nslots, dtype=np.complex128)
        if slots is not None:
            s = np.asarray(slots, dtype=np.complex128).ravel()
            z[:len(s)] = s
        self.slots = z

    def copy(self):
        return PtxtCKKS(self.ea, self.slots)

    def add(self, other):
        return PtxtCKKS(self.ea, self.slots + other.slots)

    def sub(self, other):
        return PtxtCKKS(self.ea, self.slots - other.slots)

    def multiply(self, other):
        return PtxtCKKS(self.ea, self.slots * other.slots)

    def square(self):
        return self.multiply(self)

    def negate(self):
        return PtxtCKKS(self.ea, -self.slots)

    def conjugate(self):
        return PtxtCKKS(self.ea, np.conj(self.slots))

    def rotate(self, amt: int):
        return PtxtCKKS(self.ea, np.roll(self.slots, amt))

    def total_sums(self):
        return PtxtCKKS(self.ea, np.full_like(self.slots, self.slots.sum()))

    def distance(self, other) -> float:
        return float(np.max(np.abs(self.slots - other.slots)))
