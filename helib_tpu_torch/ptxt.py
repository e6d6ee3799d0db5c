"""Ptxt: plaintext mirror of Ctxt (same ops, no encryption).

helib_tpu.ptxt, the role of HElib's Ptxt<BGV|CKKS> (src/Ptxt.cpp,
include/helib/Ptxt.h:186+) and the PtxtArray façade
(EncryptedArray.h:2166-2624).  Serves as the user-facing plaintext object
and the test oracle: every Ctxt op has a matching slot-wise op here.
"""

from __future__ import annotations

import numpy as np

from .nt import polymod as pm


class PtxtBGV:
    """Slot vector over E = GR(p^r, d); mirrors Ctxt ops slot-wise."""

    def __init__(self, ea, slots=None):
        self.ea = ea
        d = ea.d
        if slots is None:
            self.slots = [np.zeros(d, dtype=np.int64)
                          for _ in range(ea.nslots)]
        else:
            self.slots = []
            for v in list(slots)[:ea.nslots]:
                c = np.zeros(d, dtype=np.int64)
                if np.isscalar(v) or isinstance(v, (int, np.integer)):
                    c[0] = int(v) % ea.pr
                else:
                    vv = np.asarray(v, dtype=np.int64) % ea.pr
                    c[:len(vv)] = vv
                self.slots.append(c)
            while len(self.slots) < ea.nslots:
                self.slots.append(np.zeros(d, dtype=np.int64))

    def copy(self):
        out = PtxtBGV(self.ea)
        out.slots = [s.copy() for s in self.slots]
        return out

    # -- slot-wise ring ops ----------------------------------------------
    def _binop(self, other, fn):
        out = self.copy()
        for i in range(len(out.slots)):
            v = fn(list(out.slots[i]), list(other.slots[i]))
            c = np.zeros(self.ea.d, dtype=np.int64)
            c[:len(v)] = v
            out.slots[i] = c
        return out

    def add(self, other):
        return self._binop(other, lambda a, b: pm.padd(a, b, self.ea.pr))

    def sub(self, other):
        return self._binop(other, lambda a, b: pm.psub(a, b, self.ea.pr))

    def multiply(self, other):
        G, pr = self.ea.G, self.ea.pr
        return self._binop(other, lambda a, b: pm.pmulmod(a, b, G, pr))

    def square(self):
        return self.multiply(self)

    def power(self, e: int):
        G, pr = self.ea.G, self.ea.pr
        out = self.copy()
        out.slots = [_pad(pm.ppowmod(list(s), e, G, pr), self.ea.d)
                     for s in self.slots]
        return out

    def negate(self):
        out = self.copy()
        out.slots = [(-s) % self.ea.pr for s in out.slots]
        return out

    # -- data movement -----------------------------------------------------
    def rotate(self, amt: int):
        out = self.copy()
        n = self.ea.nslots
        out.slots = [self.slots[(i - amt) % n] for i in range(n)]
        return out

    def shift(self, amt: int):
        out = self.rotate(amt)
        n = self.ea.nslots
        for i in range(n):
            src = i - amt
            if src < 0 or src >= n:
                out.slots[i] = np.zeros(self.ea.d, dtype=np.int64)
        return out

    def rotate_1d(self, dim: int, amt: int):
        pal = self.ea.ctx.pal
        D = pal.orders[dim]
        out = self.copy()
        for s in range(self.ea.nslots):
            cs = list(pal.coords(s))
            cs[dim] = (cs[dim] + amt) % D
            out.slots[pal.slot_index(cs)] = self.slots[s]
        return out

    def frobenius(self, j: int = 1):
        return self.power(self.ea.p ** j)

    def total_sums(self):
        acc = [0]
        for s in self.slots:
            acc = pm.padd(acc, list(s), self.ea.pr)
        out = self.copy()
        out.slots = [_pad(acc, self.ea.d) for _ in self.slots]
        return out

    def running_sums(self):
        out = self.copy()
        acc = [0]
        for i, s in enumerate(self.slots):
            acc = pm.padd(acc, list(s), self.ea.pr)
            out.slots[i] = _pad(acc, self.ea.d)
        return out

    # -- conversions -------------------------------------------------------
    def encode(self) -> np.ndarray:
        return self.ea.encode(self.slots)

    @classmethod
    def decode(cls, ea, poly):
        out = cls(ea)
        out.slots = ea.decode(poly)
        return out

    def ints(self) -> np.ndarray:
        return np.array([s[0] for s in self.slots], dtype=np.int64)

    def __eq__(self, other):
        return all(np.array_equal(a, b)
                   for a, b in zip(self.slots, other.slots))


def _pad(v, d):
    c = np.zeros(d, dtype=np.int64)
    c[:len(v)] = v
    return c


class PtxtArray:
    """Scheme-agnostic façade bundling (ea, slots) with encrypt/decrypt
    (role of reference PtxtArray, EncryptedArray.h:2166)."""

    def __init__(self, ea, values=None):
        self.ea = ea
        self.ptxt = PtxtBGV(ea, values)

    def load(self, values):
        self.ptxt = PtxtBGV(self.ea, values)
        return self

    def encrypt(self, pubkey, rng):
        return pubkey.encrypt_bgv(self.ptxt.encode(), rng)

    def decrypt(self, ctxt, sk):
        self.ptxt = PtxtBGV.decode(self.ea, sk.decrypt_bgv(ctxt))
        return self

    def store(self):
        return self.ptxt.ints()

    def distance(self, other) -> float:
        a, b = self.ptxt.ints(), other.ptxt.ints()
        return float(np.max(np.abs(a - b))) if len(a) else 0.0
