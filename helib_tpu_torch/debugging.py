"""Debug hooks: actual-vs-estimated noise checks, decrypt-and-print
(helib_tpu.debugging).

Role of HElib's debugging (src/debugging.cpp, include/helib/debugging.h:
36-91: dbgKey/dbgEa globals, decryptAndPrint, checkNoise).  The noise
checks move the inner product's residues to the host (SecKey.noise_of)."""

from __future__ import annotations

import sys

from .log import warning
from .exceptions import assert_true

dbg_key = None
dbg_ea = None


def setup_debug_globals(sk, ea=None):
    """Install snoop pointers (reference setupDebugGlobals)."""
    global dbg_key, dbg_ea
    dbg_key = sk
    dbg_ea = ea


def check_noise(ctxt, msg: str = "", tolerance_bits: float = 0.5) -> bool:
    """Compare actual noise (via the debug secret key) against the tracked
    estimate (reference checkNoise, debugging.h:81).  Returns True if the
    estimate dominates the actual noise."""
    assert_true(dbg_key is not None, "setup_debug_globals first")
    actual = dbg_key.noise_of(ctxt)
    ok = actual <= ctxt.noise + tolerance_bits
    if not ok:
        warning(f"checkNoise{': ' + msg if msg else ''}: actual 2^{actual:.1f}"
                f" > estimate 2^{ctxt.noise:.1f}")
    return ok


def decrypt_and_print(ctxt, msg: str = "", file=None):
    file = file or sys.stderr
    assert_true(dbg_key is not None, 'invariant: dbg_key is not None')
    print(f"[{msg}] cap={ctxt.capacity():.1f} noise=2^{ctxt.noise:.1f} "
          f"k={ctxt.k} special={ctxt.special}", file=file)
    if dbg_ea is not None and ctxt.ctx.scheme == "bgv":
        vals = dbg_ea.decrypt_ints(ctxt, dbg_key)
        print(f"  slots={list(vals[:16])}...", file=file)


def check_ctxt(ctxt, msg: str = "", file=None):
    """Reference CheckCtxt (Ctxt.h:1550): print capacity/level summary."""
    file = file or sys.stderr
    print(f"  [{msg}] k={ctxt.k}+{'S' if ctxt.special else ''} "
          f"cap={ctxt.capacity():.1f} logQ={ctxt.log2_modulus():.1f}",
          file=file)


class PtSim:
    """Plaintext-level Ctxt stand-in: carries a coefficient vector mod p^r
    and implements the method surface used by the linear-map machinery
    (MatMul1D, EncryptedArray.rotate_1d, trace_map) with EXACT plaintext
    semantics — automorphisms, constant mults, adds — and no encryption.
    Used to validate linear-map constructions (evalmap) fast, mirroring the
    reference's debugging decryptAndPrint workflow."""

    def __init__(self, poly, ea):
        import numpy as np
        from .nt.cyclotomic import cyclotomic_poly
        self._np = np
        self.poly = np.asarray(poly, dtype=np.int64) % ea.pr
        self.ea = ea
        self._phim = [int(c) % ea.pr for c in cyclotomic_poly(ea.m)]

    def copy(self):
        return PtSim(self.poly.copy(), self.ea)

    def _set(self, red):
        out = self._np.zeros(len(self.poly), dtype=self._np.int64)
        out[:len(red)] = red
        self.poly = out

    def _mod_phim(self, acc):
        """Reduce a length<2m int64 vector mod (Phi_m, p^r), vectorized
        (synthetic division against the monic Phi_m; the pure-Python
        polymod path is O(m^2) Python ops — hours at m=35113)."""
        np = self._np
        pr = self.ea.pr
        phim = np.asarray(self._phim, dtype=np.int64)
        phi = len(phim) - 1
        work = acc.astype(np.int64) % pr
        for i in range(len(work) - 1, phi - 1, -1):
            c = work[i] % pr
            if c:
                work[i - phi:i + 1] = (work[i - phi:i + 1] - c * phim) % pr
        return work[:phi]

    def smart_automorph(self, k, sk=None):
        np = self._np
        m, pr = self.ea.m, self.ea.pr
        j = np.arange(len(self.poly), dtype=np.int64)
        acc = np.zeros(m, dtype=np.int64)
        np.add.at(acc, (j * k) % m, self.poly)
        self._set(self._mod_phim(acc % pr))
        return self

    def frobenius(self, j, sk=None):
        return self.smart_automorph(pow(self.ea.p, j, self.ea.m), sk)

    def mul_constant_poly(self, coeffs, mag=None):
        np = self._np
        pr = self.ea.pr
        a = self.poly % pr
        b = np.asarray([int(c) % pr for c in coeffs], dtype=np.int64)
        # exact integer convolution in 15-bit split halves (values < 2^15
        # per half; m * 2^30 < 2^63 for m < 2^33 — no overflow)
        alo, ahi = a & 0x7FFF, a >> 15
        prod = (np.convolve(alo, b) + ((np.convolve(ahi, b) % pr) << 15)) % pr
        # fold mod X^m - 1 first (cheap), then divide by Phi_m
        m = self.ea.m
        if len(prod) > m:
            head = prod[:m].copy()
            head[: len(prod) - m] = (head[: len(prod) - m] + prod[m:]) % pr
            prod = head
        self._set(self._mod_phim(prod))

    def mul_constant_fat(self, fat, mag=None):
        # device-resident constants carry their balanced coefficients
        self.mul_constant_poly(fat.coeffs, mag)

    def add(self, other):
        return PtSim((self.poly + other.poly) % self.ea.pr, self.ea)

    def trace_map(self, sk=None):
        acc = self
        frob = self
        for _ in range(1, self.ea.d):
            frob = frob.copy().frobenius(1, sk)
            acc = acc.copy().add(frob)
        self.poly = acc.poly
        return self
