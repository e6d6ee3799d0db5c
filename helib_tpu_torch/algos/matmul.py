"""Encrypted linear algebra: MatMul1D / MatMulFull with BSGS
(helib_tpu.algos.matmul).

HElib's matmul (src/matmul.cpp, include/helib/matmul.h:24-420):

  * MatMul1D: a D x D matrix acting along one hypercube dimension on every
    "column" of the slot hypercube, as
        y = sum_{i<D} diag_i * rho^i(x)
    with diag_i the encoded i-th generalized diagonal and rho the 1D
    rotation along the dimension;
  * baby-step/giant-step (matmul.cpp:888-973): i = g*j + l,
        y = sum_j rho^{g*j}( sum_l diag'_{g j + l} * rho^l(x) ),
    with the inner diagonals pre-rotated so only ~2*sqrt(D) rotations are
    needed, the baby steps hoisted (algos/hoisting.py) on native dims;
  * BlockMatMul1D: d x d blocks over the slot extension ring, each rotation
    followed by a linearized polynomial (matmul.cpp:1697);
  * MatMulFull / BlockMatMulFull: the same over all slots with global
    rotations (matmul.cpp:2254).

Matrices are callables get(i, j) -> int (mod p^r) or a d x d block, as
HElib's virtual `MatMul1D::get`.  Diagonals are encoded on the host (the
EncryptedArray's tables are host numpy) and cached as device-resident
FatEncodedPtxt, built on first use and shared across applications.
"""

from __future__ import annotations

import math

import numpy as np


class MatMul1D:
    """D x D cleartext matrix applied along hypercube dim (BGV)."""

    def __init__(self, ea, dim: int, get):
        self.ea = ea
        self.dim = dim
        self.get = get          # get(i, j) scalar mod p^r
        self.D = ea.ctx.pal.orders[dim]
        # (i, rotated_by) -> FatEncodedPtxt | None: device-resident encoded
        # diagonals, built on first use, shared across applications
        # (HElib's ConstMultiplierCache + upgrade(), matmul.h:251-264)
        self._fat_cache: dict = {}

    def _fat_diag(self, i: int, rotated_by: int = 0):
        """Cached device-resident encoded diagonal (None if all-zero)."""
        key = (i, rotated_by)
        if key not in self._fat_cache:
            from ..encoded import FatEncodedPtxt
            sl = self._diag_slots(i, rotated_by)
            if not sl.any():
                self._fat_cache[key] = None
            else:
                self._fat_cache[key] = FatEncodedPtxt(
                    self.ea.ctx, self.ea.encode(list(sl)), space=self.ea.pr)
        return self._fat_cache[key]

    # -- diagonal encoding -------------------------------------------------
    def _diag_slots(self, i: int, rotated_by: int = 0) -> np.ndarray:
        """Encoded slot matrix [nslots, d] for the i-th generalized diagonal,
        optionally pre-rotated by `rotated_by` along the dim (BSGS giant
        steps).  Entries may be scalars or extension-ring elements (length-d
        coefficient vectors), HElib's RX-valued constants.

        y[e] = sum_i M[e][e-i] x[e-i]: the constant multiplying rho^i(x) at
        output coord e is M[e][e-i]."""
        ea, pal = self.ea, self.ea.ctx.pal
        D = self.D
        slots = np.zeros((ea.nslots, ea.d), dtype=np.int64)
        for s in range(ea.nslots):
            e = pal.coords(s)[self.dim]
            val = self.get(e, (e - i) % D)
            v = np.atleast_1d(np.asarray(val, dtype=np.int64)) % ea.pr
            slots[s, :len(v)] = v
        if rotated_by:
            # pre-rotate the mask backwards along dim so that applying it
            # before the giant rotation rho^{g} yields the same result
            out = np.zeros_like(slots)
            for s in range(ea.nslots):
                cs = list(pal.coords(s))
                cs[self.dim] = (cs[self.dim] + rotated_by) % D
                out[s] = slots[pal.slot_index(cs)]
            slots = out
        return slots

    # -- application -------------------------------------------------------
    def apply(self, ctxt, key, bsgs: bool | None = None):
        D = self.D
        ea = self.ea
        if bsgs is None:
            bsgs = D >= 8
        if not bsgs:
            acc = None
            rotated = ctxt
            for i in range(D):
                if i > 0:
                    rotated = ea.rotate_1d(ctxt.copy(), self.dim, i, key)
                fat = self._fat_diag(i)
                if fat is None:
                    continue
                t = rotated.copy()
                t.mul_constant_fat(fat)
                acc = t if acc is None else acc.add(t)
            return acc if acc is not None else _zero_like(ctxt)
        # BSGS; baby steps share one digit decomposition (hoisting,
        # HElib's GeneralAutomorphPrecon_BSGS, matmul.cpp:186-296)
        g = max(1, int(math.isqrt(D)))
        nj = (D + g - 1) // g
        pal = ea.ctx.pal
        baby = [ctxt]
        from ..ctxt import Ctxt as _Ctxt
        if pal.native[self.dim] and g > 2 and isinstance(ctxt, _Ctxt):
            from ..nt.numbth import inv_mod
            from .hoisting import AutomorphPrecon
            precon = AutomorphPrecon(ctxt, key)
            ginv = inv_mod(pal.gens[self.dim], ea.ctx.m)
            for l in range(1, g):
                baby.append(precon.automorph(pow(ginv, l, ea.ctx.m)))
        else:
            for l in range(1, g):
                baby.append(ea.rotate_1d(ctxt.copy(), self.dim, l, key))
        acc = None
        for j in range(nj):
            inner = None
            for l in range(g):
                i = g * j + l
                if i >= D:
                    break
                fat = self._fat_diag(i, rotated_by=g * j)
                if fat is None:
                    continue
                t = baby[l].copy()
                t.mul_constant_fat(fat)
                inner = t if inner is None else inner.add(t)
            if inner is None:
                continue
            if g * j:
                inner = ea.rotate_1d(inner, self.dim, g * j, key)
            acc = inner if acc is None else acc.add(inner)
        return acc if acc is not None else _zero_like(ctxt)


class BlockMatMul1D:
    """D x D matrix of d x d blocks acting on the slot extension ring
    along one dimension (HElib's BlockMatMul1D/BlockMatMul1DExec,
    matmul.h:119-183, matmul.cpp:1697).

    get(i, j) -> d x d integer matrix over Z_{p^r}: the Fp-linear map applied
    to the slot value moving from coordinate j to i.  Each rotation amount is
    applied as a linearized polynomial sum_f c_f * sigma^{p^f} with per-slot
    constants."""

    def __init__(self, ea, dim: int, get):
        self.ea = ea
        self.dim = dim
        self.get = get
        self.D = ea.ctx.pal.orders[dim]
        self._fat_cache: dict = {}

    def _fat_lin_coeffs(self, i: int):
        """Cached device-resident linearized-poly constants for rotation i."""
        if i not in self._fat_cache:
            from ..encoded import FatEncodedPtxt
            encs = self._lin_coeffs_for(i)
            if encs is None:
                self._fat_cache[i] = None
            else:
                self._fat_cache[i] = [
                    (FatEncodedPtxt(self.ea.ctx, e, space=self.ea.pr)
                     if e is not None and np.any(e) else None)
                    for e in encs]
        return self._fat_cache[i]

    def _lin_coeffs_for(self, i: int):
        """Per-slot linearized-poly coefficient vectors for rotation i:
        returns list over f < d of encoded constant polys (or None)."""
        from .linpoly import lin_poly_coeffs
        ea, pal = self.ea, self.ea.ctx.pal
        d = ea.d
        per_slot: list = []
        any_nz = False
        # the block (hence the linearized-poly solve) depends only on the
        # dim coordinate pair (e, j): cache the solves so a D-slot dim
        # costs D^2 solves, not nslots*D (nslots=1200 against D=2 at
        # m=31775)
        solves: dict = {}
        for s in range(ea.nslots):
            e = pal.coords(s)[self.dim]
            key = (e, (e - i) % self.D)
            if key not in solves:
                M = np.asarray(self.get(*key), dtype=np.int64) % ea.pr
                solves[key] = (lin_poly_coeffs(ea, [M[:, k2]
                                                    for k2 in range(d)])
                               if M.any() else None)
            sol = solves[key]
            per_slot.append(sol)
            any_nz = any_nz or sol is not None
        if not any_nz:
            return None
        out = []
        d_ = ea.d
        for f in range(d_):
            slots = []
            nz = False
            for s in range(ea.nslots):
                if per_slot[s] is None:
                    slots.append(np.zeros(d_, dtype=np.int64))
                else:
                    c = per_slot[s][f]
                    slots.append(np.asarray(c, dtype=np.int64))
                    nz = nz or bool(np.asarray(c).any())
            out.append(self.ea.encode(slots) if nz else None)
        return out

    def apply(self, ctxt, key):
        ea = self.ea
        acc = None
        for i in range(self.D):
            encs = self._fat_lin_coeffs(i)
            if encs is None:
                continue
            rot = ea.rotate_1d(ctxt.copy(), self.dim, i, key) if i else ctxt
            frob = rot
            for f, enc in enumerate(encs):
                if f > 0:
                    frob = frob.copy().frobenius(1, key)
                if enc is None:
                    continue
                t = frob.copy()
                t.mul_constant_fat(enc)
                acc = t if acc is None else acc.add(t)
        return acc if acc is not None else _zero_like(ctxt)


class MatMulFull:
    """phi(m)/d x phi(m)/d matrix over all slots (HElib's MatMulFullExec,
    matmul.cpp:2254), applied with global-rotation diagonals."""

    def __init__(self, ea, get):
        self.ea = ea
        self.get = get          # get(s_out, s_in) mod p^r
        self._fat_cache: dict = {}

    def _fat_diag(self, i: int):
        if i not in self._fat_cache:
            from ..encoded import FatEncodedPtxt
            ea, n = self.ea, self.ea.nslots
            sl = np.array([int(self.get(s, (s - i) % n)) % ea.pr
                           for s in range(n)], dtype=np.int64)
            self._fat_cache[i] = (
                FatEncodedPtxt(ea.ctx, ea.encode(list(sl)), space=ea.pr)
                if sl.any() else None)
        return self._fat_cache[i]

    def apply(self, ctxt, key):
        ea = self.ea
        n = ea.nslots
        # direct (dense) implementation over the linear slot index using
        # global rotations; i-th diagonal constant at out-slot s is
        # M[s][(s-i) mod n]
        acc = None
        for i in range(n):
            fat = self._fat_diag(i)
            if fat is None:
                continue
            rot = ea.rotate(ctxt.copy(), i, key) if i else ctxt
            t = rot.copy()
            t.mul_constant_fat(fat)
            acc = t if acc is None else acc.add(t)
        return acc if acc is not None else _zero_like(ctxt)


class BlockMatMulFull:
    """n x n matrix of d x d blocks over all slots (HElib's
    BlockMatMulFull/BlockMatMulFullExec, matmul.h:186-247): get(s_out, s_in)
    returns the d x d integer matrix (the Fp-linear map applied to the slot
    value moving from s_in to s_out).  Applied as global-rotation diagonals,
    each followed by a per-slot linearized polynomial sum_f c_f sigma^{p^f}.
    """

    def __init__(self, ea, get):
        self.ea = ea
        self.get = get
        self._fat_cache: dict = {}

    def _fat_lin_coeffs(self, i: int):
        if i not in self._fat_cache:
            from .linpoly import lin_poly_coeffs
            from ..encoded import FatEncodedPtxt
            ea = self.ea
            n, d = ea.nslots, ea.d
            per_slot: list = []
            any_nz = False
            for s in range(n):
                M = np.asarray(self.get(s, (s - i) % n),
                               dtype=np.int64) % ea.pr
                if not M.any():
                    per_slot.append(None)
                    continue
                any_nz = True
                per_slot.append(lin_poly_coeffs(
                    ea, [M[:, k2] for k2 in range(d)]))
            if not any_nz:
                self._fat_cache[i] = None
            else:
                out = []
                for f in range(d):
                    slots, nz = [], False
                    for s in range(n):
                        if per_slot[s] is None:
                            slots.append(np.zeros(d, dtype=np.int64))
                        else:
                            c = np.asarray(per_slot[s][f], dtype=np.int64)
                            slots.append(c)
                            nz = nz or bool(c.any())
                    out.append(FatEncodedPtxt(ea.ctx,
                                              ea.encode(slots), space=ea.pr)
                               if nz else None)
                self._fat_cache[i] = out
        return self._fat_cache[i]

    def apply(self, ctxt, key):
        ea = self.ea
        acc = None
        for i in range(ea.nslots):
            encs = self._fat_lin_coeffs(i)
            if encs is None:
                continue
            rot = ea.rotate(ctxt.copy(), i, key) if i else ctxt
            frob = rot
            for f, enc in enumerate(encs):
                if f > 0:
                    frob = frob.copy().frobenius(1, key)
                if enc is None:
                    continue
                t = frob.copy()
                t.mul_constant_fat(enc)
                acc = t if acc is None else acc.add(t)
        return acc if acc is not None else _zero_like(ctxt)


def _zero_like(ctxt):
    out = ctxt.copy()
    out.mul_constant_poly(np.zeros(1, dtype=np.int64))
    return out
