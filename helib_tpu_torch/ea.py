"""EncryptedArray: the packed-SIMD slot view (BGV; helib_tpu.ea).

The role of HElib's EncryptedArray/PAlgebraMod (src/EncryptedArray.cpp,
src/PAlgebra.cpp PAlgebraModDerived):
slot encode/decode through the CRT factorization Phi_m = prod F_t (mod p^r),
rotations over the hypercube (native dims: one automorphism; bad dims: two
automorphisms blended with masks, reference EncryptedArray.cpp:67-125).

Slot semantics: slot at hypercube index i (representative t_i in (Z/mZ)*/<p>)
holds the evaluation a(Y^{t_i}) in E = Z[Y]/(G, p^r), G an irreducible factor
of Phi_m mod p^r.  Automorphism X -> X^k then maps slot contents by
slot_t(sigma_k a) = slot_{t*k}(a) — rotations are exact index arithmetic.

The slot tables (G, the factors, B, C, the CRT units) and every encode and
decode stay in host numpy, bit-identical to helib_tpu's; the ciphertext side
(automorphisms, key switching, the masks as FatEncodedPtxt) runs on the
context's device.
"""

from __future__ import annotations

import os

import numpy as np

from .context import Context
from .exceptions import InvalidArgument, assert_true
from .keys import SecKey
from .nt.numbth import inv_mod
from .nt import polymod as pm
from .nt.cyclotomic import cyclotomic_poly


class EncryptedArray:
    def __init__(self, ctx: Context, r_override: int | None = None):
        """r_override: build the slot tables mod p^r_override instead of the
        context's p^r (role of the reference's alternative PAlgebraMod views,
        e.g. the recryption alMod with its larger exponent)."""
        if ctx.scheme != "bgv":
            raise InvalidArgument("EncryptedArray requires a BGV context (use EncryptedArrayCKKS)")
        self.ctx = ctx
        pal = ctx.pal
        self.p = ctx.p
        self.r = r_override if r_override is not None else ctx.r
        self.pr = self.p ** self.r
        self.d = pal.d
        self.nslots = pal.nslots
        self.m = ctx.m
        self._mask_cache: dict = {}
        p, r, pr, d = self.p, self.r, self.pr, self.d

        # fast vectorized table construction for large m (nt/slotalg.py):
        # gate on (m, p, d) only so every EA view of one context (including
        # the recryption r_override view) picks the same G mod p
        self._fast = ((ctx.phi_m > 1000 or os.environ.get("HELIB_FAST_EA"))
                      and 1 <= d <= 64)
        if self._fast:
            self._build_tables_fast()
            return

        phim_p = pm.trim([int(c) % p for c in cyclotomic_poly(self.m)])
        facs_p = pm.equal_degree_factor(phim_p, d, p)
        phim_pr = [int(c) % pr for c in cyclotomic_poly(self.m)]
        facs = pm.lift_factorization(phim_pr, facs_p, p, r)
        self.G = facs[0]

        # match factors to slot representatives: F is the factor with
        # F(Y^t) = 0 in Z[Y]/(G, p)
        reps = pal.representatives()
        self.reps = reps
        Gp = [c % p for c in self.G]
        slot_factor: list = [None] * self.nslots
        used = [False] * len(facs)
        for si, t in enumerate(reps):
            Zt = pm.ppowmod([0, 1], t, Gp, p)
            for fi, F in enumerate(facs):
                if used[fi]:
                    continue
                # evaluate F at Zt mod (G, p) by Horner
                acc = []
                for c in reversed(F):
                    acc = pm.padd(pm.pmulmod(acc, Zt, Gp, p), [c % p], p)
                if not acc:
                    slot_factor[si] = fi
                    used[fi] = True
                    break
            assert_true(slot_factor[si] is not None, (si, t))
        self.factors = [facs[slot_factor[i]] for i in range(self.nslots)]

        # per-slot tables: B (powers of Z_t in Y-basis), C = B^{-1}, CRT units
        self.B, self.C, self.units = [], [], []
        for si, t in enumerate(reps):
            Zt = pm.ppowmod([0, 1], t, self.G, pr)
            B = np.zeros((d, d), dtype=np.int64)
            cur = [1]
            for i in range(d):
                for j, c in enumerate(cur):
                    B[j, i] = c
                cur = pm.pmulmod(cur, Zt, self.G, pr)
            self.B.append(B)
            self.C.append(_inv_matrix_mod(B, p, r))
            F = self.factors[si]
            cof, rem = pm.pdivmod(phim_pr, F, pr)
            assert_true(not rem, 'invariant: not rem')
            cof_inv = pm.poly_inv_mod(pm.pmod(cof, F, pr), F, p, r)
            unit = pm.pmod(pm.pmul(cof, cof_inv, pr), phim_pr, pr)
            self.units.append(unit)

    # ------------------------------------------- fast path (nt/slotalg.py)
    def _build_tables_fast(self):
        from .nt import slotalg as sa
        ctx = self.ctx
        p, r, pr, d = self.p, self.r, self.pr, self.d
        reps = ctx.pal.representatives()
        self.reps = reps
        phim = cyclotomic_poly(self.m)
        h = sa.find_irreducible(p, d)
        zeta = sa.order_m_element(self.m, p, d, h)
        F_p = sa.batched_minpolys(self.m, p, d, reps, h, zeta)
        self._F = sa.hensel_lift_factors(phim, F_p, p, r)
        self.G = [int(v) for v in self._F[0]]
        self.factors = self._F          # [nslots, d+1] rows
        self._U = sa.batched_crt_units(phim, self._F, p, r)
        self.units = self._U            # [nslots, phi] rows
        gb = sa.GaloisBatch(self.G, pr)
        if d == 1:
            Zt = sa.GaloisBatch(self.G, pr).pow_vec(
                np.array([(-self.G[0]) % pr], dtype=np.int64),
                np.asarray(reps, dtype=np.int64))
        else:
            Y = np.zeros(d, dtype=np.int64)
            Y[1] = 1
            Zt = gb.pow_vec(Y, np.asarray(reps, dtype=np.int64))
        B = np.zeros((self.nslots, d, d), dtype=np.int64)
        cur = np.zeros((self.nslots, d), dtype=np.int64)
        cur[:, 0] = 1
        for i in range(d):
            B[:, :, i] = cur
            if i < d - 1:
                cur = gb.mul(cur, Zt)
        self.B = B
        self.C = sa.batched_inv_matrices(B, p, r)
        self._phim_pr = np.array([int(c) % pr for c in phim],
                                 dtype=np.int64)

    def _slots_to_mat(self, slots) -> np.ndarray:
        pr, d = self.pr, self.d
        c = np.zeros((self.nslots, d), dtype=np.int64)
        for si in range(min(self.nslots, len(slots))):
            v = slots[si]
            if np.isscalar(v) or isinstance(v, (int, np.integer)):
                c[si, 0] = int(v) % pr
            else:
                vv = np.asarray(v, dtype=np.int64) % pr
                c[si, :len(vv)] = vv
        return c

    def _encode_fast(self, slots) -> np.ndarray:
        from .nt.slotalg import exact_matmul
        pr, d, phi = self.pr, self.d, self.ctx.phi_m
        c = self._slots_to_mat(slots)
        # rho[t] = C[t] @ c[t] mod pr (einsum exact: 15-bit split of C)
        rho = ((np.einsum('tij,tj->ti', self.C >> 15, c) % pr << 15)
               + np.einsum('tij,tj->ti', self.C & 0x7FFF, c)) % pr
        rows = exact_matmul(rho.T, self._U, pr)       # [d, phi]
        poly = np.zeros(phi + d - 1, dtype=np.int64)
        for j in range(d):
            poly[j:j + phi] = (poly[j:j + phi] + rows[j]) % pr
        # reduce mod Phi_m (top d-1 coefficients)
        for i in range(phi + d - 2, phi - 1, -1):
            cc = poly[i]
            if cc:
                poly[i - phi:i + 1] = (poly[i - phi:i + 1]
                                       - cc * self._phim_pr) % pr
        return poly[:phi]

    def _decode_fast(self, poly) -> list[np.ndarray]:
        from .nt import slotalg as sa
        pr, d = self.pr, self.d
        pl = np.zeros(self.ctx.phi_m, dtype=np.int64)
        arr = np.asarray(poly, dtype=np.int64) % pr
        pl[:len(arr)] = arr[:self.ctx.phi_m]
        _, resid = sa.batched_divmod_same(pl, self._F, pr)
        vals = ((np.einsum('tij,tj->ti', self.B >> 15, resid) % pr << 15)
                + np.einsum('tij,tj->ti', self.B & 0x7FFF, resid)) % pr
        return [vals[si] for si in range(self.nslots)]

    # ------------------------------------------------------------ encoding
    def encode_ptxt(self, slots):
        """First-class scheme-tagged encoding (reference
        EncryptedArray::encode -> EncodedPtxt, EncodedPtxt.h:142): wraps
        the coefficient vector with the BGV plaintext space so it can be
        passed to Ctxt.mul_by_constant / add_constant and upgraded to a
        device-resident FatEncodedPtxt."""
        from .encoded import EncodedPtxt
        return EncodedPtxt(self.encode(slots), space=self.ctx.ptxt_space)

    def encode(self, slots) -> np.ndarray:
        """slots: length-nslots list; each entry an int (constant slot) or a
        length-<=d coeff vector over Z_{p^r}.  Returns phi(m)-coeff poly."""
        if self._fast:
            return self._encode_fast(slots)
        pr, d = self.pr, self.d
        poly = []
        for si in range(self.nslots):
            v = slots[si] if si < len(slots) else 0
            c = np.zeros(d, dtype=np.int64)
            if np.isscalar(v) or isinstance(v, (int, np.integer)):
                c[0] = int(v) % pr
            else:
                vv = np.asarray(v, dtype=np.int64) % pr
                c[:len(vv)] = vv
            rho = (self.C[si] @ c) % pr              # residue coeffs mod F_t
            term = pm.pmul(list(map(int, rho)), self.units[si], pr)
            poly = pm.padd(poly, term, pr)
        phim_pr = [int(x) % pr for x in cyclotomic_poly(self.m)]
        poly = pm.pmod(poly, phim_pr, pr)
        outv = np.zeros(self.ctx.phi_m, dtype=np.int64)
        outv[:len(poly)] = poly
        return outv

    def decode(self, poly) -> list[np.ndarray]:
        """phi(m)-coeff poly mod p^r -> list of slot coeff vectors (len d)."""
        if self._fast:
            return self._decode_fast(poly)
        pr, d = self.pr, self.d
        pl = [int(c) % pr for c in np.asarray(poly)]
        out = []
        for si in range(self.nslots):
            resid = pm.pmod(pl, self.factors[si], pr)
            c = np.zeros(d, dtype=np.int64)
            c[:len(resid)] = resid
            val = (self.B[si] @ c) % pr
            out.append(val.astype(np.int64))
        return out

    def decode_ints(self, poly) -> np.ndarray:
        """Constant slots only (d irrelevant): value = slot coeff 0."""
        return np.array([v[0] for v in self.decode(poly)], dtype=np.int64)

    # ---------------------------------------------------------- en/decrypt
    def encrypt(self, slots, pubkey, rng):
        return pubkey.encrypt_bgv(self.encode(slots), rng)

    def decrypt(self, ctxt, sk: SecKey):
        return self.decode(sk.decrypt_bgv(ctxt))

    def decrypt_ints(self, ctxt, sk: SecKey):
        return self.decode_ints(sk.decrypt_bgv(ctxt))

    # ---------------------------------------------------------- rotations
    def mask_poly(self, dim: int, lo: int, hi: int) -> np.ndarray:
        """Encoded 0/1 mask: 1 on slots whose dim-coordinate is in [lo, hi)
        (cached — the reference precomputes these in PAlgebraMod::maskTable,
        PAlgebra.h:655-668)."""
        key = (dim, lo, hi)
        cached = self._mask_cache.get(key)
        if cached is not None:
            return cached
        pal = self.ctx.pal
        slots = []
        for s in range(self.nslots):
            e = pal.coords(s)[dim]
            slots.append(1 if lo <= e < hi else 0)
        out = self.encode(slots)
        self._mask_cache[key] = out
        return out

    def const_fat(self, vec):
        """Device-resident encoding of the SAME slot value in every slot
        (cached by value) — the recurring constants of linearized-poly and
        trace-style maps."""
        v = np.atleast_1d(np.asarray(vec, dtype=np.int64)) % self.pr
        key = ("cfat", v.tobytes())
        cached = self._mask_cache.get(key)
        if cached is None:
            from .encoded import FatEncodedPtxt
            cached = FatEncodedPtxt(self.ctx, self.encode([v] * self.nslots),
                                    space=self.pr)
            self._mask_cache[key] = cached
        return cached

    def mask_fat(self, dim: int, lo: int, hi: int):
        """Device-resident cached mask (reference maskTable constants held as
        DoubleCRT after upgrade())."""
        key = ("fat", dim, lo, hi)
        cached = self._mask_cache.get(key)
        if cached is None:
            from .encoded import FatEncodedPtxt
            cached = FatEncodedPtxt(self.ctx, self.mask_poly(dim, lo, hi),
                                    space=self.pr)
            self._mask_cache[key] = cached
        return cached

    def rotate_1d(self, ctxt, dim: int, amt: int, key: SecKey):
        """Cyclic rotation along hypercube dim (reference rotate1D,
        EncryptedArray.cpp:67-125).  Content at coord e moves to e+amt."""
        pal = self.ctx.pal
        D = pal.orders[dim]
        amt = int(amt) % D
        if amt == 0:
            return ctxt
        g = pal.gens[dim]
        m = self.m
        ginv = inv_mod(g, m)
        k1 = pow(ginv, amt, m)
        if pal.native[dim]:
            return ctxt.smart_automorph(k1, key)
        # bad dimension: blend wrapped and unwrapped automorphs
        k2 = k1 * pow(g, D, m) % m
        c1 = ctxt.copy().smart_automorph(k1, key)
        c2 = ctxt.copy().smart_automorph(k2, key)
        c1.mul_constant_fat(self.mask_fat(dim, amt, D))  # coord >= amt
        c2.mul_constant_fat(self.mask_fat(dim, 0, amt))
        return c1.add(c2)

    def shift_1d(self, ctxt, dim: int, amt: int, key: SecKey):
        """Non-cyclic shift (zero fill), reference shift1D."""
        pal = self.ctx.pal
        D = pal.orders[dim]
        if amt == 0:
            return ctxt
        out = ctxt.copy()
        if amt > 0:
            out.mul_constant_fat(self.mask_fat(dim, 0, D - amt))
            return self.rotate_1d(out, dim, amt, key)
        out.mul_constant_fat(self.mask_fat(dim, -amt, D))
        return self.rotate_1d(out, dim, amt % D, key)

    def rotate(self, ctxt, amt: int, key: SecKey):
        """Global rotation over the linearized slot index (reference
        EncryptedArray::rotate, EncryptedArray.cpp:181): mixed-radix addition
        over the hypercube dims, tracking carries with mask blends.

        Processing dims fastest (last) to slowest, we keep two ciphertexts:
        c_noc (no incoming carry) and c_car (incoming carry +1).  After
        rotating a dim by its digit a (a+1 for the carried branch), slots
        with post-rotation coordinate < a (resp. < a+1) generated a carry
        into the next-slower dim.  At the slowest dim the carry wraps for
        free (the rotation is cyclic mod nslots)."""
        n = self.nslots
        amt %= n
        if amt == 0:
            return ctxt
        pal = self.ctx.pal
        orders = pal.orders
        if len(orders) == 1:
            return self.rotate_1d(ctxt, 0, amt, key)
        strides = []
        s = 1
        for o in reversed(orders):
            strides.append(s)
            s *= o
        strides.reverse()
        digits = [(amt // strides[i]) % orders[i] for i in range(len(orders))]
        c_noc, c_car = ctxt, None
        for dim in range(len(orders) - 1, 0, -1):
            a = digits[dim]
            r_noc = self.rotate_1d(c_noc.copy(), dim, a, key)
            r_car = (self.rotate_1d(c_car.copy(), dim, a + 1, key)
                     if c_car is not None else None)
            nc = r_noc.copy()
            nc.mul_constant_fat(self.mask_fat(dim, a, orders[dim]))
            cc = r_noc.copy()
            cc.mul_constant_fat(self.mask_fat(dim, 0, a))
            if r_car is not None:
                t = r_car.copy()
                t.mul_constant_fat(self.mask_fat(dim, a + 1, orders[dim]))
                nc = nc.add(t)
                t2 = r_car.copy()
                t2.mul_constant_fat(self.mask_fat(dim, 0, a + 1))
                cc = cc.add(t2)
            c_noc, c_car = nc, cc
        out = self.rotate_1d(c_noc, 0, digits[0], key)
        if c_car is not None:
            out = out.add(self.rotate_1d(c_car, 0, digits[0] + 1, key))
        return out


def _inv_matrix_mod(B: np.ndarray, p: int, r: int) -> np.ndarray:
    """Inverse of integer matrix mod p^r: Gauss mod p + Newton lift."""
    d = B.shape[0]
    pr = p**r
    # Gauss-Jordan mod p
    A = (B % p).astype(object)
    Inv = np.eye(d, dtype=object)
    for col in range(d):
        piv = next(i for i in range(col, d) if A[i, col] % p != 0)
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
            Inv[[col, piv]] = Inv[[piv, col]]
        ip = inv_mod(int(A[col, col]), p)
        A[col] = (A[col] * ip) % p
        Inv[col] = (Inv[col] * ip) % p
        for i in range(d):
            if i != col and A[i, col] % p:
                f = A[i, col]
                A[i] = (A[i] - f * A[col]) % p
                Inv[i] = (Inv[i] - f * Inv[col]) % p
    X = Inv
    pk = p
    while pk < pr:
        pk = min(pk * pk, pr)
        # X <- X(2I - BX) mod pk
        BX = (B.astype(object) @ X) % pk
        X = (X @ ((2 * np.eye(d, dtype=object)) - BX)) % pk
    return np.array(X % pr, dtype=np.int64)
