"""BGV bootstrapping: thin and fat recryption (helib_tpu.recryption).

HElib's recryption (src/recryption.cpp): the parameter solver setAE
(recryption.cpp:200-268), rawModSwitch to q = p^e + 1 (Ctxt.cpp:2949),
newMakeDivisible (recryption.cpp:73), the slot <-> coefficient linear maps,
and extractDigitsThin (recryption.cpp:793-935).

Two map implementations, chosen by whether the Context has a factor-aligned
mvec:
  * the factor-tree ThinEvalMapTree (evalmap.py) with powerful-basis
    rounding in raw_mod_switch/make_divisible (HElib's ThinEvalMap and
    PowerfulDCRT): the scalable route for composite m;
  * the dense sigma-span maps (LinearMapR below) with power-basis
    rounding: the small-m fallback (any Z-linear map on R is in the sigma
    span by the independence of characters; O(phi(m)^2) unknowns).

The recryption key is a separate sparse (hwt) secret key generated by
RecryptData (HElib's genRecryptData, keys.cpp:1678); the ciphertext is
key-switched onto it before the mod-switch and back by the relinearizations
after the re-encryption.

Host work (the tables, the maps' matrices, the raw mod switch's CRT and
rounding, the Phi_m projection) is host numpy and Python ints, as in
helib_tpu; every ciphertext operation runs on the context's device.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

from .context import Context, log2_add
from .keys import SecKey, PubKey, SKHandle, balanced_int, reduce_mod_phim
from .ctxt import Ctxt
from .ea import EncryptedArray
from . import dcrt
from .ops.modops import to_host
from .nt.numbth import inv_mod
from .nt.cyclotomic import cyclotomic_poly
from .algos.extract import extract_digits
from .exceptions import LogicError, assert_true


# ---------------------------------------------------------------------------
# parameters (HElib's RecryptData::setAE)
# ---------------------------------------------------------------------------

def std_dev_for_recryption(ctx: Context, hwt: int) -> float:
    """HElib's Context::stdDevForRecryption (Context.h:603)."""
    k = ctx.pal.n_factors
    mrat = ctx.phi_m / ctx.m
    return math.sqrt(mrat * hwt * (1 << k) / 3.0) * 0.5


def bound_for_recryption(ctx: Context, hwt: int) -> float:
    return 0.5 + ctx.scale * std_dev_for_recryption(ctx, hwt)


def set_ae(ctx: Context, hwt: int) -> tuple[int, int]:
    """Choose (e, ePrime) minimizing e - ePrime (HElib's setAE)."""
    coeff_bound = bound_for_recryption(ctx, hwt)
    p, r = ctx.p, ctx.r
    p2r = ctx.ptxt_space
    frst = 2 * p2r + 2
    e_bnd, p2e = 0, 1
    while p2e <= ((1 << 30) - 2) // p:
        e_bnd += 1
        p2e *= p
    ePrime, e = 0, r + 1
    while e <= e_bnd and p**e < frst * coeff_bound * 2:
        e += 1
    assert_true(e <= e_bnd, "setAE: cannot find suitable e")
    fudge = 1.05   # conservative stand-in for HElib's compute_fudge
    for ePrimeTry in range(1, e_bnd + 1):
        p2ept = p**ePrimeTry
        eTry = max(r + 1, ePrimeTry + 1)
        while eTry <= e_bnd and eTry - ePrimeTry < e - ePrime:
            if p**eTry >= (p2ept * fudge + frst) * coeff_bound * 2:
                break
            eTry += 1
        if eTry <= e_bnd and eTry - ePrimeTry < e - ePrime:
            e, ePrime = eTry, ePrimeTry
    return e, ePrime


# ---------------------------------------------------------------------------
# general linear maps as sum_k c_k sigma_k (the small-m fallback)
# ---------------------------------------------------------------------------

class LinearMapR:
    """A Z_{p^r}-linear map on R = Z[X]/(Phi_m, p^r) applied homomorphically
    as sum_k encode-free constants times automorphisms."""

    def __init__(self, ea: EncryptedArray, images: dict[int, np.ndarray]):
        """images: basis monomial j -> image poly coeff vector (len phi_m);
        missing j means image 0."""
        self.ea = ea
        ctx = ea.ctx
        pr = ea.pr
        phi = ctx.phi_m
        m = ctx.m
        phim_pr = [int(c) % pr for c in cyclotomic_poly(m)]
        units_k = [k for k in range(1, m) if math.gcd(k, m) == 1]
        nk = len(units_k)
        assert_true(nk == phi, 'invariant: nk == phi')
        # system: for each j: sum_k c_k * (X^{jk} mod Phi) = L(X^j)
        # unknowns: c_k coefficients, stacked [k*phi + t]
        A = np.zeros((phi * phi, phi * phi), dtype=np.int64)
        b = np.zeros(phi * phi, dtype=np.int64)
        for j in range(phi):
            img = images.get(j)
            if img is not None:
                b[j * phi:(j + 1) * phi] = np.asarray(img, dtype=np.int64) % pr
            for ki, k in enumerate(units_k):
                # sigma_k(X^j) = X^{jk mod m} reduced mod Phi_m
                mono = np.zeros(m, dtype=np.int64)
                mono[(j * k) % m] = 1
                red = reduce_mod_phim(mono, ctx, pr)
                # multiplication-by-red matrix column t: red * X^t mod Phi
                for t in range(phi):
                    shifted = np.zeros(t + phi, dtype=np.int64)
                    shifted[t:t + phi] = red[:phi]
                    col = reduce_mod_phim(shifted, ctx, pr)
                    A[j * phi:(j + 1) * phi, ki * phi + t] = _padv(col, phi)
        sol = _solve_mod(A, b, ea.p, ea.r)
        from .encoded import FatEncodedPtxt
        self.terms = []
        for ki, k in enumerate(units_k):
            ck = sol[ki * phi:(ki + 1) * phi] % pr
            if np.any(ck):
                self.terms.append((k, FatEncodedPtxt(ctx, ck.astype(np.int64),
                                                     space=pr)))

    def apply(self, ctxt: Ctxt, key: "PubKey | SecKey") -> Ctxt:
        """Hoisted application: one digit decomposition shared by all the
        automorphism terms (HElib's EvalMap's use of hoisting,
        matmul.cpp:48-183)."""
        from .algos.hoisting import AutomorphPrecon
        if len(self.terms) > 2:
            precon = AutomorphPrecon(ctxt, key)
        acc = None
        for k, ck in self.terms:
            if len(self.terms) > 2:
                t = precon.automorph(k)
            else:
                t = ctxt.copy().smart_automorph(k, key)
            t.mul_constant_fat(ck)
            acc = t if acc is None else acc.add(t)
        if acc is None:
            acc = ctxt.copy()
            acc.mul_constant_poly(np.zeros(1, dtype=np.int64))
        return acc


def _padv(v: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.int64)
    out[:min(len(v), n)] = v[:n]
    return out


def _solve_mod(A: np.ndarray, b: np.ndarray, p: int, r: int) -> np.ndarray:
    """Solve A x = b over Z_{p^r} (vectorized Gauss-Jordan with unit
    pivots; int64 is exact since p^r < 2^30).  The elimination touches only
    the rows with a nonzero multiplier and the columns from the pivot on
    (the pivot row is zero left of it), so it is helib_tpu's elimination
    with the zero updates skipped, in the narrowest integer type that holds
    pr + pr^2: the same solution."""
    pr = p**r
    n = A.shape[0]
    dt = next(t for t in (np.int16, np.int32, np.int64)
              if pr * (pr + 1) <= np.iinfo(t).max)
    M = (A % pr).astype(dt)
    v = (b % pr).astype(np.int64)
    for col in range(n):
        piv = col + int(np.argmax(M[col:, col] % p != 0))
        assert_true(M[piv, col] % p != 0, "singular system in LinearMapR")
        if piv != col:
            M[[col, piv]] = M[[piv, col]]
            v[[col, piv]] = v[[piv, col]]
        inv = pow(int(M[col, col]), -1, pr)
        M[col, col:] = (M[col, col:] * inv) % pr
        v[col] = (v[col] * inv) % pr
        f = M[:, col].copy()
        f[col] = 0
        nz = np.flatnonzero(f)
        if len(nz):
            M[nz, col:] = (M[nz, col:] - np.outer(f[nz], M[col, col:])) % pr
            v[nz] = (v[nz] - f[nz] * v[col]) % pr
    return v


# ---------------------------------------------------------------------------
# recryption data + thin recrypt
# ---------------------------------------------------------------------------

class RecryptData:
    def __init__(self, ctx: Context, sk: SecKey, ea: EncryptedArray,
                 hwt: int = 16):
        assert_true(ctx.scheme == "bgv", 'invariant: ctx.scheme == "bgv"')
        self.ctx, self.ea = ctx, ea
        self.hwt = hwt
        self.e, self.ePrime = set_ae(ctx, hwt)
        self.q = ctx.p**self.e + 1
        pr = ea.pr
        phi = ctx.phi_m
        n = ea.nslots
        self.ea_big = EncryptedArray(ctx, r_override=self.e - self.ePrime
                                     + ctx.r)
        self.pwb = None
        if ctx.pal.aligned is not None:
            # rawModSwitch rounds in the powerful basis for composite m
            # (the role of HElib's PowerfulDCRT)
            from .powerful import PowerfulBasis
            self.pwb = PowerfulBasis(ctx.m, list(ctx.pal.mvec))
        self._build_maps()
        big_space = ctx.p ** (self.e - self.ePrime + ctx.r)
        assert_true(big_space < (1 << 30), 'invariant: big_space < (1 << 30)')
        self.big_space = big_space
        # all KS matrices must carry the large space (HElib's keys.cpp:1218)
        ctx.boot_ptxt_space = big_space
        sk.matrices.clear()
        if sk.pubkey is None:
            PubKey(sk)
        # separate SPARSE recryption key s' appended to the key list
        # (HElib's SecKey::genRecryptData, keys.cpp:1678): the ciphertext
        # is key-switched onto s' before rawModSwitch so the hwt bound used
        # by setAE applies regardless of the main key's density, and ekey is
        # an encryption of s' under the main key with the big space.
        self.recrypt_key = sk.gen_key(hwt)
        self.ekey = _encrypt_with_space(
            sk, sk.skeys[self.recrypt_key]["coeffs"], big_space)

    def _build_maps(self):
        """Thin linear maps: factor-tree (scalable) when the Context has a
        factor-aligned mvec, dense sigma-span otherwise."""
        ctx, ea = self.ctx, self.ea
        pr = ea.pr
        phi = ctx.phi_m
        n = ea.nslots
        if ctx.pal.aligned is not None:
            # scalable factor-tree maps (HElib's ThinEvalMap route)
            from .evalmap import ThinEvalMapTree
            self.slot_to_coeff = ThinEvalMapTree(ea, invert=False)
            # coeffToSlot applies AFTER re-encryption at the big plaintext
            # space p^{e-e'+r} (role of the recryption alMod,
            # recryption.h:44)
            self.coeff_to_slot = ThinEvalMapTree(self.ea_big, invert=True)
        else:
            # dense sigma-span maps (small m fallback)
            # slotToCoeff: x -> sum_t slot_const_t(x) * X^t
            img1: dict[int, np.ndarray] = {}
            for j in range(phi):
                mono = np.zeros(phi, dtype=np.int64)
                mono[j] = 1
                consts = np.array([int(s[0]) % pr for s in ea.decode(mono)])
                out = np.zeros(phi, dtype=np.int64)
                out[:n] = consts
                if np.any(out):
                    img1[j] = out
            self.slot_to_coeff = LinearMapR(ea, img1)
            img2: dict[int, np.ndarray] = {}
            for t in range(n):
                unit = np.zeros(phi, dtype=np.int64)
                u = self.ea_big.units[t]
                unit[:len(u)] = u
                img2[t] = unit
            self.coeff_to_slot = LinearMapR(self.ea_big, img2)

    def __repr__(self):
        return (f"RecryptData(e={self.e}, ePrime={self.ePrime}, q={self.q}, "
                f"big_space={self.big_space})")


def _encrypt_with_space(sk: SecKey, coeffs: np.ndarray, space: int) -> Ctxt:
    """Secret-key encryption of an integer poly with plaintext space
    `space` (the role of the recryptEkey generation, keys.cpp:1678)."""
    ctx = sk.ctx
    rng = sk.rng
    k, special = ctx.L, False
    a = dcrt.sample_uniform_residues(ctx, rng, k, special)
    e_coeffs, _ = dcrt.sample_gaussian(ctx, rng)
    pe = dcrt.small_coeffs_to_rt(ctx, e_coeffs * space, k, special)
    b = dcrt.rt_sub(ctx, pe, dcrt.rt_mul(ctx, a, sk.s_full[:k], k, special),
                    k, special)
    Q = ctx.prod_qs(k)
    fixed = (np.asarray(coeffs, dtype=np.int64) * (Q % space)) % space
    fixed -= (fixed > space // 2) * space
    pt = dcrt.small_coeffs_to_rt(ctx, fixed, k, special)
    b = dcrt.rt_add(ctx, b, pt, k, special)
    noise = log2_add(math.log2(space) + ctx.noise_gaussian(),
                     ctx.noise_mod(space))
    return Ctxt(ctx=ctx, pubkey=sk.pubkey, parts=[(SKHandle(0, 1, 0), b),
                                                  (SKHandle(1, 1, 0), a)],
                k=k, special=special, ptxt_space=space, noise=noise,
                intFactor=1)


def raw_mod_switch(ctxt: Ctxt, q: int, pwb=None) -> list[np.ndarray]:
    """Host-side raw mod switch of a canonical 2-part ciphertext to modulus
    q (HElib's Ctxt::rawModSwitch, Ctxt.cpp:2949).  Returns two balanced
    integer coefficient vectors mod q -- in the POWER basis (deg < phi(m))
    when pwb is None, else in the POWERFUL basis (HElib uses PowerfulDCRT
    here for composite m, powerful.cpp): digit extraction needs
    the per-coordinate rounding to happen in the same basis the factor-tree
    coeffToSlot extracts (evalmap.py)."""
    ctx = ctxt.ctx
    p2r = ctxt.ptxt_space
    rows = ctx.rows_of(ctxt.k, ctxt.special)
    Q = 1
    for qq in ctx.primes_of(ctxt.k, ctxt.special):
        Q *= int(qq)
    Qinv = inv_mod(Q % p2r, p2r)
    out = []
    parts = dict((h.powS, d) for h, d in ctxt.parts)
    from .nt.native import combiner_for
    comb = (combiner_for([int(qq) for qq in ctx.all_q[np.array(rows)]])
            if (pwb is None and ctx.pal.pow2) else None)
    for i in (0, 1):
        res = to_host(ctx.inv_ntt(parts[i], rows))
        if comb is not None:
            # native path (power basis, power-of-2 m): the balanced CRT and
            # the divmod rounding in C++ (native/crt_kernels.cpp)
            out.append(comb.mod_switch(res, q, p2r))
            continue
        vals = dcrt.crt_reconstruct(ctx, res, rows, balanced=True)
        if pwb is not None:
            vals = pwb.poly_to_w_powerful(vals, Q)
        else:
            # reduce mod Phi_m exactly (object ints) for odd m
            vals = _reduce_phim_balanced(vals, ctx, Q)
        zz = np.zeros(len(vals) if pwb is not None else ctx.phi_m,
                      dtype=np.int64)
        for j in range(min(len(vals), len(zz))):
            c = int(vals[j])
            cq = c * q
            X, Y = divmod(cq, Q)
            if Y > Q // 2:
                Y -= Q
                X += 1
            delta = (Y % p2r) * Qinv % p2r
            if delta > p2r // 2:
                delta -= p2r
            x = X + delta
            x = balanced_int(x, q) if abs(x) > q // 2 else x
            zz[j] = x
        out.append(zz)
    return out


def _reduce_phim_balanced(vals, ctx: Context, Q: int):
    """Balanced reduction of a mod-(X^m-1) representative mod Phi_m over the
    integers (object ints)."""
    if ctx.pal.pow2:
        return vals
    m, phi = ctx.m, ctx.phi_m
    phim = [int(c) for c in cyclotomic_poly(m)]
    work = [int(v) for v in vals] + [0] * (m - len(vals))
    for i in range(m - 1, phi - 1, -1):
        c = work[i]
        if c:
            for t, pc in enumerate(phim):
                work[i - phi + t] -= c * pc
    return np.array(work[:phi], dtype=object)


def make_divisible(zz: np.ndarray, p2e_prime: int, q: int) -> np.ndarray:
    """Add multiples of q so every entry is divisible by p^{e'}
    (HElib's newMakeDivisible, recryption.cpp:73)."""
    if p2e_prime == 1:
        return zz
    assert_true(q % p2e_prime == 1, 'invariant: q % p2e_prime == 1')
    z = np.asarray(zz, dtype=np.int64)
    zmod = z % p2e_prime
    v = np.where(zmod <= p2e_prime // 2, -zmod, p2e_prime - zmod)
    return z + v * q


def _boot_trace(msg: str):
    """Phase progress for long bootstraps (HElib's AAA_* phase timers,
    recryption.cpp:417-536), enabled by HELIB_VERBOSE_BOOT=1."""
    if os.environ.get("HELIB_VERBOSE_BOOT"):
        print(f"[boot {time.strftime('%H:%M:%S')}] {msg}",
              file=sys.stderr, flush=True)


def _phim_project(ctx, poly, modulus, _cache={}):
    """Multiply an integer polynomial (deg < m) by the Phi_m-component CRT
    idempotent Pi of Z_modulus[X]/(X^m - 1) (host, FFT-exact cyclic conv).

    Establishes the zero-junk invariant: device ring elements live mod
    X^m - 1, so a plaintext whose slots are p-divisible need not have a
    p-divisible representative — the cofactor components are arbitrary.
    Projecting the re-encryption constants zeroes those components, and
    zero is preserved by every ring op, making the digit-extraction
    divide_by_p ladder exact (see nt.numbth.phim_idempotent).  HElib is
    immune by construction (elements mod Phi_m, CModulus.h:89)."""
    if ctx.pal.pow2:
        return poly
    key = (ctx.m, modulus)
    Pi = _cache.get(key)
    if Pi is None:
        from .nt.numbth import phim_idempotent
        Pi = _cache[key] = phim_idempotent(ctx.m, modulus)
    m = ctx.m
    arr = np.array([int(x) % modulus for x in poly], dtype=np.int64)
    arr -= (arr > modulus // 2) * modulus
    a = np.zeros(m, dtype=np.int64)
    a[:len(arr)] = arr
    Pb = Pi.astype(np.int64) % modulus
    Pb -= (Pb > modulus // 2) * modulus
    # float64 FFT is only trusted well inside its roundoff margin
    # (||a||*||b||*eps*log m error growth); beyond it fall back to an exact
    # int64 linear convolution folded mod X^m-1 (host, cached constants —
    # off the hot path, so O(m^2) C-loop convolve is fine).
    if float(m) * (modulus / 2.0) ** 2 < 2.0**44:
        conv = np.rint(np.fft.irfft(np.fft.rfft(a) *
                                    np.fft.rfft(Pb.astype(np.float64)),
                                    m)).astype(np.int64)
    else:
        if m * (modulus // 2 + 1) ** 2 >= 2 ** 62:
            raise LogicError(
                f"_phim_project: convolution bound overflow (m={m}, "
                f"modulus={modulus})")
        full = np.convolve(a, Pb)            # exact, len 2m-1
        conv = full[:m].copy()
        conv[:m - 1] += full[m:]
    conv %= modulus
    return np.where(conv > modulus // 2, conv - modulus, conv)


def thin_recrypt(ctxt: Ctxt, rc: RecryptData, key: "PubKey | SecKey") -> Ctxt:
    """HElib's PubKey::thinReCrypt (recryption.cpp:940)."""
    ctx = rc.ctx
    ea = rc.ea
    p, r = ctx.p, ctx.r
    p2r = ctx.ptxt_space
    e, ePrime = rc.e, rc.ePrime
    q = rc.q
    intF = ctxt.intFactor

    # HElib drops to THIN_RECRYPT_NLEVELS=3 of its ~50-bit primes before
    # the first linear map (recryption.cpp:990); with uniform 30-bit
    # primes the equivalent working set is ~6 limbs.
    ct = ctxt.copy()
    ct.drop_special_primes()
    ct.bring_to_k(min(ct.k, 6))

    # slots -> coefficients, then switch onto the sparse recryption key
    # (HElib's thinReCrypt: reLinearize(recryptKeyID), recryption.cpp:990+)
    _boot_trace("slotToCoeff")
    ct = rc.slot_to_coeff.apply(ct, key)
    _boot_trace("relinearize -> recrypt key")
    ct.relinearize(key, to_key=rc.recrypt_key)
    ct.drop_special_primes()
    ct.bring_to_k(min(ct.k, 3))

    # raw mod switch to q = p^e + 1; for composite m, round / make
    # divisible / divide per POWERFUL coordinate, then return to the
    # coefficient representation (HElib's recryption.cpp:475-520)
    _boot_trace("rawModSwitch")
    zz = raw_mod_switch(ct, q, rc.pwb)
    p2ep = p**ePrime
    zz = [make_divisible(z, p2ep, q) for z in zz]
    zz = [z // p2ep for z in zz]
    if rc.pwb is not None:
        zz = [rc.pwb.w_powerful_to_poly(z) for z in zz]
    # zero the non-Phi_m components so the digit-extraction divisions are
    # exact in the mod-X^m-1 representation (see _phim_project)
    zz = [_phim_project(ctx, z, rc.big_space) for z in zz]

    # re-encrypt: ekey * zz1 + zz0
    _boot_trace("re-encrypt with ekey")
    out = rc.ekey.copy()
    out.mul_constant_poly(zz[1], mag=ctx.noise_uniform(math.log2(max(q, 2))))
    out.add_constant_poly(zz[0])

    # coefficients -> slots
    _boot_trace("coeffToSlot")
    out = rc.coeff_to_slot.apply(out, key)

    # digit extraction
    _boot_trace("extractDigitsThin")
    out = extract_digits_thin(out, e - ePrime, r, ePrime, key)
    _boot_trace("done")
    if intF != 1:
        out.intFactor = out.intFactor * intF % out.ptxt_space
    return out


class FatRecryptData(RecryptData):
    """Packed (fat) bootstrapping data (HElib's RecryptData::init,
    recryption.cpp:367-545): firstMap packs coefficients d-per-slot into the
    extension-field slots, secondMap is its inverse, and digit extraction
    runs on intraSlot-unpacked parts."""

    def _build_maps(self):
        ctx, ea = self.ctx, self.ea
        phi, d, n = ctx.phi_m, ea.d, ea.nslots
        assert_true(n * d == phi, 'invariant: n * d == phi')
        if ctx.pal.aligned is not None:
            # scalable fat factor-tree maps (HElib's EvalMap route):
            # firstMap = inverse tree over the big space (powerful coeffs ->
            # packed slots), secondMap = forward tree mod p^r
            from .evalmap import ThinEvalMapTree
            self.first_map = ThinEvalMapTree(self.ea_big, invert=True,
                                             fat=True)
            self.second_map = ThinEvalMapTree(ea, invert=False, fat=True)
        else:
            # dense sigma-span fallback (small m):
            # firstMap (mod big space): X^{t*d+i} -> slot-t unit carrying Y^i
            img_first: dict[int, np.ndarray] = {}
            for t in range(n):
                for i in range(d):
                    slots = [0] * n
                    vec = np.zeros(d, dtype=np.int64)
                    vec[i] = 1
                    slots[t] = vec
                    img_first[t * d + i] = self.ea_big.encode(slots)
            self.first_map = LinearMapR(self.ea_big, img_first)
            # secondMap (mod p^r): slots (packed coeffs) -> coeff vector
            img_second: dict[int, np.ndarray] = {}
            for j in range(phi):
                dec = ea.decode(_onehot_poly(phi, j))
                out = np.zeros(phi, dtype=np.int64)
                for t in range(n):
                    for i in range(d):
                        out[t * d + i] = int(dec[t][i]) % ea.pr
                # L2(X^j) = sum_{t,i} coeff-of-Y^i-in-slot-t(X^j) * X^{t*d+i}
                if np.any(out):
                    img_second[j] = out
            self.second_map = LinearMapR(ea, img_second)
        # intraSlot unpack encodings over the big space
        from .algos.linpoly import projection_maps
        self.unpack_maps = projection_maps(self.ea_big)


def _onehot_poly(n: int, j: int) -> np.ndarray:
    v = np.zeros(n, dtype=np.int64)
    v[j] = 1
    return v


def fat_recrypt(ctxt: Ctxt, rc: FatRecryptData, key: "PubKey | SecKey") -> Ctxt:
    """HElib's PubKey::reCrypt (recryption.cpp:367-545): bootstrap a
    ciphertext with FULLY PACKED slots."""
    ctx = rc.ctx
    ea = rc.ea
    p, r = ctx.p, ctx.r
    e, ePrime = rc.e, rc.ePrime
    q = rc.q
    intF = ctxt.intFactor

    ct = ctxt.copy()
    ct.relinearize(key, to_key=rc.recrypt_key)
    ct.drop_special_primes()
    ct.bring_to_k(min(ct.k, 3))

    # for composite m (tree maps): round / make divisible per POWERFUL
    # coordinate, matching the coordinates firstMap extracts
    zz = raw_mod_switch(ct, q, rc.pwb)
    p2ep = p**ePrime
    zz = [make_divisible(z, p2ep, q) for z in zz]
    zz = [z // p2ep for z in zz]
    if rc.pwb is not None:
        zz = [rc.pwb.w_powerful_to_poly(z) for z in zz]
    zz = [_phim_project(ctx, z, rc.big_space) for z in zz]

    out = rc.ekey.copy()
    out.mul_constant_poly(zz[1], mag=ctx.noise_uniform(math.log2(max(q, 2))))
    out.add_constant_poly(zz[0])

    # coefficients -> packed slots
    out = rc.first_map.apply(out, key)

    # unpack -> digit-extract each -> repack (HElib's extractDigitsPacked,
    # recryption.cpp:550-646)
    from .algos.linpoly import apply_linearized
    parts = [apply_linearized(rc.ea_big, out, cs, key)
             for cs in rc.unpack_maps]
    cleaned = [extract_digits_thin(pt, e - ePrime, r, ePrime, key)
               for pt in parts]
    acc = None
    for i, ci in enumerate(cleaned):
        yi = np.zeros(ea.d, dtype=np.int64)
        yi[i] = 1
        t = ci.copy()
        t.mul_constant_fat(ea.const_fat(yi))
        acc = t if acc is None else acc.add(t)

    # packed slots -> coefficients (restores the original ring element)
    acc = rc.second_map.apply(acc, key)
    if intF != 1:
        acc.intFactor = acc.intFactor * intF % acc.ptxt_space
    return acc


# >0 forces the Chen-Han path, <0 forces the basic path, 0 = cost heuristic
# (HElib's fhe_force_chen_han, recryption.cpp:791)
fhe_force_chen_han = 0


def _use_chen_han(p: int, r: int, bot_high: int) -> bool:
    """Cost heuristic between the basic p-power ladder (digit-extraction
    degree p^r-ish) and the Chen-Han magic polynomials (degree (p-1)*r-ish)
    (HElib's extractDigitsThin, recryption.cpp:810-838)."""
    use = False
    if r > 1:
        chen_han_cost = math.log(p - 1) + math.log(r)
        if p == 2 and r > 2 and bot_high + r > 2:
            basic_cost = (r - 1) * math.log(p)
        else:
            basic_cost = r * math.log(p)
        thresh = 1.75 if p == 2 else 1.5
        if basic_cost > thresh * chen_han_cost:
            use = True
    if fhe_force_chen_han > 0:
        use = True
    elif fhe_force_chen_han < 0:
        use = False
    return use


def extract_digits_thin(ctxt: Ctxt, bot_high: int, r: int, e_prime: int,
                        key: "PubKey | SecKey") -> Ctxt:
    """HElib's extractDigitsThin (recryption.cpp:793): basic p-power
    ladder or Chen-Han extended extraction, chosen by degree cost."""
    ctx = ctxt.ctx
    p = ctx.p
    p2r = p**r
    top_high = bot_high + r - 1
    unpacked = ctxt.copy()
    unpacked.relinearize(key)
    unpacked.drop_special_primes()

    if _use_chen_han(p, r, bot_high):
        from .algos.extract import extend_extract_digits
        scratch = extend_extract_digits(unpacked, key, bot_high, r)
        acc = unpacked
        for j in range(bot_high):
            acc = acc.sub(scratch[j])
            acc.divide_by_p()
        if p == 2 and bot_high > 0:
            acc = acc.add(scratch[bot_high - 1])
        acc.negate()
    else:
        if p == 2 and r > 2 and top_high + 1 > 2:
            top_high -= 1
        scratch = extract_digits(unpacked, key, top_high + 1)
        top_high = min(top_high, len(scratch) - 1)

        acc = scratch[top_high].copy()
        for j in range(top_high - 1, bot_high - 1, -1):
            acc.mult_by_p()
            acc = acc.add(scratch[j])
        if p == 2 and bot_high > 0:
            acc = acc.add(scratch[bot_high - 1])
        acc.negate()
    if r > e_prime:
        top_low = r - 1 - e_prime
        tmp = scratch[top_low].copy()
        for j in range(top_low - 1, -1, -1):
            tmp.mult_by_p()
            tmp = tmp.add(scratch[j])
        if e_prime > 0:
            tmp.mult_by_p(e_prime)
        acc = acc.add(tmp)
    acc.reduce_ptxt_space(p2r)
    return acc
