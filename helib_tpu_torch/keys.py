"""Secret/public keys, RLWE encryption, key-switching matrices
(helib_tpu.keys).

Key generation draws from the host numpy RNG exactly as helib_tpu does, so
`SecKey(ctx, seed)` gives bit-identical secrets, public keys and KS matrices;
only the ring arithmetic runs on `ctx.device`.

  * SecKey: small secret s; decrypt = sum parts[i] * s^{r_i}(X^{t_i}), host
    CRT + balanced reduction at the boundary.
  * PubKey: an encryption of zero (c0, c1) = (-a*s + p*e, a) plus the hybrid
    key-switching matrices: column j of W[s'->s] is
        b_j = -a_j*s + p*e_j + P*B_j*s',   a_j uniform,
    with P = prod(special primes), B_j = prod of full digit products < j,
    and p = 1 under CKKS.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .context import Context, log2_add
from . import dcrt
from .dcrt import (rt_add, rt_sub, rt_mul, rt_mul_scalar, rt_automorph,
                   sample_small_bounded, sample_gaussian_bounded,
                   sample_hwt_bounded,
                   sample_uniform_residues, small_coeffs_to_rt)
from .ops.modops import to_host
from .nt.numbth import inv_mod
from .nt.cyclotomic import cyclotomic_poly
from .exceptions import LogicError


@dataclass(frozen=True)
class SKHandle:
    """Which secret-key monomial s^powS(X^powX) a part multiplies."""
    powS: int = 0
    powX: int = 1
    keyID: int = 0

    @property
    def is_one(self) -> bool:
        return self.powS == 0

    def is_base(self, keyID: int = 0) -> bool:
        return self.powS == 1 and self.powX == 1 and self.keyID == keyID

    def mul(self, other: "SKHandle"):
        """Product handle or None if incompatible."""
        if self.is_one:
            return other
        if other.is_one:
            return self
        if self.keyID != other.keyID or self.powX != other.powX:
            return None
        return SKHandle(self.powS + other.powS, self.powX, self.keyID)


@dataclass
class KSMatrix:
    """Hybrid key-switch matrix W[s'(X^powX)^powS -> s].  The a columns are
    uniform draws of a numpy PRG seeded with `prg_seed`."""
    from_handle: SKHandle
    ptxt_space: int
    b: list            # per column: [L+S, N] eval tensors
    a: list
    noise: float       # log2 bound on |p*e_j| per column
    prg_seed: int | None = None
    to_key: int = 0    # target secret


def regen_ks_a(ctx: Context, prg_seed: int, ncols: int) -> list:
    """The uniform a-columns of a KS matrix, redrawn from its PRG seed."""
    prg = np.random.default_rng(prg_seed)
    return [sample_uniform_residues(ctx, prg, ctx.L, True)
            for _ in range(ncols)]


def matrix_key(handle: SKHandle, to_key: int = 0):
    if handle.keyID == 0 and to_key == 0:
        return (handle.powS, handle.powX)
    return (handle.powS, handle.powX, handle.keyID, to_key)


class SecKey:
    """Secret key(s).  `skeys` is a list of secrets (dicts with `coeffs`,
    `bound`, `full`); keyID 0 is the main key.  hwt > 0 draws a secret of
    that Hamming weight (HElib's skHwt, as the bootstrapping contexts use)."""

    def __init__(self, ctx: Context, seed: int = 0, hwt: int = 0):
        self.ctx = ctx
        self.rng = np.random.default_rng(seed)
        self.skeys: list[dict] = []
        self.matrices: dict = {}
        self.pubkey: PubKey | None = None
        self.gen_key(hwt)

    @classmethod
    def restore(cls, ctx: Context, skeys: list, matrices: dict,
                rng_state: dict | None = None) -> "SecKey":
        """A SecKey from existing state (see convert.py); `rng_state` is a
        numpy bit-generator state, so later keygen continues the same
        stream."""
        sk = cls.__new__(cls)
        sk.ctx = ctx
        sk.rng = np.random.default_rng()
        if rng_state is not None:
            sk.rng.bit_generator.state = rng_state
        sk.skeys = list(skeys)
        sk.matrices = dict(matrices)
        sk.pubkey = None
        return sk

    def gen_key(self, hwt: int = 0) -> int:
        """Sample and append a secret key; returns its keyID."""
        ctx = self.ctx
        if hwt > 0:
            coeffs, bound = sample_hwt_bounded(ctx, self.rng, hwt)
        else:
            coeffs, bound = sample_small_bounded(ctx, self.rng)
        # secret key resident on ALL rows (ctxt + special)
        full = small_coeffs_to_rt(ctx, coeffs, ctx.L, True)
        self.skeys.append({"coeffs": coeffs, "bound": bound, "full": full})
        return len(self.skeys) - 1

    @property
    def s_coeffs(self):
        return self.skeys[0]["coeffs"]

    @property
    def sk_bound(self):
        return self.skeys[0]["bound"]

    @property
    def s_full(self):
        return self.skeys[0]["full"]

    def key_full(self, keyID: int):
        return self.skeys[keyID]["full"]

    # -- raw RLWE instance over all rows ----------------------------------
    def _rlwe_all_rows(self, p_mult: int, a_rng=None, to_key: int = 0):
        """(b, a, log2 noise of p*e) with b = -a*s_{to_key} + p*e over all
        primes; `a_rng` draws the uniform half from a dedicated PRG."""
        ctx = self.ctx
        a = sample_uniform_residues(ctx, a_rng or self.rng, ctx.L, True)
        e_coeffs, _ = sample_gaussian_bounded(ctx, self.rng)
        e = small_coeffs_to_rt(ctx, e_coeffs, ctx.L, True)
        pe = rt_mul_scalar(ctx, e, p_mult, ctx.L, True) if p_mult != 1 else e
        b = rt_sub(ctx, pe, rt_mul(ctx, a, self.key_full(to_key), ctx.L, True),
                   ctx.L, True)
        noise = math.log2(max(p_mult, 1)) + ctx.noise_gaussian()
        return b, a, noise

    # -- key-switching matrix generation ------------------------------------
    def gen_ks_matrix(self, from_handle: SKHandle,
                      ptxt_space: int | None = None,
                      to_key: int = 0) -> KSMatrix:
        key = matrix_key(from_handle, to_key)
        if key in self.matrices:
            return self.matrices[key]
        ctx = self.ctx
        p = 1 if ctx.scheme == "ckks" else (ptxt_space or ctx.ptxt_space)
        # fromKey = s_{keyID}^powS(X^powX) on all rows
        fk = self.key_full(from_handle.keyID)
        if from_handle.powX != 1:
            fk = rt_automorph(ctx, fk, from_handle.powX)
        if from_handle.powS > 1:
            acc = fk
            for _ in range(from_handle.powS - 1):
                acc = rt_mul(ctx, acc, fk, ctx.L, True)
            fk = acc
        P = ctx.prod_special()
        Bj = 1
        prg_seed = int(self.rng.integers(1 << 62))
        prg = np.random.default_rng(prg_seed)
        bs, as_, noise = [], [], 0.0
        for (s, e) in ctx.digits:
            b, a, noise = self._rlwe_all_rows(p, a_rng=prg, to_key=to_key)
            b = rt_add(ctx, b, rt_mul_scalar(ctx, fk, P * Bj, ctx.L, True),
                       ctx.L, True)
            bs.append(b)
            as_.append(a)
            for q in ctx.qs[s:e]:
                Bj *= int(q)
        W = KSMatrix(from_handle, p, bs, as_, noise, prg_seed, to_key)
        self.matrices[key] = W
        return W

    # -- decryption ---------------------------------------------------------
    def _inner_product_residues(self, ctxt):
        """<c, s-monomials> as host per-prime coefficient residues
        ([P, N] uint32, rows) -- the exact RNS value before the CRT."""
        ctx = self.ctx
        k, special = ctxt.k, ctxt.special
        rows = ctx.rows_of(k, special)
        idx = dcrt._rows(ctx, rows)
        acc = None
        for h, data in ctxt.parts:
            term = data
            if not h.is_one:
                s = self.key_full(h.keyID).index_select(-2, idx)
                if h.powX != 1:
                    s = rt_automorph(ctx, s, h.powX)
                pw = s
                for _ in range(h.powS - 1):
                    pw = rt_mul(ctx, pw, s, k, special)
                term = rt_mul(ctx, data, pw, k, special)
            acc = term if acc is None else rt_add(ctx, acc, term, k, special)
        return to_host(ctx.inv_ntt(acc, rows)), rows

    def decrypt_raw(self, ctxt) -> np.ndarray:
        """<c, s-monomials> -> balanced integer coefficient vector (host)."""
        coeff_res, rows = self._inner_product_residues(ctxt)
        return dcrt.crt_reconstruct(self.ctx, coeff_res, rows, balanced=True)

    def decrypt_bgv(self, ctxt) -> np.ndarray:
        """Full BGV decrypt -> plaintext poly coeffs mod the ciphertext's
        plaintext space, degree < phi(m)."""
        ctx = self.ctx
        pr = ctxt.ptxt_space
        coeff_res, rows = self._inner_product_residues(ctxt)
        from .nt.native import combiner_for
        comb = combiner_for([int(q) for q in ctx.all_q[np.array(rows)]])
        if comb is not None:
            vals_pr = comb.balanced_mod(coeff_res, pr)
        else:
            vals = dcrt.crt_reconstruct(ctx, coeff_res, rows, balanced=True)
            vals_pr = np.array([int(v) % pr for v in vals], dtype=np.int64)
        red = reduce_mod_phim(vals_pr, ctx, pr)
        Q = 1
        for q in ctx.primes_of(ctxt.k, ctxt.special):
            Q *= int(q)
        f = (Q % pr) * ctxt.intFactor % pr
        return (red * inv_mod(f, pr)) % pr


def reduce_mod_phim(coeffs: np.ndarray, ctx: Context, modulus: int) -> np.ndarray:
    """Reduce a poly of degree < N mod Phi_m(X) mod `modulus` (host).  For
    odd m the mod-(X^m - 1) representative is divided by Phi_m here."""
    if ctx.pal.pow2:
        return coeffs % modulus
    phi = ctx.phi_m
    phim = np.array([int(c) % modulus for c in cyclotomic_poly(ctx.m)],
                    dtype=np.int64)
    work = coeffs.astype(np.int64) % modulus
    # synthetic division: leading coeff of Phi_m is 1
    for i in range(len(work) - 1, phi - 1, -1):
        c = work[i] % modulus
        if c:
            work[i - phi:i + 1] = (work[i - phi:i + 1] - c * phim) % modulus
    return work[:phi] % modulus


class PubKey:
    """Public evaluation key: an encryption of zero + the key-switching
    matrices, which it shares with the generating SecKey's dict."""

    def __init__(self, sk: SecKey):
        self.ctx = ctx = sk.ctx
        sk.pubkey = self
        self.matrices = sk.matrices
        b, a, noise = sk._rlwe_all_rows(
            ctx.ptxt_space if ctx.scheme == "bgv" else 1)
        self.enc_key = [(SKHandle(0, 1, 0), b[:ctx.L]),
                        (SKHandle(1, 1, 0), a[:ctx.L])]
        self.enc_noise = noise
        self.sk_bound = sk.sk_bound

    @classmethod
    def restore(cls, ctx: Context, enc_key: list, enc_noise: float,
                sk_bound: float, matrices: dict) -> "PubKey":
        """A PubKey from existing state (see convert.py)."""
        pk = cls.__new__(cls)
        pk.ctx, pk.enc_key, pk.enc_noise = ctx, enc_key, enc_noise
        pk.sk_bound, pk.matrices = sk_bound, matrices
        return pk

    def encrypt_bgv(self, ptxt_coeffs: np.ndarray, rng: np.random.Generator):
        """Public-key BGV encryption with host-sampled randomness.
        ptxt_coeffs: int coeffs (deg < phi(m)) mod p^r.  Returns a Ctxt."""
        from .ctxt import Ctxt
        ctx = self.ctx
        pr = ctx.ptxt_space
        k, special = ctx.L, False
        r_coeffs, r_bound = sample_small_bounded(ctx, rng)
        r = small_coeffs_to_rt(ctx, r_coeffs, k, special)
        noise = r_bound + self.enc_noise
        parts = []
        for i, (handle, data) in enumerate(self.enc_key):
            part = rt_mul(ctx, data, r, k, special)
            e_coeffs, _ = sample_gaussian_bounded(ctx, rng)
            pe = small_coeffs_to_rt(ctx, e_coeffs * pr, k, special)
            part = rt_add(ctx, part, pe, k, special)
            e_bound = math.log2(pr) + ctx.noise_gaussian()
            if i == 1:
                e_bound += self.sk_bound
            noise = log2_add(noise, e_bound)
            parts.append((handle, part))
        # ptxt * [Q]_p, balanced mod p^r
        qmodp = ctx.prod_qs(k) % pr
        fixed = (np.asarray(ptxt_coeffs, dtype=np.int64) * qmodp) % pr
        fixed -= (fixed > pr // 2) * pr
        pt = small_coeffs_to_rt(ctx, fixed, k, special)
        parts[0] = (parts[0][0], rt_add(ctx, parts[0][1], pt, k, special))
        noise = log2_add(noise, ctx.noise_mod(pr))
        return Ctxt(ctx=ctx, pubkey=self, parts=parts, k=k, special=special,
                    ptxt_space=pr, noise=noise, intFactor=1)


def balanced_int(v: int, m: int) -> int:
    v %= m
    return v - m if v > m // 2 else v


# ---------------------------------------------------------------------------
# evaluation-key lookup
# ---------------------------------------------------------------------------

def find_ks_matrix(key, handle: SKHandle, to_key: int = 0):
    """W[handle -> s_{to_key}] from an evaluation key, or None."""
    return key.matrices.get(matrix_key(handle, to_key))


def get_ks_matrix(key, handle: SKHandle, to_key: int = 0) -> KSMatrix:
    """A key-switching matrix for evaluation: present -> returned; absent on
    a SecKey -> generated on demand with a one-time warning; absent on a
    PubKey -> LogicError."""
    W = find_ks_matrix(key, handle, to_key)
    if W is not None:
        return W
    if isinstance(key, SecKey):
        from .log import warning
        warning(f"KS matrix for {handle} (to_key={to_key}) missing — "
                "generating from the secret key on demand", once=True)
        return key.gen_ks_matrix(handle, to_key=to_key)
    raise LogicError(
        f"no key-switching matrix for {handle} (to_key={to_key}) on this "
        "evaluation key; generate it at keygen time via "
        "SecKey.gen_ks_matrix")
