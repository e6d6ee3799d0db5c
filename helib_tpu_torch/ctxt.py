"""BGV and CKKS ciphertexts with noise bookkeeping (helib_tpu.ctxt).

The noise state machine follows helib_tpu's formulas exactly; magnitudes are
log2-domain Python floats, the CKKS scale `ratFactor` an exact Fraction.
Parts are [..., P, N] tensors, so one Ctxt can carry a batch of ciphertexts
in its leading dims.  `copy()` shares the part tensors, so every op builds
new tensors and none writes into a part in place.  Constants come as host
coefficient vectors, EncodedPtxt or device-resident FatEncodedPtxt
(encoded.py).  The bootstrapping helpers (trace_map, divide_by_p,
mult_by_p, extract_bits, reduce_ptxt_space) are here too.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from .context import Context, log2_add, log2_sum, NEG_INF
from .dcrt import (rt_add, rt_neg, rt_mul, rt_mul_scalar, rt_automorph,
                   rt_scale_down, rt_add_special_and_scale,
                   rt_break_into_digits, small_coeffs_to_rt)
from .keys import SKHandle, PubKey, KSMatrix, balanced_int, get_ks_matrix
from .ops.modops import mul_mod, add_mod, mul_mod_shoup, shoup, to_device
from .nt.numbth import inv_mod
from .exceptions import InvalidArgument, LogicError, OutOfRangeError

SAFETY_BITS = 1.0   # reference `safety` margin (log 2) in interval selection


def ks_stacked_W(W: KSMatrix, rows: tuple):
    """KS matrix columns restricted to the live rows and stacked over the
    digit axis ([nd, R, N] each), cached per prime set on the matrix."""
    cache = W.__dict__.setdefault("_stacked", {})
    ent = cache.get(rows)
    if ent is None:
        idx = torch.tensor(rows, dtype=torch.int64, device=W.b[0].device)
        ent = cache[rows] = (torch.stack([b.index_select(-2, idx)
                                          for b in W.b]),
                             torch.stack([a.index_select(-2, idx)
                                          for a in W.a]))
    return ent


def ks_digit_mac(ctx: Context, digits, W: KSMatrix, k: int, own=None):
    """sum_j digit_j * (b_j, a_j) as two stacked modular multiplies and a
    fold over the digit axis (the KS MAC hot loop); `own` (ctxt rows, as in
    Context.rows_of): the digits hold only those rows and the specials."""
    nd = len(digits)
    Wb, Wa = ks_stacked_W(W, ctx.rows_of(k, True, own))
    q, mu = ctx.dev_q(k, True, own)
    D = torch.stack(digits, dim=-3)            # [..., nd, R, N]
    pb = mul_mod(D, Wb[:nd], q, mu)
    pa = mul_mod(D, Wa[:nd], q, mu)
    sb, sa = pb[..., 0, :, :], pa[..., 0, :, :]
    for j in range(1, nd):
        sb = add_mod(sb, pb[..., j, :, :], q)
        sa = add_mod(sa, pa[..., j, :, :], q)
    return sb, sa


def frac_log2(f) -> float:
    """log2 of a positive Fraction/int without float overflow."""
    f = Fraction(f)
    n, d = f.numerator, f.denominator
    return ((n.bit_length() - 1) + math.log2(n / (1 << (n.bit_length() - 1)))
            - ((d.bit_length() - 1)
               + math.log2(d / (1 << (d.bit_length() - 1)))))


@dataclass
class Ctxt:
    ctx: Context
    pubkey: PubKey
    parts: list                 # [(SKHandle, tensor [..., P, N])]
    k: int                      # live ctxt-prime prefix length
    special: bool               # special primes included?
    ptxt_space: int
    noise: float                # log2 canonical-embedding noise bound
    intFactor: int = 1
    ratFactor: object = 1       # CKKS scale (exact Fraction/int)
    ptxtMag: float = 1.0        # CKKS bound on |plaintext| (linear)
    # None, or the limb shard of one rank of a ("batch", "limb") mesh
    # (parallel/mesh.py LimbShard): the parts hold only the ctxt rows
    # `shard.own` and the specials.  tensor, relinearize, automorph and
    # drop_special_primes run on it; other ops expect every row.
    shard: object = None

    # ------------------------------------------------------------------ utils
    def copy(self) -> "Ctxt":
        return Ctxt(self.ctx, self.pubkey, list(self.parts), self.k,
                    self.special, self.ptxt_space, self.noise, self.intFactor,
                    self.ratFactor, self.ptxtMag, self.shard)

    @property
    def own(self):
        """The ctxt rows the parts hold (None: all k)."""
        return None if self.shard is None else self.shard.own

    @property
    def is_ckks(self) -> bool:
        return self.ctx.scheme == "ckks"

    def log2_modulus(self) -> float:
        v = self.ctx.log2_q(self.k)
        if self.special:
            v += self.ctx.log2_special()
        return v

    def capacity(self) -> float:
        """log2(Q/noise)."""
        return self.log2_modulus() - self.noise

    def is_correct(self) -> bool:
        return self.capacity() > 1.0

    def error_bound(self) -> float:
        """CKKS: bound on |decrypted - plaintext| in plaintext units
        = noise bound / ratFactor, linear domain."""
        return 2.0 ** (self.noise - frac_log2(self.ratFactor))

    def _find_part(self, handle: SKHandle) -> int:
        for i, (h, _) in enumerate(self.parts):
            if h == handle:
                return i
        return -1

    def mod_switch_added_noise(self) -> float:
        """Reference Ctxt::modSwitchAddedNoiseBound."""
        acc = NEG_INF
        for h, _ in self.parts:
            if h.is_one:
                acc = log2_add(acc, 0.0)
            else:
                acc = log2_add(acc, h.powS * self.pubkey.sk_bound)
        ps = 1 if self.is_ckks else self.ptxt_space
        return acc + self.ctx.noise_uniform(math.log2(ps / 2.0))

    # ------------------------------------------------------- mod switching
    def mod_down_to(self, new_k: int, new_special: bool,
                    measure: bool = True):
        """Real modulus switching down (reference Ctxt::modDownToSet).

        measure=True (the eager default, as in helib_tpu) also measures the
        BGV mod-switch rounding noise from the scale-down remainder: one
        host transfer and FFT per part, of the first batch element.
        Pipelines pass measure=False, which is what helib_tpu does under a
        jit trace; HELIB_EXACT_MODSWITCH=0 turns it off everywhere (the
        worst-case bound alone), as in helib_tpu.  CKKS is never measured,
        as in helib_tpu; its scale ratFactor is divided by the dropped
        primes."""
        if new_k > self.k:
            raise OutOfRangeError(
                f"mod_down_to: target level {new_k} above current {self.k}")
        if new_k == self.k and new_special == self.special:
            return
        added = self.mod_switch_added_noise()
        drop_bits = self.log2_modulus()
        ps = 1 if self.is_ckks else self.ptxt_space
        measure = (measure and not self.is_ckks
                   and os.environ.get("HELIB_EXACT_MODSWITCH", "") != "0")
        dropped = set(self.ctx.rows_of(self.k, self.special)) - set(
            self.ctx.rows_of(new_k, new_special))
        new_parts, fracs = [], []
        for h, data in self.parts:
            out = rt_scale_down(self.ctx, data, self.k, self.special, new_k,
                                new_special, ps, want_frac=measure,
                                own=self.own)
            if measure:
                out, frac = out
                fracs.append((h, frac))
            new_parts.append((h, out))
        if measure:
            from .norms import embedding_largest_float_log2
            measured = NEG_INF
            for h, frac in fracs:
                fr = frac.cpu().numpy()
                if fr.ndim > 1:
                    fr = fr.reshape(-1, fr.shape[-1])[0]
                if not np.any(fr):
                    continue
                norm = embedding_largest_float_log2(fr, self.ctx.m,
                                                    self.ctx.pal.pow2)
                bound = norm + (h.powS * self.pubkey.sk_bound
                                if not h.is_one else 0.0)
                measured = log2_add(measured, bound)
            if measured > NEG_INF:
                added = min(added, measured)
        self.parts = new_parts
        self.k, self.special = new_k, new_special
        drop_bits -= self.log2_modulus()
        self.noise = log2_add(self.noise - drop_bits, added)
        if self.is_ckks:
            D = 1
            for r in dropped:
                D *= int(self.ctx.all_q[r])
            self.ratFactor = Fraction(self.ratFactor) / D

    def drop_special_primes(self, measure: bool = True):
        if self.special:
            self.mod_down_to(self.k, False, measure)

    def bring_to_k(self, new_k: int):
        self.drop_special_primes()
        if new_k < self.k:
            self.mod_down_to(new_k, False)

    def natural_k(self) -> int:
        """Prefix k' targeting log2(q') ~ capacity + mod-switch added noise
        (role of reference naturalPrimeSet): for BGV rounded down, for CKKS
        rounded up (keeps accuracy)."""
        target = (self.capacity() + self.mod_switch_added_noise()
                  + (self.ctx.log2_special() if self.special else 0.0))
        if self.is_ckks:
            target += SAFETY_BITS
            k = self.k
            while k > 1 and self.ctx.log2_q(k - 1) >= target:
                k -= 1
            return k
        target -= SAFETY_BITS
        k = self.k
        while k > 1 and self.ctx.log2_q(k) > target:
            k -= 1
        return k

    # ------------------------------------------------------------- addition
    def _match_factors(self, other: "Ctxt"):
        """Equalize intFactor by scaling self (reference addCtxt)."""
        if (self.is_ckks or self.ptxt_space <= 2
                or self.intFactor == other.intFactor):
            return
        pr = self.ptxt_space
        lam = balanced_int(other.intFactor * inv_mod(self.intFactor, pr), pr)
        self.parts = [(h, rt_mul_scalar(self.ctx, d, lam % pr, self.k,
                                        self.special))
                      for h, d in self.parts]
        self.noise += math.log2(max(abs(lam), 1))
        self.intFactor = other.intFactor

    def add(self, other: "Ctxt", sub: bool = False):
        a, b = self, other.copy()
        tk = min(a.k, b.k)
        tsp = a.special and b.special
        if (a.k, a.special) != (tk, tsp):
            a.mod_down_to(tk, tsp)
        if (b.k, b.special) != (tk, tsp):
            b.mod_down_to(tk, tsp)
        if a.is_ckks:
            _align_ckks_factors(a, b)
        elif a.ptxt_space != b.ptxt_space:
            g = math.gcd(a.ptxt_space, b.ptxt_space)
            a.ptxt_space = b.ptxt_space = g
        a._match_factors(b)
        for h, d in b.parts:
            if sub:
                d = rt_neg(a.ctx, d, a.k, a.special)
            i = a._find_part(h)
            if i >= 0:
                a.parts[i] = (h, rt_add(a.ctx, a.parts[i][1], d, a.k,
                                        a.special))
            else:
                a.parts.append((h, d))
        a.noise = log2_add(a.noise, b.noise)
        return a

    def sub(self, other: "Ctxt"):
        return self.add(other, sub=True)

    def negate(self):
        self.parts = [(h, rt_neg(self.ctx, d, self.k, self.special))
                      for h, d in self.parts]
        return self

    # ------------------------------------------------------------ constants
    def mul_by_constant(self, c, mag: float | None = None):
        """Constant multiply (HElib's Ctxt::multByConstant overloads):
        an EncodedPtxt (host encoding), a FatEncodedPtxt (device-resident,
        sliced per prime set), or a bare coefficient vector.  `mag`, if
        given, is the log2 noise growth to charge instead of the BGV
        bound."""
        from .encoded import EncodedPtxt, FatEncodedPtxt
        if isinstance(c, FatEncodedPtxt):
            return self.mul_constant_fat(c, mag)
        if isinstance(c, EncodedPtxt):
            return self.mul_constant_poly(c.coeffs, mag)
        return self.mul_constant_poly(c, mag)

    def add_constant(self, c):
        """Constant add (HElib's Ctxt::addConstant overloads)."""
        from .encoded import EncodedPtxt, FatEncodedPtxt
        if isinstance(c, FatEncodedPtxt):
            return self.add_constant_fat(c)
        if isinstance(c, EncodedPtxt):
            return self.add_constant_poly(c.coeffs)
        return self.add_constant_poly(c)

    def _q_factor(self) -> int:
        """(Q mod p^r) * intFactor mod p^r over the live prime set: the
        factor a plaintext added to part 0 is scaled by."""
        pr, Q = self.ptxt_space, 1
        for q in self.ctx.primes_of(self.k, self.special):
            Q *= int(q)
        return (Q % pr) * self.intFactor % pr

    def add_constant_poly(self, coeffs: np.ndarray):
        """Add an encoded plaintext polynomial (BGV; HElib's
        Ctxt::addConstant).  coeffs: int vector mod p^r, deg < phi(m)."""
        ctx, pr = self.ctx, self.ptxt_space
        fixed = (np.asarray(coeffs, dtype=np.int64) * self._q_factor()) % pr
        fixed -= (fixed > pr // 2) * pr
        pt = small_coeffs_to_rt(ctx, fixed, self.k, self.special)
        i = self._find_part(SKHandle(0, 1, 0))
        self.parts[i] = (self.parts[i][0],
                         rt_add(ctx, self.parts[i][1], pt, self.k,
                                self.special))
        self.noise = log2_add(self.noise, ctx.noise_mod(pr))

    def mul_constant_poly(self, coeffs: np.ndarray,
                          mag: float | None = None):
        """Multiply by an encoded plaintext poly (balanced lift mod p^r)."""
        ctx, pr = self.ctx, self.ptxt_space
        fixed = np.asarray(coeffs, dtype=np.int64) % pr
        fixed -= (fixed > pr // 2) * pr
        pt = small_coeffs_to_rt(ctx, fixed, self.k, self.special)
        self.parts = [(h, rt_mul(ctx, d, pt, self.k, self.special))
                      for h, d in self.parts]
        self.noise += mag if mag is not None else ctx.noise_mod(pr)

    def mul_constant_fat(self, fat, mag: float | None = None):
        """Multiply by a device-resident encoded constant (HElib's
        Ctxt::multByConstant(FatEncodedPtxt)): no host encode or transform
        here -- the eval tensor is sliced from the constant's full-row
        transform (encoded.FatEncodedPtxt)."""
        ctx = self.ctx
        pt = fat.rt(self.k, self.special)
        self.parts = [(h, rt_mul(ctx, d, pt, self.k, self.special))
                      for h, d in self.parts]
        space = fat.space if fat.space is not None else self.ptxt_space
        self.noise += mag if mag is not None else ctx.noise_mod(space)

    def add_constant_fat(self, fat):
        """Add a device-resident encoded constant (BGV).  The Q*intFactor
        correction of add_constant_poly depends on the live prime set, so it
        is applied as a scalar multiply of the sliced constant: with no
        rebalance mod p^r, the |f| growth is charged to the noise (f == 1
        for p = 2)."""
        ctx, pr = self.ctx, self.ptxt_space
        pt = fat.rt(self.k, self.special)
        f = self._q_factor()
        f = f - pr if f > pr // 2 else f
        if f != 1:
            pt = rt_mul_scalar(ctx, pt, f % pr, self.k, self.special)
        i = self._find_part(SKHandle(0, 1, 0))
        self.parts[i] = (self.parts[i][0],
                         rt_add(ctx, self.parts[i][1], pt, self.k,
                                self.special))
        self.noise = log2_add(self.noise,
                              ctx.noise_mod(pr) + math.log2(max(abs(f), 1)))

    # -------------------------------------------------------- multiplication
    def tensor(self, other: "Ctxt"):
        """Tensor product (reference Ctxt::tensorProduct)."""
        ctx = self.ctx
        if (self.k, self.special) != (other.k, other.special):
            raise LogicError("tensor: operands on different prime sets; "
                             "bring_to_k first")
        k, sp, own = self.k, self.special, self.own
        pr = math.gcd(self.ptxt_space, other.ptxt_space)
        out_parts: list = []

        def add_part(h, d):
            for i, (h2, d2) in enumerate(out_parts):
                if h2 == h:
                    out_parts[i] = (h2, rt_add(ctx, d2, d, k, sp, own))
                    return
            out_parts.append((h, d))

        for h1, d1 in self.parts:
            for h2, d2 in other.parts:
                h = h1.mul(h2)
                if h is None:
                    raise LogicError("incompatible part handles in tensor")
                add_part(h, rt_mul(ctx, d1, d2, k, sp, own))
        intF = 1
        if self.is_ckks:
            f1, f2 = Fraction(self.ratFactor), Fraction(other.ratFactor)
            m1, m2 = self.ptxtMag, other.ptxtMag
            noise = log2_sum([
                self.noise + math.log2(m2) + frac_log2(f2) if m2 > 0
                else NEG_INF,
                other.noise + math.log2(m1) + frac_log2(f1) if m1 > 0
                else NEG_INF,
                self.noise + other.noise])
            return Ctxt(ctx, self.pubkey, out_parts, k, sp, 1, noise, 1,
                        f1 * f2, m1 * m2)
        if pr > 2:
            Q = 1
            for q in ctx.primes_of(k, sp):
                Q *= int(q)
            intF = self.intFactor * other.intFactor % pr
            intF = intF * (Q % pr) % pr
        return Ctxt(ctx, self.pubkey, out_parts, k, sp, pr,
                    self.noise + other.noise, intF, shard=self.shard)

    def mul_low_level(self, other: "Ctxt") -> "Ctxt":
        """multLowLvl: equalize the prime sets near the natural level and
        tensor.  BGV takes the lower of the two natural levels; CKKS the
        higher, clamped to what both operands still have."""
        a, b = self.copy(), other.copy()
        a.drop_special_primes()
        b.drop_special_primes()
        if self.is_ckks:
            tk = min(a.k, b.k, max(a.natural_k(), b.natural_k()))
        else:
            tk = min(a.natural_k(), b.natural_k())
        a.bring_to_k(tk)
        b.bring_to_k(tk)
        return a.tensor(b)

    def multiply(self, other: "Ctxt", key) -> "Ctxt":
        """key: a PubKey or SecKey holding the relinearization matrix."""
        out = self.mul_low_level(other)
        out.relinearize(key)
        return out

    def square(self, key) -> "Ctxt":
        return self.multiply(self, key)

    # ------------------------------------------------------- key switching
    def relinearize(self, key, to_key: int = 0):
        """Reference Ctxt::reLinearize: mod-up by the special primes,
        key-switch every non-canonical part, leave the specials in."""
        ctx = self.ctx
        if all(h.is_one or h.is_base(to_key) for h, _ in self.parts):
            return self
        self.drop_special_primes()
        k, own = self.k, self.own
        gather = None if self.shard is None else self.shard.gather
        new_noise = self.noise + ctx.log2_special()
        acc: dict = {}

        def add_acc(h, d):
            acc[h] = rt_add(ctx, acc[h], d, k, True, own) if h in acc else d

        ks_noise = NEG_INF
        for h, d in self.parts:
            if h.is_one or h.is_base(to_key):
                add_acc(h, rt_add_special_and_scale(ctx, d, k, own))
                continue
            W = get_ks_matrix(key, h, to_key=to_key)
            if W.ptxt_space > 1 and self.ptxt_space > 1:
                self.ptxt_space = math.gcd(W.ptxt_space, self.ptxt_space)
            digits, digit_noise = rt_break_into_digits(ctx, d, k, own, gather)
            sb, sa = ks_digit_mac(ctx, digits, W, k, own)
            add_acc(SKHandle(0, 1, 0), sb)
            add_acc(SKHandle(1, 1, to_key), sa)
            ks_noise = log2_add(ks_noise, digit_noise + W.noise)
        self.parts = list(acc.items())
        self.k, self.special = k, True
        from .timing import stats_update
        if ks_noise > new_noise:
            from .log import warning
            warning(f"KS-noise-ratio={2.0**(ks_noise - new_noise):.2f}",
                    once=True)
        stats_update("KS-noise-ratio", 2.0 ** min(ks_noise - new_noise, 64.0))
        self.noise = log2_add(new_noise, ks_noise)
        if self.is_ckks:
            self.ratFactor = Fraction(self.ratFactor) * ctx.prod_special()
        return self

    # -------------------------------------------------------- automorphism
    def automorph(self, kexp: int):
        """X -> X^kexp on every part (reference Ctxt::automorph)."""
        ctx = self.ctx
        ordm = 2 * ctx.n_eval if ctx.pal.pow2 else ctx.m
        kexp %= ordm
        self.parts = [
            (h if h.is_one else SKHandle(h.powS, h.powX * kexp % ordm,
                                         h.keyID), rt_automorph(ctx, d, kexp))
            for h, d in self.parts]
        return self

    def smart_automorph(self, kexp: int, key):
        """automorph + key switch back to (1, s); without an exact matrix
        the hop chain through the key's matrices (ksstrategy.hop_path) is
        taken.  `key`: PubKey or SecKey; a SecKey mints a missing matrix."""
        self.relinearize(key)   # canonical (1, s) form first
        kexp %= self.ctx.m
        if kexp == 1:
            return self
        from .dryrun import note_automorph
        note_automorph(kexp)
        if (1, kexp) not in key.matrices:
            from .ksstrategy import hop_path
            path = hop_path(key, kexp)
            if path:
                for a in path:
                    self.automorph(a)
                    self.relinearize(key)
                return self
        self.automorph(kexp)
        self.relinearize(key)
        return self

    def frobenius(self, j: int, key):
        """X -> X^(p^j) (reference Ctxt::frobeniusAutomorph)."""
        return self.smart_automorph(pow(self.ctx.p, j, self.ctx.m), key)

    def conjugate(self, key):
        """CKKS complex conjugation: X -> X^(m-1)."""
        return self.smart_automorph(self.ctx.m - 1, key)

    # ------------------------------------------------- bootstrapping helpers
    def trace_map(self, key):
        """Trace over the slot extension, sum_{i<d} sigma_{p^i}: leaves a
        constant in every slot (HElib's traceMap, used by ThinEvalMap's
        apply, EvalMap.cpp:658).  For d > 3 the d-1 Frobenius maps share
        one key-switch digit decomposition (algos/hoisting.py): one
        decomposition and d-1 MAC sets instead of d-1 relinearizations."""
        d = self.ctx.pal.d
        p, m = self.ctx.p, self.ctx.m
        if d > 3:
            from .algos.hoisting import AutomorphPrecon
            precon = AutomorphPrecon(self, key)
            acc = None
            for i in range(1, d):
                t = precon.automorph(pow(p, i, m))
                acc = t if acc is None else acc.add(t)
            acc = acc.add(precon.base)
        else:
            acc = self
            frob = self
            for _ in range(1, d):
                frob = frob.copy().frobenius(1, key)
                acc = acc.copy().add(frob)
        if acc is not self:
            self.parts = acc.parts
            self.k, self.special = acc.k, acc.special
            self.noise = acc.noise
            self.ptxt_space = acc.ptxt_space
            self.intFactor = acc.intFactor
        return self

    def divide_by_p(self):
        """Divide the plaintext by p (it must be divisible); plaintext space
        p^r -> p^(r-1) (HElib's Ctxt::divideByP, Ctxt.h:1212)."""
        ctx = self.ctx
        p = ctx.p
        if self.ptxt_space % p or self.ptxt_space <= p:
            raise InvalidArgument(
                f"divide_by_p: plaintext space {self.ptxt_space} not a "
                f"proper multiple of p={p}")

        def build():
            qs = ctx.primes_of(self.k, self.special).astype(np.uint64)
            inv = np.array([pow(p, -1, int(q)) for q in qs],
                           dtype=np.uint32)[:, None]
            return (to_device(inv, ctx.device),
                    to_device(shoup(inv, qs[:, None]), ctx.device))
        inv, ish = ctx.cached(("inv_p", self.k, self.special), build)
        q, _ = ctx.dev_q(self.k, self.special)
        self.parts = [(h, mul_mod_shoup(d, inv, ish, q))
                      for h, d in self.parts]
        self.ptxt_space //= p
        self.noise -= math.log2(p)
        self.intFactor %= self.ptxt_space

    def mult_by_p(self, count: int = 1):
        """Multiply the plaintext by p^count (HElib's multByP)."""
        p = self.ctx.p ** count
        self.parts = [(h, rt_mul_scalar(self.ctx, d, p, self.k, self.special))
                      for h, d in self.parts]
        self.ptxt_space *= p
        self.noise += math.log2(p)

    def extract_bits(self, key, n_bits: int = 0) -> list:
        """Ciphertexts of the base-p digits (bits for p = 2) of the slot
        values (HElib's Ctxt::extractBits, Ctxt.h:1225, an alias of
        extractDigits).  At odd composite m (prime powers p'^k included,
        whose cofactor (X^m-1)/Phi_m has degree > 1) the input is first
        multiplied by the Phi_m idempotent (nt.numbth.phim_idempotent), so
        the ladder's divide_by_p is exact in the mod-(X^m - 1)
        representation; at prime m the one junk component (the value at
        X = 1) follows the same digit arithmetic, and power-of-2 m has
        none."""
        from .algos.extract import extract_digits
        from .nt.numbth import is_prime, phim_idempotent
        src = self
        if not self.ctx.pal.pow2 and not is_prime(self.ctx.m):
            src = self.copy()
            src.mul_constant_poly(phim_idempotent(self.ctx.m,
                                                  self.ptxt_space))
        return extract_digits(src, key, n_bits if n_bits > 0 else None)

    def reduce_ptxt_space(self, new_space: int):
        """Reduce the plaintext space to gcd(space, new_space) (HElib's
        reducePtxtSpace)."""
        g = math.gcd(self.ptxt_space, new_space)
        if g <= 1:
            raise InvalidArgument(f"reduce_ptxt_space: gcd({self.ptxt_space}"
                                  f", {new_space}) is trivial")
        self.ptxt_space = g
        self.intFactor %= g
        return self


def _align_ckks_factors(a: Ctxt, b: Ctxt):
    """Equalize CKKS scales before addition: scale the smaller-scale
    ciphertext by the nearest integer ratio and charge the residual
    mismatch to its noise."""
    fa, fb = Fraction(a.ratFactor), Fraction(b.ratFactor)
    if fa == fb:
        return
    if fa < fb:
        _align_ckks_factors(b, a)
        return
    n = int(fa / fb + Fraction(1, 2))
    if n > 1:
        b.parts = [(h, rt_mul_scalar(b.ctx, d, n, b.k, b.special))
                   for h, d in b.parts]
        b.noise += math.log2(n)
        fb = fb * n
    gap = abs(fa - fb)
    if gap > 0 and b.ptxtMag > 0:
        b.noise = log2_add(b.noise, math.log2(b.ptxtMag) + frac_log2(gap))
    b.ratFactor = fa
    a.ratFactor = fa
