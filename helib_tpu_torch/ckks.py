"""CKKS approximate-numbers scheme: encoding, encryption, decryption,
rescaling, rotations (helib_tpu.ckks, EncryptedArrayCKKS).

Complex slots via the canonical embedding on power-of-2 cyclotomics, with
explicit scaling factors.  Slot j <-> evaluation at zeta^(5^j mod m),
j = 0 .. nslots-1 (nslots = phi(m)/2); the conjugate evaluations carry
conj(z_j) so the coefficient vector is real.  Encoding, decoding and the
decryption noise run on the host in numpy, exactly as helib_tpu does, so
ciphertexts and decrypted values are bit-identical for the same seeds.
Rotating by one slot is the automorphism X -> X^(5^-1); `shift` masks then
rotates, and the real and imaginary parts come from the conjugation
X -> X^(m-1) (Ctxt.conjugate), all through Ctxt.smart_automorph's key
switching.
"""

from __future__ import annotations

import hashlib
import math
import sys
from fractions import Fraction

import numpy as np

from .context import Context, log2_add
from .exceptions import InvalidArgument
from .keys import SecKey, PubKey
from .ctxt import Ctxt, frac_log2
from . import dcrt
from .dcrt import rt_mul, rt_add, sample_small, sample_gaussian, \
    small_coeffs_to_rt
from .nt.numbth import inv_mod


def _decimal(f) -> str:
    """str(f) of a Fraction or int, past Python's 4300-digit limit on
    int-to-str conversion: the scale of a deep squaring ladder reaches it
    (examples/04_ckks_depth.py at level 10), where helib_tpu's
    str(ratFactor) raises; below it, the same text."""
    limit = sys.get_int_max_str_digits()
    sys.set_int_max_str_digits(0)
    try:
        return str(f)
    finally:
        sys.set_int_max_str_digits(limit)


class EncryptedArrayCKKS:
    def __init__(self, ctx: Context):
        if ctx.scheme != "ckks" or not ctx.pal.pow2:
            raise InvalidArgument(
                "EncryptedArrayCKKS requires a power-of-2-m CKKS context")
        self.ctx = ctx
        self.N = ctx.n_eval                       # phi(m)
        self.m = ctx.m
        self.nslots = self.N // 2
        # slot j <-> exponent e_j = 5^j mod m (odd); DFT index (e_j - 1)/2
        e = 1
        exps = []
        for _ in range(self.nslots):
            e = e * 5 % self.m
            exps.append(e)
        self.slot_exp = np.array([1] + exps[:-1], dtype=np.int64)
        self.dft_idx = (self.slot_exp - 1) // 2

    # ---------------------------------------------------------- embedding
    def embed(self, coeffs: np.ndarray) -> np.ndarray:
        """Real coeff vector [N] -> complex slot values [nslots]
        (evaluate at zeta^{e_j}, zeta = exp(i*pi/N))."""
        N = self.N
        zeta = np.exp(1j * np.pi / N)
        b = coeffs.astype(np.complex128) * zeta ** np.arange(N)
        F = np.fft.ifft(b) * N          # F[t] = sum_l b_l e^{+2pi i tl/N}
        return F[self.dft_idx]

    def unembed(self, slots: np.ndarray) -> np.ndarray:
        """Complex slots [nslots] -> real coeff vector [N] (exact inverse of
        embed on the conjugate-symmetric subspace)."""
        N = self.N
        F = np.zeros(N, dtype=np.complex128)
        F[self.dft_idx] = np.asarray(slots, dtype=np.complex128)
        F[(N - 1) - self.dft_idx] = np.conj(slots)
        b = np.fft.fft(F) / N
        zeta = np.exp(1j * np.pi / N)
        return np.real(b * zeta ** (-np.arange(N)))

    # ------------------------------------------------------------ encode
    def encode(self, slots, scale: int | None = None):
        """-> (int coeffs [N] (object), scale, mag, rounding-noise log2)."""
        z = np.zeros(self.nslots, dtype=np.complex128)
        s = np.asarray(slots, dtype=np.complex128).ravel()
        z[:len(s)] = s
        scale = scale if scale is not None else (1 << self.ctx.r)
        rounded = np.round(self.unembed(z) * scale).astype(object)
        mag = float(np.max(np.abs(z))) if len(s) else 0.0
        # rounding error <= 1/2 per coeff -> canonical bound
        err = self.ctx.noise_uniform(math.log2(0.5))
        from . import timing
        if timing.fhe_stats:
            # noise-model validation: actual decode error of the rounded
            # encoding vs the bound just charged (reference
            # HELIB_STATS_UPDATE("CKKS_encode_ratio"), EaCx.cpp:265-277)
            back = self.decode(rounded, Fraction(scale))[:self.nslots]
            dist = float(np.max(np.abs(back - z))) if len(z) else 0.0
            scaled_err = (2.0 ** err) / scale
            ratio = dist / scaled_err if scaled_err > 0 else 0.0
            if ratio > 1:
                from .log import warning
                warning("CKKS encode: error exceeds bound")
            timing.stats_update("CKKS_encode_ratio", ratio)
        return rounded, scale, max(mag, 2.0 ** -40), err

    def encode_ptxt(self, slots, scale: int | None = None):
        """Scheme-tagged CKKS encoding (HElib's EncryptedArrayCx::encode ->
        EncodedPtxt with mag/scale, EncodedPtxt.h:142,312), for
        Ctxt.mul_by_constant and FatEncodedPtxt."""
        from .encoded import EncodedPtxt
        coeffs, scale_v, mag, _ = self.encode(slots, scale)
        return EncodedPtxt(np.array([int(c) for c in coeffs]),
                           mag=mag, scale=float(scale_v))

    def decode(self, coeffs, scale: Fraction) -> np.ndarray:
        vals = np.array([float(Fraction(int(c)) / scale) for c in coeffs],
                        dtype=np.float64)
        return self.embed(vals)

    # ----------------------------------------------------------- encrypt
    def encrypt(self, slots, pubkey: PubKey, rng: np.random.Generator,
                scale: int | None = None) -> Ctxt:
        """Public-key encryption of the encoded slots, with randomness from
        the host generator `rng` (the same draws as helib_tpu)."""
        ctx = self.ctx
        coeffs, scale_v, mag, enc_err = self.encode(slots, scale)
        k, special = ctx.L, False
        r_coeffs, r_bound = sample_small(ctx, rng)
        r = small_coeffs_to_rt(ctx, r_coeffs, k, special)
        noise = r_bound + pubkey.enc_noise
        parts = []
        for i, (handle, data) in enumerate(pubkey.enc_key):
            part = rt_mul(ctx, data, r, k, special)
            e_coeffs, e_bound = sample_gaussian(ctx, rng)
            part = rt_add(ctx, part, small_coeffs_to_rt(ctx, e_coeffs, k,
                                                        special), k, special)
            if i == 1:
                e_bound += pubkey.sk_bound
            noise = log2_add(noise, e_bound)
            parts.append((handle, part))
        pt = small_coeffs_to_rt(ctx, np.array([int(c) for c in coeffs],
                                              dtype=np.int64), k, special)
        parts[0] = (parts[0][0], rt_add(ctx, parts[0][1], pt, k, special))
        noise = log2_add(noise, enc_err)
        return Ctxt(ctx=ctx, pubkey=pubkey, parts=parts, k=k,
                    special=special, ptxt_space=1, noise=noise, intFactor=1,
                    ratFactor=Fraction(scale_v), ptxtMag=mag)

    # ----------------------------------------------------------- decrypt
    def raw_decrypt(self, ctxt: Ctxt, sk: SecKey) -> np.ndarray:
        """Decrypt without the Li-Micciancio mitigation (tests only)."""
        return self.decode(sk.decrypt_raw(ctxt), Fraction(ctxt.ratFactor))

    def decrypt(self, ctxt: Ctxt, sk: SecKey) -> np.ndarray:
        """Decrypt with the Li-Micciancio decryption-noise mitigation: adds
        a Gaussian whose width makes the released error grow by at most
        eps = ctxt.error_bound().  Its generator is seeded by a SHA-256 of
        the secret coefficients, the <c, s> residues and the scale -- the
        same bytes helib_tpu hashes, so both packages release the same
        values."""
        ctx = self.ctx
        eps = ctxt.error_bound()
        coeff_res, rows = sk._inner_product_residues(ctxt)
        vals = dcrt.crt_reconstruct(ctx, coeff_res, rows,
                                    balanced=True).astype(object)
        # sigma chosen so sigma*B/ratFactor = eps, floored at 2*stdev
        phim = ctx.phi_m
        B = math.sqrt(phim * math.log(phim))
        sigma_min = ctx.stdev * 2
        sigma = float(Fraction(ctxt.ratFactor) * Fraction(eps)) / B
        if sigma < sigma_min:
            sigma = sigma_min
            from .log import warning
            warning("CKKS decryption: sigma set to sigma_min, "
                    "accuracy may be affected", once=True)
        h = hashlib.sha256()
        h.update(np.asarray(sk.s_coeffs).tobytes())
        h.update(np.ascontiguousarray(coeff_res).tobytes())
        h.update(_decimal(ctxt.ratFactor).encode())
        prg = np.random.default_rng(
            np.frombuffer(h.digest(), dtype=np.uint64))
        g = prg.normal(0.0, 1.0, self.N)
        mant, ex = math.frexp(sigma)
        if ex > 52:
            # sigma beyond int64: exact object-int scaling of a 52-bit
            # mantissa
            scaled = np.round(g * mant * (1 << 52)).astype(np.int64)
            noise = scaled.astype(object) * (1 << (ex - 52))
        else:
            noise = np.round(g * sigma).astype(np.int64)
        return self.decode(vals + noise, Fraction(ctxt.ratFactor))

    # --------------------------------------------------------- arithmetic
    def mul_const(self, ctxt: Ctxt, values, scale: int | None = None):
        """Multiply by encoded constant slots."""
        coeffs, scale_v, mag, err = self.encode(values, scale)
        pt = small_coeffs_to_rt(self.ctx, coeffs.astype(np.int64), ctxt.k,
                                ctxt.special)
        out = ctxt.copy()
        out.parts = [(h, rt_mul(self.ctx, d, pt, out.k, out.special))
                     for h, d in out.parts]
        # ctxt*(enc+eps) = ctxt*enc + ctxt*eps:
        #   noise_c*|enc| + (mag_c*f_c + noise_c)*eps
        cbound = math.log2(mag) + math.log2(scale_v)
        val_bound = log2_add(math.log2(max(ctxt.ptxtMag, 2.0 ** -40))
                             + frac_log2(Fraction(ctxt.ratFactor)),
                             ctxt.noise)
        out.noise = log2_add(ctxt.noise + cbound, err + val_bound)
        out.ratFactor = Fraction(ctxt.ratFactor) * scale_v
        out.ptxtMag = ctxt.ptxtMag * mag
        return out

    def rescale(self, ctxt: Ctxt):
        """Drop to the natural level (divides the scale)."""
        ctxt.drop_special_primes()
        nk = ctxt.natural_k()
        if nk < ctxt.k:
            ctxt.mod_down_to(nk, False)
        return ctxt

    # ---------------------------------------------------------- rotations
    def rotate(self, ctxt: Ctxt, amt: int, key):
        """Rotate the slots by amt (slot j -> slot j + amt), in place: the
        automorphism X -> X^k, k = 5^(-amt) mod m."""
        amt %= self.nslots
        if amt == 0:
            return ctxt
        return ctxt.smart_automorph(pow(inv_mod(5, self.m), amt, self.m),
                                    key)

    def shift(self, ctxt: Ctxt, amt: int, key):
        """Non-cyclic shift with zero fill: mask out the slots that would
        wrap around, then rotate (reference EncryptedArrayCx::shift)."""
        n = self.nslots
        if amt == 0:
            return ctxt
        mask = np.zeros(n)
        if amt > 0:
            mask[: n - amt] = 1.0
        else:
            mask[-amt:] = 1.0
        return self.rotate(self.mul_const(ctxt, mask), amt % n, key)

    def extract_real_part(self, ctxt: Ctxt, key):
        """Re(x) = (x + conj(x)) / 2; the halving only doubles ratFactor."""
        out = ctxt.copy().add(ctxt.copy().conjugate(key))
        out.ratFactor = Fraction(out.ratFactor) * 2
        return out

    def extract_imaginary_part(self, ctxt: Ctxt, key):
        """Im(x) = (x - conj(x)) / (2i): the difference times -i/2."""
        diff = ctxt.copy().sub(ctxt.copy().conjugate(key))
        return self.mul_const(diff, np.full(self.nslots, -0.5j))
