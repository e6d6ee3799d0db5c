"""The calls into helib_tpu_torch a cell makes, one class a scheme.

A `Scheme` holds what set-up builds through the program's public API: the
context, the secret key the harness drew (`SecKey.restore`), the public
key, the relinearization matrix and the rotation matrices the
configuration lists, and the encryption pipeline on the card
(`pipeline.make_encrypt`, fed by a torch.Generator seeded from the run's
seed).  The operations a mix drives are in hebench/ops/, one file each.
`host_parts` turns an output into what the reference judges.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from helib_tpu_torch.ckks import EncryptedArrayCKKS
from helib_tpu_torch.context import Context
from helib_tpu_torch.ctxt import Ctxt
from helib_tpu_torch.dcrt import small_coeffs_to_rt
from helib_tpu_torch.keys import PubKey, SecKey, SKHandle
from helib_tpu_torch.nt.numbth import inv_mod
from helib_tpu_torch.pipeline import fresh_noise, make_encrypt

from . import inputs


class Scheme:
    """Context, keys and encryption of one configuration at one seed."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        ctx = self.ctx = Context(m=cfg["m"], p=cfg["p"], r=cfg["r"],
                                 bits=cfg["bits"], c=cfg["c"],
                                 scheme=cfg["scheme"], device=device)
        self.s = inputs.secret_key(seed, ctx.n_eval)
        full = small_coeffs_to_rt(ctx, self.s, ctx.L, True)
        self.sk = SecKey.restore(
            ctx, [{"coeffs": self.s, "bound": ctx.noise_small(0.5),
                   "full": full}], {},
            inputs.stream(seed, "keygen").bit_generator.state)
        self.pk = PubKey(self.sk)
        self.sk.gen_ks_matrix(SKHandle(2, 1, 0))
        self.noise = fresh_noise(ctx, self.pk)
        self._encrypt = make_encrypt(ctx, self.pk)
        self.gen = torch.Generator(device=ctx.device)
        self.gen.manual_seed(inputs.torch_seed(seed, "encrypt"))
        # the rotation arguments the configuration's key set covers
        self.rotations = list(cfg.get("rotations", []))

    def encrypt(self, value) -> tuple:
        """The two parts of a fresh encryption of one plaintext value."""
        return self._encrypt(self.gen, self.encode(value))


class BGV(Scheme):
    """Plaintexts are polynomials of degree < phi(m) mod p^r; `rotations`
    lists automorphism exponents k (X -> X^k)."""

    def __init__(self, cfg: dict, seed: int, device):
        super().__init__(cfg, seed, device)
        for k in self.rotations:
            self.sk.gen_ks_matrix(SKHandle(1, k, 0))

    def plaintexts(self, rng, count: int) -> np.ndarray:
        return inputs.bgv_plaintexts(rng, count, self.ctx.phi_m,
                                     self.ctx.ptxt_space)

    def encode(self, pt) -> torch.Tensor:
        ctx, pr = self.ctx, self.ctx.ptxt_space
        fixed = pt * (ctx.prod_qs(ctx.L) % pr) % pr
        fixed = fixed - (fixed > pr // 2) * pr
        return small_coeffs_to_rt(ctx, fixed, ctx.L, False)

    def wrap(self, parts, pt) -> Ctxt:
        """The Ctxt of a fresh encryption's parts."""
        ctx = self.ctx
        return Ctxt(ctx, self.pk, [(SKHandle(0, 1, 0), parts[0]),
                                   (SKHandle(1, 1, 0), parts[1])],
                    ctx.L, False, ctx.ptxt_space, self.noise, 1)


class CKKS(Scheme):
    """Plaintexts are m/4 real slots, encoded at the scale 2^r;
    `rotations` lists slot amounts."""

    def __init__(self, cfg: dict, seed: int, device):
        super().__init__(cfg, seed, device)
        self.ea = EncryptedArrayCKKS(self.ctx)
        m = self.ctx.m
        for amt in self.rotations:
            self.sk.gen_ks_matrix(SKHandle(1, pow(inv_mod(5, m), amt, m), 0))

    def plaintexts(self, rng, count: int) -> np.ndarray:
        return inputs.ckks_slots(rng, count, self.ea.nslots)

    def encode(self, z) -> torch.Tensor:
        coeffs, scale, mag, _ = self.ea.encode(z)
        return small_coeffs_to_rt(self.ctx, coeffs.astype(np.int64),
                                  self.ctx.L, False)

    def wrap(self, parts, z) -> Ctxt:
        """The Ctxt of a fresh encryption's parts, at the scale 2^r and
        the slots' magnitude (as the encoder bounds it)."""
        ctx = self.ctx
        mag = max(float(np.max(np.abs(z))), 2.0 ** -40)
        return Ctxt(ctx, self.pk, [(SKHandle(0, 1, 0), parts[0]),
                                   (SKHandle(1, 1, 0), parts[1])],
                    ctx.L, False, 1, self.noise, 1,
                    Fraction(1 << ctx.r), mag)


SCHEMES = {"bgv": BGV, "ckks": CKKS}


def scheme(cfg: dict, seed: int, device) -> Scheme:
    return SCHEMES[cfg["scheme"]](cfg, seed, device)


def host_parts(ct: Ctxt) -> dict:
    """A Ctxt as the reference reads it: its two parts copied to host
    memory, its prime set, and under CKKS its scale, under BGV its
    plaintext factor intFactor.  `canonical` is False unless the parts
    multiply exactly 1 and s."""
    hs = sorted((h.powS, h.powX, h.keyID) for h, _ in ct.parts)
    if hs != [(0, 1, 0), (1, 1, 0)]:
        return {"canonical": False}
    parts = dict((h.powS, d) for h, d in ct.parts)
    return {"c0": parts[0].cpu(), "c1": parts[1].cpu(), "k": ct.k,
            "special": ct.special,
            "scale": Fraction(ct.ratFactor) if ct.is_ckks else None,
            "int_factor": None if ct.is_ckks else int(ct.intFactor),
            "canonical": True}
