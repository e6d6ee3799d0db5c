"""Hoisted automorphisms: decompose once, rotate many times
(helib_tpu.algos.hoisting).

HElib's BasicAutomorphPrecon (src/matmul.cpp:48-183): the expensive part of
a rotation is the key-switch digit decomposition of the c1 part; for a
batch of rotations of the same ciphertext (BSGS baby steps, the trace's
Frobenius maps) the decomposition is shared, and each automorphism costs
one gather of the stacked digits plus the matrix MACs.

Valid because digit decomposition is coefficient-wise and balanced, so it
commutes with Galois automorphisms: digits(sigma_k(c)) = sigma_k(digits(c)).
"""

from __future__ import annotations

from fractions import Fraction

import torch

from ..context import log2_add
from ..keys import SKHandle, get_ks_matrix
from ..ctxt import Ctxt, ks_stacked_W
from ..dcrt import (rt_break_into_digits, rt_add_special_and_scale, rt_add,
                    rt_automorph)
from ..ops.modops import mul_mod, add_mod


class AutomorphPrecon:
    def __init__(self, ctxt: Ctxt, key):
        """key: PubKey or SecKey (evaluation needs only `.matrices`)."""
        ctxt = ctxt.copy()
        ctxt.relinearize(key)
        ctxt.drop_special_primes()
        self.base = ctxt
        self.key = key
        parts = dict((h.powS, d) for h, d in ctxt.parts)
        self.c0 = parts[0]
        digits, self.digit_noise = rt_break_into_digits(ctxt.ctx, parts[1],
                                                        ctxt.k)
        self.n_digits = len(digits)
        self._stacked_digits = torch.stack(digits, dim=-3)   # [nd, R, N]

    def automorph(self, kexp: int) -> Ctxt:
        """One rotation at about the cost of its MACs (HElib's automorph(),
        matmul.cpp:120)."""
        base = self.base
        ctx = base.ctx
        k = base.k
        kexp %= ctx.m
        if kexp == 1:
            return base.copy()
        W = get_ks_matrix(self.key, SKHandle(1, kexp, 0))
        q, mu = ctx.dev_q(k, True)
        acc0 = rt_add_special_and_scale(ctx, rt_automorph(ctx, self.c0, kexp),
                                        k)
        # one gather permutes all digits, then two stacked MACs
        Dk = rt_automorph(ctx, self._stacked_digits, kexp)
        nd = self.n_digits
        Wb, Wa = ks_stacked_W(W, ctx.rows_of(k, True))
        pb = mul_mod(Dk, Wb[:nd], q, mu)
        pa = mul_mod(Dk, Wa[:nd], q, mu)
        sb, sa = pb[..., 0, :, :], pa[..., 0, :, :]
        for j in range(1, nd):
            sb = add_mod(sb, pb[..., j, :, :], q)
            sa = add_mod(sa, pa[..., j, :, :], q)
        acc0 = rt_add(ctx, acc0, sb, k, True)
        noise = log2_add(base.noise + ctx.log2_special(),
                         self.digit_noise + W.noise)
        out = Ctxt(ctx, base.pubkey,
                   [(SKHandle(0, 1, 0), acc0), (SKHandle(1, 1, 0), sa)],
                   k, True, base.ptxt_space, noise, base.intFactor)
        out.ratFactor = base.ratFactor
        out.ptxtMag = base.ptxtMag
        if out.is_ckks:
            out.ratFactor = Fraction(base.ratFactor) * ctx.prod_special()
        return out
