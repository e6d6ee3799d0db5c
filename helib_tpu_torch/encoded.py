"""Encoded plaintexts: scheme-tagged host encodings and device-resident
("fat") constants (helib_tpu.encoded).

The roles of HElib's EncodedPtxt / FatEncodedPtxt
(include/helib/EncodedPtxt.h:20-355) and the matmul constant cache
(`ConstMultiplierCache` + `upgrade()`, matmul.h:251-264): an encoded
constant that will be multiplied into ciphertexts repeatedly is transformed
to the evaluation domain ONCE over the full prime chain, on the context's
device, and afterwards served by row slicing -- no per-use host encode or
transform.

Row slicing is exact because the transform is independent per prime row and
a (prefix-k, specials?) prime set is always a subset of the full row set.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import Context
from .ops.modops import to_device


class EncodedPtxt:
    """Scheme-tagged encoded plaintext (EncodedPtxt.h:20-160): a coefficient
    vector plus (BGV) the plaintext space or (CKKS) the magnitude/scale
    pair."""

    def __init__(self, coeffs: np.ndarray, *, space: int | None = None,
                 mag: float | None = None, scale: float | None = None):
        self.coeffs = np.asarray(coeffs)
        self.space = space          # BGV: p^r
        self.mag = mag              # CKKS
        self.scale = scale          # CKKS

    @property
    def is_bgv(self) -> bool:
        return self.space is not None

    def fat(self, ctx: Context) -> "FatEncodedPtxt":
        return FatEncodedPtxt(ctx, self.coeffs,
                              space=self.space, scale=self.scale)


class FatEncodedPtxt:
    """Device-resident encoded constant (EncodedPtxt.h:200-355).

    For BGV, coefficients are balanced-lifted mod `space` before the lift to
    RNS residues (as Ctxt.mul_constant_poly does).  For CKKS the
    coefficients are already scaled integers.  The full-row eval tensor is
    built on first use and sliced per (k, special) thereafter.
    """

    def __init__(self, ctx: Context, coeffs: np.ndarray, *,
                 space: int | None = None, scale: float | None = None):
        self.ctx = ctx
        self.space = space
        self.scale = scale
        c = np.asarray(coeffs, dtype=np.int64)
        if space is not None and space > 1:
            c = c % space
            c = c - (c > space // 2) * space
        self.coeffs = c
        self._full = None       # [L+S, N] eval tensor over ALL rows

    def _build(self):
        ctx = self.ctx
        all_rows = tuple(range(ctx.L + ctx.S))
        qs = ctx.all_q.astype(np.int64)
        buf = np.zeros(ctx.n_eval, dtype=np.int64)
        buf[:len(self.coeffs)] = self.coeffs
        res = (buf[None, :] % qs[:, None]).astype(np.uint32)
        self._full = ctx.fwd_ntt(to_device(res, ctx.device), all_rows)

    def rt(self, k: int, special: bool) -> torch.Tensor:
        """Eval-domain tensor on the (k, special) prime set."""
        if self._full is None:
            self._build()
        if special:
            ctx = self.ctx
            if k == ctx.L:
                return self._full
            idx = ctx.cached(("fat_rows", k), lambda: torch.from_numpy(
                np.concatenate([np.arange(k), np.arange(ctx.L, ctx.L + ctx.S)])
            ).to(ctx.device))
            return self._full.index_select(0, idx)
        return self._full[:k]
