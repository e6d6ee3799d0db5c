"""intraSlot packing: use the d coefficients of each slot as d data values.

helib_tpu.algos.intraslot: HElib's intraSlot
(src/intraSlot.cpp, include/helib/intraSlot.h:27-75:
buildUnpackSlotEncoding / unpack / repack)."""

from __future__ import annotations

import numpy as np

from .linpoly import projection_maps, apply_linearized


def build_unpack_slot_encoding(ea):
    """Precompute the d projection linearized-polys (HElib's
    buildUnpackSlotEncoding)."""
    return projection_maps(ea)


def unpack(ea, ctxt, key, unpack_encoding=None) -> list:
    """One ciphertext with full-extension slots -> d ciphertexts with the
    j-th slot coefficient in the constant position (HElib's unpack)."""
    enc = unpack_encoding or build_unpack_slot_encoding(ea)
    return [apply_linearized(ea, ctxt, coeffs, key) for coeffs in enc]


def repack(ea, ctxts: list, key=None):
    """Inverse of unpack: sum_j Y^j * ctxts[j] (HElib's repack)."""
    acc = None
    for j, ct in enumerate(ctxts):
        yj = np.zeros(ea.d, dtype=np.int64)
        yj[j] = 1
        t = ct.copy()
        t.mul_constant_fat(ea.const_fat(yj))
        acc = t if acc is None else acc.add(t)
    return acc
