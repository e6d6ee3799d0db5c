"""Encrypted table lookup (HElib's src/tableLookup.cpp:37-109).

computeAllProducts: selector tree over k bits -> 2^k indicator products.
table_lookup: select table[index] where index is bit-encrypted.
table_write_in: add delta into the selected entry of an encrypted table.
Requires p=2 (bits)."""

from __future__ import annotations

import numpy as np
from ..exceptions import assert_true


def _one_minus(ct):
    out = ct.copy()
    out.mul_constant_poly(np.full(1, -1, dtype=np.int64))
    out.add_constant_poly(np.ones(1, dtype=np.int64))
    return out


def compute_all_products(ea, bits: list, key) -> list:
    """All 2^k products of (bits[i] / its complement) — index bit i chooses
    (HElib's computeAllProducts, tableLookup.cpp:37)."""
    k = len(bits)
    if k == 0:
        return []
    # recursive halves for log depth
    if k == 1:
        return [_one_minus(bits[0]), bits[0].copy()]
    mid = k // 2
    lo = compute_all_products(ea, bits[:mid], key)
    hi = compute_all_products(ea, bits[mid:], key)
    out = []
    for h in hi:
        for l in lo:
            out.append(l.multiply(h, key))
    return out


def table_lookup(ea, bits: list, table: list, key):
    """Select the table entry indexed by the encrypted bits; table entries
    are plaintext slot-vectors (HElib's tableLookup, tableLookup.cpp:83)."""
    sel = compute_all_products(ea, bits, key)
    assert_true(len(table) <= len(sel), 'invariant: len(table) <= len(sel)')
    acc = None
    for idx, entry in enumerate(table):
        entry = np.atleast_1d(entry)
        if len(entry) == 1:           # scalar: broadcast to every slot
            entry = np.full(ea.nslots, entry[0], dtype=np.int64)
        t = sel[idx].copy()
        t.mul_constant_poly(ea.encode(list(entry)))
        acc = t if acc is None else acc.add(t)
    return acc


def table_write_in(ea, bits: list, table_ctxts: list, delta, key):
    """table[idx] += delta (encrypted idx; HElib's tableWriteIn,
    tableLookup.cpp:109).  Mutates the list of encrypted table entries."""
    sel = compute_all_products(ea, bits, key)
    for idx in range(len(table_ctxts)):
        t = sel[idx].multiply(delta, key)
        table_ctxts[idx] = table_ctxts[idx].copy().add(t)
    return table_ctxts


def build_lookup_table(func, in_bits: int, out_range: int) -> list:
    """Cleartext helper: table[i] = func(i) mod out_range (role of HElib's
    buildLookupTable, tableLookup.h:86)."""
    return [int(func(i)) % out_range for i in range(1 << in_bits)]
