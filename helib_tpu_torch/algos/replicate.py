"""Slot replication (helib_tpu.algos.replicate; HElib's src/replicate.cpp:
replicate/replicateAll).

Two algorithms, as in the reference:
  * replicate(pos): mask one slot + log-depth rotate-accumulate
    (reference replicate, replicate.cpp:26).
  * replicate_all: the RECURSIVE algorithm (reference replicateAll /
    RecursiveReplicator, replicate.cpp:304-742 and replicate.h:43-196):
    maintain the invariant that the ciphertext is PERIODIC with period
    `size` (every period holds a copy of the same block), split the block
    in half, fill each half across its period with one rotation + add,
    and recurse.  Each internal node costs O(1) ciphertext ops, so all
    nslots replicas cost O(nslots) rotations total instead of the naive
    O(nslots log nslots).  Results are streamed to a ReplicateHandler
    (reference replicate.h:43) so consumers with bounded memory (e.g.
    tableLookup) never hold all nslots ciphertexts at once.

The recursive split needs the period to stay a divisor of nslots, so the
fast path handles the largest power-of-2 factor of nslots exactly as the
reference restricts recursion to power-of-2 sub-dimensions
(SubDimension/replicateOneBlock, replicate.cpp:360-470); remaining odd
factors fall back to masked single-slot replication within the block.
"""

from __future__ import annotations

import numpy as np

from .sums import total_sums
from ..exceptions import assert_true


class ReplicateHandler:
    """Callback consuming replicated ciphertexts one at a time
    (reference ReplicateHandler, replicate.h:43)."""

    def handle(self, pos: int, ctxt):
        raise NotImplementedError

    def early_stop(self) -> bool:
        """Return True to abort the recursion (reference ReplicateHandler
        early-termination via exceptions in tableLookup)."""
        return False


class _Collector(ReplicateHandler):
    def __init__(self, n):
        self.out = [None] * n

    def handle(self, pos, ctxt):
        self.out[pos] = ctxt


def replicate(ea, ctxt, pos: int, key):
    """Broadcast slot `pos` to all slots (reference replicate,
    replicate.cpp:26): mask to the single slot, then log-depth rotate+add."""
    mask = np.zeros(ea.nslots, dtype=np.int64)
    mask[pos] = 1
    out = ctxt.copy()
    out.mul_constant_poly(ea.encode(list(mask)))
    return total_sums(ea, out, key)


def _fill_period(ea, ctxt, size: int, half: int, offset: int, key):
    """ctxt is periodic with period `size`; keep only the sub-block
    [offset, offset+half) of each period and spread it so the result is
    periodic with period `half` (mask + Halevi-Shoup rotation ladder —
    reference replicateOneBlock, replicate.cpp:360)."""
    n = ea.nslots
    mask = np.zeros(n, dtype=np.int64)
    for start in range(0, n, size):
        mask[start + offset:start + offset + half] = 1
    picked = ctxt.copy()
    picked.mul_constant_poly(ea.encode(list(mask)))
    count = size // half      # exact: half | size at every call site
    # out = sum_{j<count} rotate(picked, j*half*?) via the totalSums binary
    # ladder (exact for any count, no overlapping adds)
    out = picked
    e = 1
    bits = []
    v = count
    while v > 1:
        bits.append(v & 1)
        v >>= 1
    for b in reversed(bits):
        out = out.copy().add(ea.rotate(out.copy(), e * half, key))
        e *= 2
        if b:
            out = picked.copy().add(ea.rotate(out.copy(), half, key))
            e += 1
    assert_true(e == count, 'invariant: e == count')
    return out


def _rec(ea, ctxt, size: int, base: int, handler, key):
    """ctxt periodic with period `size`; periods hold original slots
    [base, base+size) (mod the period structure)."""
    if handler.early_stop():
        return
    if size == 1:
        handler.handle(base % ea.nslots, ctxt)
        return
    if size % 2 == 0:
        half = size // 2
        left = _fill_period(ea, ctxt, size, half, 0, key)
        _rec(ea, left, half, base, handler, key)
        right = _fill_period(ea, ctxt, size, half, half, key)
        _rec(ea, right, half, base + half, handler, key)
    else:
        # odd block: replicate each remaining slot directly within the
        # periodic structure (mask one residue class, then fill)
        for j in range(size):
            if handler.early_stop():
                return
            out = _fill_period(ea, ctxt, size, 1, j, key)
            handler.handle((base + j) % ea.nslots, out)


def replicate_all(ea, ctxt, key, handler: ReplicateHandler | None = None):
    """Replicate every slot (reference replicateAll, replicate.cpp:716):
    recursive periodic-halving algorithm; returns the list of nslots
    ciphertexts when no handler is given, else streams to the handler."""
    collect = handler is None
    if collect:
        handler = _Collector(ea.nslots)
    _rec(ea, ctxt, ea.nslots, 0, handler, key)
    return handler.out if collect else None
