"""Arbitrary slot permutations (helib_tpu.algos.permutations).

The role of HElib's permutations/BenesNetwork/PermNetwork
(src/permutations.cpp, BenesNetwork.cpp, PermNetwork.cpp,
OptimizePermutations.cpp; user API PermIndepPrecomp/PermPrecomp,
permutations.h:603-645).

Implementation: displacement decomposition — group slots by rotation offset
(pi(i) - i mod n), apply one masked global rotation per distinct offset and
sum.  This is the dense equivalent of a collapsed Benes network; the
multi-layer Benes + dynamic-programming optimizer (which trades rotations
for depth) is a planned optimization on the same API.
"""

from __future__ import annotations

import numpy as np
from ..exceptions import assert_true


class PermPrecomp:
    """Precomputed data to apply a fixed permutation to ciphertexts."""

    def __init__(self, ea, perm):
        """perm: array with out_slot j takes content of slot perm[j]."""
        self.ea = ea
        perm = np.asarray(perm, dtype=np.int64)
        n = ea.nslots
        assert_true(sorted(perm.tolist()) == list(range(n)), "not a permutation")
        self.perm = perm
        # group by displacement: content of slot i moves to slot j with
        # perm[j] = i, i.e. displacement d = (j - i) mod n
        groups: dict[int, list] = {}
        for j in range(n):
            i = perm[j]
            d = (j - i) % n
            groups.setdefault(d, []).append(i)
        self.masks = {}
        for d, sources in groups.items():
            mask = np.zeros(n, dtype=np.int64)
            mask[sources] = 1
            self.masks[d] = ea.encode(list(mask))

    def apply(self, ctxt, key):
        acc = None
        for d, mask in self.masks.items():
            t = ctxt.copy()
            t.mul_constant_poly(mask)
            if d:
                t = self.ea.rotate(t, d, key)
            acc = t if acc is None else acc.add(t)
        return acc


def apply_permutation(ea, ctxt, perm, key):
    """One-shot form (HElib's applyToCtxt, PermNetwork.cpp:217)."""
    return PermPrecomp(ea, perm).apply(ctxt, key)
