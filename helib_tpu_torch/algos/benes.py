"""Benes permutation networks of general width (helib_tpu.algos.benes).

HElib's GeneralBenesNetwork (src/BenesNetwork.cpp:259,
include/helib/permutations.h:151):
routes an arbitrary permutation of n slots through 2*ceil(log2 n) - 1 levels
of conditional swaps between positions (i, i + delta).  Homomorphically,
each (level, delta) costs two masked rotations plus constant multiplies —
O(log n) rotations total versus O(n) for the dense diagonal method
(algos/permutations.py), at the price of multiplicative depth per level.

Construction: recursive halving with sz0 = ceil(n/2); a 2-coloring of the
input/output pairing constraints decides which element of each pair routes
through the upper/lower subnetwork (HElib's looping algorithm).
Sibling subnetworks of different sizes may use different swap distances at
the same level, so each level stores a {delta: mask} dict.
"""

from __future__ import annotations

import numpy as np
from ..exceptions import assert_true


class BenesNetwork:
    def __init__(self, perm):
        """perm: out[j] = in[perm[j]]."""
        perm = np.asarray(perm, dtype=np.int64)
        n = len(perm)
        assert_true(sorted(perm.tolist()) == list(range(n)), 'invariant: sorted(perm.tolist()) == list(range(n))')
        self.n = n
        depth = self._depth(n)
        self.nlevels = max(2 * depth - 1, 1)
        self.levels: list[dict[int, np.ndarray]] = [
            {} for _ in range(self.nlevels)]
        self._route(perm, 0, 0, self.nlevels)
        # drop empty levels
        self.levels = [lv for lv in self.levels
                       if any(m.any() for m in lv.values())]

    @staticmethod
    def _depth(n: int) -> int:
        d = 0
        while (1 << d) < n:
            d += 1
        return max(d, 1)

    def _set_swap(self, level: int, delta: int, pos: int):
        lv = self.levels[level]
        if delta not in lv:
            lv[delta] = np.zeros(self.n, dtype=np.int64)
        lv[delta][pos] = 1

    def _route(self, perm, lo, lev_lo, lev_cnt):
        n = len(perm)
        if n <= 1:
            return
        if n == 2:
            if perm[0] == 1:
                self._set_swap(lev_lo + lev_cnt // 2, 1, lo)
            return
        sz0 = (n + 1) // 2
        sz1 = n - sz0
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)

        def in_partner(i):
            if i + sz0 < n:
                return i + sz0
            if i - sz0 >= 0:
                return i - sz0
            return -1

        def out_partner(i):
            j = inv[i]
            if j + sz0 < n:
                return int(perm[j + sz0])
            if j - sz0 >= 0:
                return int(perm[j - sz0])
            return -1

        color = -np.ones(n, dtype=np.int64)
        seeds = []
        if sz1 < sz0:                     # odd n: middle input/output forced up
            seeds.append((sz0 - 1, 0))
            seeds.append((int(perm[sz0 - 1]), 0))
        seeds += [(i, 0) for i in range(n)]
        for node, c in seeds:
            if color[node] != -1:
                continue
            work = [(node, c)]
            while work:
                v, cv = work.pop()
                if color[v] != -1:
                    assert_true(color[v] == cv, "Benes coloring conflict")
                    continue
                color[v] = cv
                p = in_partner(v)
                if p >= 0:
                    work.append((p, 1 - cv))
                p = out_partner(v)
                if p >= 0:
                    work.append((p, 1 - cv))

        in_lev = lev_lo
        out_lev = lev_lo + lev_cnt - 1
        for i in range(sz1):
            if color[i] == 1:
                self._set_swap(in_lev, sz0, lo + i)
            if color[int(perm[i])] == 1:
                self._set_swap(out_lev, sz0, lo + i)

        # positions after the input level / before the output level
        pos = np.empty(n, dtype=np.int64)
        for i in range(n):
            if color[i] == 0:
                pos[i] = i if i < sz0 else i - sz0
            else:
                pos[i] = i + sz0 if i + sz0 < n else i
        pre_out = np.empty(n, dtype=np.int64)
        for j in range(n):
            item = int(perm[j])
            if color[item] == 0:
                pre_out[item] = j if j < sz0 else j - sz0
            else:
                pre_out[item] = j + sz0 if j + sz0 < n else j
        up_perm = np.empty(sz0, dtype=np.int64)
        low_perm = np.empty(sz1, dtype=np.int64)
        for i in range(n):
            if color[i] == 0:
                up_perm[pre_out[i]] = pos[i]
            else:
                low_perm[pre_out[i] - sz0] = pos[i] - sz0
        self._route(up_perm, lo, lev_lo + 1, lev_cnt - 2)
        self._route(low_perm, lo + sz0, lev_lo + 1, lev_cnt - 2)

    # -- cleartext application (oracle/testing) ---------------------------
    def apply_vector(self, v):
        v = np.asarray(v).copy()
        for lv in self.levels:
            out = v.copy()
            for d, mask in lv.items():
                for i in np.nonzero(mask)[0]:
                    out[i], out[i + d] = v[i + d], v[i]
            v = out
        return v

    # -- homomorphic application ------------------------------------------
    def apply(self, ea, ctxt, key):
        """Per (level, delta): keep⊙x + rot(x,+d)⊙dst + rot(x,-d)⊙src
        (HElib's PermNetwork::applyToCtxt, PermNetwork.cpp:217)."""
        cur = ctxt
        for lv in self.levels:
            keep = np.ones(self.n, dtype=np.int64)
            acc = None
            for d, mask in lv.items():
                src = mask.astype(np.int64)
                dst = np.roll(src, d)
                keep = keep * (1 - src) * (1 - dst)
                right = ea.rotate(cur.copy(), d, key)
                right.mul_constant_poly(ea.encode(list(dst)))
                left = ea.rotate(cur.copy(), -d, key)
                left.mul_constant_poly(ea.encode(list(src)))
                part = right.add(left)
                acc = part if acc is None else acc.add(part)
            t_keep = cur.copy()
            t_keep.mul_constant_poly(ea.encode(list(keep)))
            cur = t_keep if acc is None else t_keep.add(acc)
        return cur
