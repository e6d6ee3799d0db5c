"""Depth-bounded permutation-network optimizer (He-Shoup).

helib_tpu.algos.optimize_perms: HElib's OptimizePermutations.cpp (1017 LoC) +
PermNetwork.cpp + the user API PermIndepPrecomp/PermPrecomp
(include/helib/permutations.h:603-645):

  * A slot permutation over the hypercube is decomposed into 2k-1 column
    permutations (ColPerms) along (sub)dimensions; each ColPerm is routed by
    a Benes network whose 2*ceil(log2 f)-1 levels are *collapsed* into at
    most `budget` layers.  A collapsed layer costs (#achievable offsets - 1)
    rotations and depth 1 (one round of masked-rotation MACs).
  * Three nested dynamic programs pick the cheapest plan under a total
    depth bound (HElib's optimalBenes / optimalLower / optimalUpperAux,
    OptimizePermutations.cpp:286-822):
      - level collapsing within one Benes network,
      - splitting one generator's order into subdimension factors,
      - allocating depth budget + the single "middle" token across
        generators (the middle dimension appears once in the ColPerm
        sandwich; every other dimension appears twice).
  * Subdimension embeddings use HElib's e-value rules
    (computeEvalues, OptimizePermutations.cpp:880-928): a good dimension
    split into coprime factors keeps both factors "good" via CRT
    coefficients; otherwise the right factor becomes "bad" (mixed radix).

Application is pure composition of existing primitives: per collapsed layer,
one plaintext mask multiply + rotate1D per nonzero offset.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .matching import perm_to_column_perms
from ..exceptions import assert_true

INF = float("inf")


# ---------------------------------------------------------------------------
# Benes network structure (permutation-independent): per-level swap deltas
# ---------------------------------------------------------------------------

def benes_depth(n: int) -> int:
    d = 0
    while (1 << d) < n:
        d += 1
    return max(d, 1)


def benes_level_deltas(n: int) -> list[set[int]]:
    """Structural swap distances at each of the 2k-1 levels of a width-n
    network (union over all sub-blocks; mirrors algos/benes.py routing)."""
    nlev = 2 * benes_depth(n) - 1
    out: list[set[int]] = [set() for _ in range(nlev)]

    def rec(sz, lev_lo, lev_cnt):
        if sz <= 1:
            return
        if sz == 2:
            out[lev_lo + lev_cnt // 2].add(1)
            return
        sz0 = (sz + 1) // 2
        out[lev_lo].add(sz0)
        out[lev_lo + lev_cnt - 1].add(sz0)
        rec(sz0, lev_lo + 1, lev_cnt - 2)
        rec(sz - sz0, lev_lo + 1, lev_cnt - 2)

    rec(n, 0, nlev)
    return out


def build_cost_table(n: int, good: bool) -> list[list[int]]:
    """tab[i][j] = rotation cost of collapsing levels i..i+j into one layer
    = (#achievable nonzero offsets), offsets merged mod n when `good`
    (HElib's buildBenesCostTable, OptimizePermutations.cpp:127)."""
    deltas = benes_level_deltas(n)
    nlev = len(deltas)
    tab: list[list[int]] = []
    for i in range(nlev):
        row = []
        X = {0}
        for j in range(nlev - i):
            choices = {0}
            for d in deltas[i + j]:
                choices.add(d)
                choices.add(-d)
            X = {x + c for x in X for c in choices
                 if -(n - 1) <= x + c <= n - 1}
            if good:
                row.append(len({x % n for x in X}) - 1)
            else:
                row.append(len(X) - 1)
        tab.append(row)
    return tab


def optimal_benes(n: int, budget: int, good: bool):
    """Optimal level collapsing of a width-n Benes network into <= budget
    layers.  Returns (cost, groups) with groups a list of collapsed level
    counts summing to 2k-1, or (inf, None) if infeasible
    (HElib's optimalBenes, OptimizePermutations.cpp:358)."""
    if budget <= 0:
        return INF, None
    tab = build_cost_table(n, good)
    nlev = len(tab)
    memo: dict = {}

    def aux(i, b):
        if i == nlev:
            return 0, []
        if b == 1:
            return tab[i][nlev - i - 1], [nlev - i]
        key = (i, b)
        if key in memo:
            return memo[key]
        best = (INF, None)
        for j in range(nlev - i):
            c_rest, g_rest = aux(i + j + 1, b - 1)
            c = tab[i][j] + c_rest
            if c < best[0]:
                best = (c, [j + 1] + g_rest)
        memo[key] = best
        return best

    return aux(0, budget)


# ---------------------------------------------------------------------------
# Split trees (one per generator) and the two outer DPs
# ---------------------------------------------------------------------------

@dataclass
class SplitNode:
    """Node of a generator's split tree (HElib's SplitNode,
    OptimizePermutations.cpp:392)."""
    order: int
    good: bool
    mid: int
    # leaves:
    groups1: list | None = None     # level collapsing, first occurrence
    groups2: list | None = None     # second occurrence (non-mid only)
    # internal:
    left: "SplitNode | None" = None
    right: "SplitNode | None" = None
    e: int = 1                      # stride/CRT coefficient (computeEvalues)

    @property
    def is_leaf(self):
        return self.left is None

    def clone(self) -> "SplitNode":
        """Deep copy.  The DP memo tables share SplitNode objects between
        solutions; e-value assignment mutates nodes, so each tree placed in
        a PermIndepPrecomp needs its own copy."""
        return SplitNode(self.order, self.good, self.mid,
                         groups1=list(self.groups1) if self.groups1 else None,
                         groups2=list(self.groups2) if self.groups2 else None,
                         left=self.left.clone() if self.left else None,
                         right=self.right.clone() if self.right else None,
                         e=self.e)


def optimal_lower(order: int, good: bool, budget: int, mid: int,
                  memo: dict):
    """Optimal split tree for one generator (HElib's optimalLower,
    OptimizePermutations.cpp:625): leaf = one Benes (mid) or two (non-mid,
    budget split floor/ceil), or recursive order = o1*o2 splits."""
    key = (order, good, budget, mid)
    if key in memo:
        return memo[key]
    if mid == 0 and budget == 1:
        memo[key] = (INF, None)
        return memo[key]
    # leaf solution
    if mid == 1:
        cost, g1 = optimal_benes(order, budget, good)
        g2 = None
    else:
        c1, g1 = optimal_benes(order, budget // 2, good)
        if budget % 2 == 0:
            c2, g2 = c1, g1
        else:
            c2, g2 = optimal_benes(order, budget - budget // 2, good)
        cost = c1 + c2
    best = (cost, SplitNode(order, good, mid, groups1=g1, groups2=g2)
            if cost < INF else None)
    # splits
    for o1 in range(2, order):
        if order % o1:
            continue
        o2 = order // o1
        good1 = good
        good2 = good and math.gcd(o1, o2) == 1
        for b1 in range(1, budget):
            for m1 in range(mid + 1):
                c1, s1 = optimal_lower(o1, good1, b1, m1, memo)
                if c1 == INF:
                    continue
                c2, s2 = optimal_lower(o2, good2, budget - b1, mid - m1,
                                       memo)
                if c2 == INF:
                    continue
                if c1 + c2 < best[0]:
                    best = (c1 + c2,
                            SplitNode(order, good, mid, left=s1, right=s2))
    memo[key] = best
    return best


def optimal_upper(gens: list[tuple[int, bool]], budget: int):
    """Allocate depth budget and the single middle token across generators
    (HElib's optimalUpperAux, OptimizePermutations.cpp:739).
    gens: [(order, good)].  Returns (cost, [SplitNode per generator])."""
    lower_memo: dict = {}
    memo: dict = {}

    def aux(i, b, mid):
        if i == len(gens):
            return (0, []) if mid == 0 else (INF, None)
        if b <= 0:
            return INF, None
        key = (i, b, mid)
        if key in memo:
            return memo[key]
        best = (INF, None)
        order, good = gens[i]
        for b1 in range(1, b + 1):
            for m1 in range(mid + 1):
                c1, s1 = optimal_lower(order, good, b1, m1, lower_memo)
                if c1 == INF:
                    continue
                c2, rest = aux(i + 1, b - b1, mid - m1)
                if c2 == INF:
                    continue
                if c1 + c2 < best[0]:
                    best = (c1 + c2, [s1] + rest)
        memo[key] = best
        return best

    return aux(0, budget, 1)


def compute_e_values(node: SplitNode, gen_order: int, e: int = 1):
    """Assign subdimension strides / CRT coefficients (HElib's
    computeEvalues, OptimizePermutations.cpp:880)."""
    node.e = e
    if node.is_leaf:
        return
    l, r = node.left, node.right
    if not r.good:
        compute_e_values(l, gen_order, e * r.order % gen_order)
        compute_e_values(r, gen_order, e)
    elif not l.good:
        compute_e_values(l, gen_order, e)
        compute_e_values(r, gen_order, e * l.order % gen_order)
    else:
        # both good, coprime: CRT coefficients f1 = 0 mod o1, 1 mod o2
        o1, o2 = l.order, r.order
        f1 = (o2 * pow(o2, -1, o1) * 0 + o1 * pow(o1, -1, o2)) % (o1 * o2)
        f2 = (o1 * o2 + 1 - f1) % (o1 * o2)
        compute_e_values(l, gen_order, e * f2 % gen_order)
        compute_e_values(r, gen_order, e * f1 % gen_order)


def tree_leaves(node: SplitNode) -> list[SplitNode]:
    if node.is_leaf:
        return [node]
    return tree_leaves(node.left) + tree_leaves(node.right)


def coord_split(node: SplitNode, x: int) -> list[int]:
    """Generator coordinate x -> leaf digits, left-to-right (inverse of the
    e-value embedding: x = sum digit_leaf * e_leaf mod order)."""
    if node.is_leaf:
        return [x]
    l, r = node.left, node.right
    if not r.good:
        a, b = divmod(x, r.order)
    elif not l.good:
        b, a = divmod(x, l.order)
    else:
        a, b = x % l.order, x % r.order
    return coord_split(l, a) + coord_split(r, b)


# ---------------------------------------------------------------------------
# User API: permutation-independent precomputation + per-perm network
# (HElib's PermIndepPrecomp / PermPrecomp, permutations.h:603-645)
# ---------------------------------------------------------------------------

class PermIndepPrecomp:
    """Runs buildOptimalTrees on the EncryptedArray's hypercube generators
    for a given depth bound; reusable across permutations."""

    def __init__(self, ea, depth_bound: int):
        self.ea = ea
        pal = ea.ctx.pal
        self.orders = list(pal.orders) if pal.orders else [ea.nslots]
        self.native = (list(pal.native) if getattr(pal, "native", None)
                       else [True] * len(self.orders))
        gens = [(o, bool(g)) for o, g in zip(self.orders, self.native)]
        self.cost, trees = optimal_upper(gens, depth_bound)
        if trees is None:
            raise ValueError(f"no permutation network within depth "
                             f"{depth_bound}")
        self.trees = [t.clone() for t in trees]   # memo shares nodes
        for tree, (order, _) in zip(self.trees, gens):
            compute_e_values(tree, order)
        # expanded dimension list: (gen_dim, leaf) — mid leaf moved last
        expanded = []
        for dim, tree in enumerate(self.trees):
            for leaf in tree_leaves(tree):
                expanded.append((dim, leaf))
        mid = [t for t in expanded if t[1].mid == 1]
        rest = [t for t in expanded if t[1].mid != 1]
        assert_true(len(mid) == 1, 'invariant: len(mid) == 1')
        self.expanded = rest + mid
        self.depth = sum(
            (len(leaf.groups1) if leaf.mid else
             len(leaf.groups1) + len(leaf.groups2))
            for _, leaf in self.expanded)

    def get_cost(self) -> int:
        return int(self.cost)


class PermPrecomp:
    """Network for one specific permutation, built on a PermIndepPrecomp
    plan (HElib's PermPrecomp; PermNetwork::buildNetwork)."""

    def __init__(self, pip: PermIndepPrecomp, perm):
        self.pip = pip
        ea = pip.ea
        n = ea.nslots
        perm = np.asarray(perm, dtype=np.int64)
        assert_true(sorted(perm.tolist()) == list(range(n)), "not a permutation")
        self.perm = perm
        pal = ea.ctx.pal
        # slot -> expanded digits
        sizes = [leaf.order for _, leaf in pip.expanded]
        ndims = len(sizes)
        dig = np.empty((n, ndims), dtype=np.int64)
        for s in range(n):
            cs = pal.coords(s) if pal.orders else (s,)
            pos = 0
            for dim, tree in enumerate(pip.trees):
                leaf_digits = coord_split(tree, int(cs[dim]))
                # digits are in tree-leaf order; scatter into expanded order
                for leaf, dgt in zip(tree_leaves(tree), leaf_digits):
                    idx = next(i for i, (d2, l2) in enumerate(pip.expanded)
                               if l2 is leaf and d2 == dim)
                    dig[s, idx] = dgt
            pos += 1
        # mixed-radix flat index over expanded dims (leftmost = most signif.)
        flat = np.zeros(n, dtype=np.int64)
        for i in range(ndims):
            flat = flat * sizes[i] + dig[:, i]
        self.flat = flat                      # slot -> expanded index
        inv_flat = np.empty(n, dtype=np.int64)
        inv_flat[flat] = np.arange(n)
        self.inv_flat = inv_flat              # expanded index -> slot
        # conjugate the slot permutation into expanded indexing:
        # out_e[j] = flat[ perm[ inv_flat[j] ] ]
        eperm = flat[perm[inv_flat]]
        # recursive ColPerm decomposition: dims processed left to right,
        # mid dim (last) gets the single middle stage
        self.stages = self._decompose(eperm, 0, sizes)
        # self.stages: list of (expanded_dim_index, colperm in expanded idx)

    def _decompose(self, perm, d0, sizes):
        """Recursive ColPerm decomposition.  At depth d0 the permutation is
        block-diagonal over the already-fixed prefix digits; each block of
        size rows*cols is decomposed independently (HElib's
        breakPermByDim, permutations.cpp)."""
        nd = len(sizes) - d0
        if nd == 1:
            return [(d0, perm)]
        N = len(perm)
        rows = sizes[d0]
        cols = 1
        for s in sizes[d0 + 1:]:
            cols *= s
        blk = rows * cols
        pre = np.arange(N)
        mid = np.arange(N)
        post = np.arange(N)
        for b0 in range(0, N, blk):
            local = perm[b0:b0 + blk] - b0
            assert_true(local.min() >= 0 and local.max() < blk, "perm crosses a fixed prefix block")
            p1, p2, p3 = perm_to_column_perms(local, rows, cols)
            pre[b0:b0 + blk] = p1 + b0
            mid[b0:b0 + blk] = p2 + b0
            post[b0:b0 + blk] = p3 + b0
        inner = self._decompose(mid, d0 + 1, sizes)
        out = []
        if not np.array_equal(pre, np.arange(N)):
            out.append((d0, pre))
        out += inner
        if not np.array_equal(post, np.arange(N)):
            out.append((d0, post))
        return out

    # -- application ------------------------------------------------------
    def apply(self, ctxt, key):
        ea = self.pip.ea
        occurrence: dict[int, int] = {}
        cur = ctxt
        for (edim, colperm) in self.stages:
            occ = occurrence.get(edim, 0)
            occurrence[edim] = occ + 1
            dim, leaf = self.pip.expanded[edim]
            groups = leaf.groups1 if (leaf.mid or occ == 0) else leaf.groups2
            cur = self._apply_colperm(cur, key, edim, colperm, groups)
        return cur

    def _colperm_layers(self, edim, colperm, groups):
        """Displacement-mask layers realizing a ColPerm along expanded dim
        `edim` with the given level collapsing.  Returns a list of
        {displacement: slot-mask} dicts — each dict is one depth level
        costing (len(dict)) rotations."""
        from .benes import BenesNetwork
        ea = self.pip.ea
        n = ea.nslots
        dim, leaf = self.pip.expanded[edim]
        f = leaf.order
        sizes = [l.order for _, l in self.pip.expanded]
        stride = 1
        for s in sizes[edim + 1:]:
            stride *= s
        nfibers = n // f
        nlev = 2 * benes_depth(f) - 1
        layers: list[dict[int, np.ndarray]] = [dict()
                                               for _ in range(len(groups))]
        id_local = np.arange(f)
        for fib in range(nfibers):
            # expanded indices of this fiber, ordered by local digit
            base = ((fib // stride) * stride * f) + (fib % stride)
            eidx = base + id_local * stride
            # local permutation: out[c] = in[pi[c]]
            pi = np.empty(f, dtype=np.int64)
            for c in range(f):
                src_e = colperm[eidx[c]]
                assert_true((src_e - base) % stride == 0, 'invariant: (src_e - base) % stride == 0')
                pi[c] = (src_e - base) // stride
            if np.array_equal(pi, id_local):
                bn_levels = [dict() for _ in range(nlev)]
            else:
                bn = BenesNetwork.__new__(BenesNetwork)
                bn.n = f
                bn.nlevels = nlev
                bn.levels = [dict() for _ in range(nlev)]
                bn._route(pi, 0, 0, nlev)
                bn_levels = bn.levels
            # compose each collapsed group of levels into a displacement map
            lev = 0
            for gi, cnt in enumerate(groups):
                v = id_local.copy()      # v[pos] = original local slot there
                for l in range(lev, lev + cnt):
                    if l >= len(bn_levels):
                        break
                    out = v.copy()
                    for d, mask in bn_levels[l].items():
                        for i in np.nonzero(mask)[0]:
                            out[i], out[i + d] = v[i + d], v[i]
                    v = out
                lev += cnt
                # content at local position c = v[p] moves to p: disp = p - c
                for p in range(f):
                    c = v[p]
                    dsp = p - c
                    if leaf.good:
                        dsp %= f
                    if dsp == 0:
                        continue
                    layer = layers[gi]
                    if dsp not in layer:
                        layer[dsp] = np.zeros(n, dtype=np.int64)
                    layer[dsp][self.inv_flat[eidx[c]]] = 1
        return layers

    def _apply_colperm(self, ctxt, key, edim, colperm, groups):
        """Apply a ColPerm along expanded dim `edim` as a level-collapsed
        Benes network: per collapsed layer, one masked rotate1D per nonzero
        achievable offset (HElib's PermNetwork::applyToCtxt,
        PermNetwork.cpp:217)."""
        ea = self.pip.ea
        n = ea.nslots
        dim, leaf = self.pip.expanded[edim]
        n_dim = self.pip.orders[dim]
        cur = ctxt
        for layer in self._colperm_layers(edim, colperm, groups):
            if not layer:
                continue
            keep = np.ones(n, dtype=np.int64)
            acc = None
            for dsp, mask in layer.items():
                keep = keep * (1 - mask)
                amt = (leaf.e * dsp) % n_dim
                t = cur.copy()
                t.mul_constant_poly(ea.encode(list(mask)))
                t = ea.rotate_1d(t, dim, amt, key)
                acc = t if acc is None else acc.add(t)
            t = cur.copy()
            t.mul_constant_poly(ea.encode(list(keep)))
            cur = t if acc is None else t.add(acc)
        return cur

    # -- cleartext simulation (oracle for tests; exercises the same layer
    #    construction as the homomorphic path) ------------------------------
    def apply_vector(self, v):
        ea = self.pip.ea
        pal = ea.ctx.pal
        n = ea.nslots
        v = np.asarray(v).copy()
        occurrence: dict[int, int] = {}
        for (edim, colperm) in self.stages:
            occ = occurrence.get(edim, 0)
            occurrence[edim] = occ + 1
            dim, leaf = self.pip.expanded[edim]
            n_dim = self.pip.orders[dim]
            groups = leaf.groups1 if (leaf.mid or occ == 0) else leaf.groups2
            for layer in self._colperm_layers(edim, colperm, groups):
                if not layer:
                    continue
                out = v.copy()
                for dsp, mask in layer.items():
                    amt = (leaf.e * dsp) % n_dim
                    # rotate1D the masked sources by amt
                    for s in np.nonzero(mask)[0]:
                        cs = list(pal.coords(s) if pal.orders else (s,))
                        cs[dim] = (cs[dim] + amt) % n_dim
                        t = (pal.slot_index(tuple(cs)) if pal.orders
                             else cs[0])
                        out[t] = v[s]
                v = out
        return v

    def rotations(self) -> int:
        """Total rotation count of the built network (cost actually paid)."""
        total = 0
        occurrence: dict[int, int] = {}
        for (edim, colperm) in self.stages:
            occ = occurrence.get(edim, 0)
            occurrence[edim] = occ + 1
            dim, leaf = self.pip.expanded[edim]
            groups = leaf.groups1 if (leaf.mid or occ == 0) else leaf.groups2
            for layer in self._colperm_layers(edim, colperm, groups):
                total += len(layer)
        return total

    def needed_rotations(self) -> set[tuple[int, int]]:
        """All (hypercube dim, rotate-1D amount) pairs the network will
        issue in apply() — the input of addMatrices4Network (HElib's
        PermNetwork::getLayer shift enumeration, keySwitching.cpp:667)."""
        need: set[tuple[int, int]] = set()
        occurrence: dict[int, int] = {}
        for (edim, colperm) in self.stages:
            occ = occurrence.get(edim, 0)
            occurrence[edim] = occ + 1
            dim, leaf = self.pip.expanded[edim]
            n_dim = self.pip.orders[dim]
            groups = leaf.groups1 if (leaf.mid or occ == 0) else leaf.groups2
            for layer in self._colperm_layers(edim, colperm, groups):
                for dsp in layer:
                    amt = (leaf.e * dsp) % n_dim
                    if amt:
                        need.add((dim, amt))
        return need
