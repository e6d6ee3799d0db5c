"""Structure of (Z/mZ)* and the slot hypercube.

helib_tpu.palgebra, the role of HElib's PAlgebra (include/helib/PAlgebra.h,
src/PAlgebra.cpp): generators of (Z/mZ)*/<p>, hypercube signature, slot
representatives, and automorphism index-permutation tables.  With `mvec`
the hypercube is the factor-aligned one of nt/factoralign.py (one generator
per factor of m, as the bootstrapping contexts need).

Representation choice (differs from reference): ring elements live in the
evaluation domain at
  * pow2 m  : the phi(m) primitive 2N-th roots (negacyclic NTT order, as
              generated by ops/ntt.py `eval_exponents`), or
  * odd m   : ALL m m-th roots (element of Z_q[X]/(X^m-1)); index j is the
              evaluation at omega^j directly.
Automorphisms X -> X^k are pure index permutations in both cases.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import math

import numpy as np

from .nt.numbth import phi_n, mult_order, find_generators, factorize
from .nt.cyclotomic import cyclotomic_poly
from .exceptions import assert_true


@dataclass
class PAlgebra:
    m: int
    p: int                      # plaintext prime (for CKKS: p irrelevant, use -1)
    mvec: tuple | None = None   # factor-aligned hypercube (for EvalMap)
    gens: list = field(init=False)
    orders: list = field(init=False)
    native: list = field(init=False)
    phi_m: int = field(init=False)
    d: int = field(init=False)           # order of p in (Z/mZ)*
    nslots: int = field(init=False)
    pow2: bool = field(init=False)
    n_eval: int = field(init=False)      # evaluation-domain width (N or m)
    eval_exponents: np.ndarray | None = None  # set by Context for pow2 m
    aligned: dict | None = None          # factor-aligned structure data

    def __post_init__(self):
        m, p = self.m, self.p
        self.phi_m = phi_n(m)
        self.pow2 = (m & (m - 1)) == 0
        assert_true(self.pow2 or m % 2 == 1, "only power-of-2 or odd m supported")
        self.n_eval = m // 2 if self.pow2 else m
        if p > 0:
            assert_true(math.gcd(m, p) == 1, "p must be coprime to m")
            self.d = mult_order(p, m)
            self.nslots = self.phi_m // self.d
            if self.mvec is not None:
                from .nt.factoralign import factor_aligned_structure
                s = factor_aligned_structure(m, p, list(self.mvec))
                self.aligned = s
                self.gens = list(s["gens"])
                self.orders = list(s["orders"])
                self.native = list(s["native"])
            else:
                self.gens, self.orders, self.native = find_generators(m, p)
        else:  # CKKS
            self.d = 1
            self.nslots = self.phi_m // 2
            self.gens, self.orders, self.native = [], [], []

    # -- hypercube ---------------------------------------------------------
    def coords(self, slot: int) -> tuple:
        """Slot index -> hypercube coordinates (row-major over orders)."""
        cs = []
        for o in reversed(self.orders):
            cs.append(slot % o)
            slot //= o
        return tuple(reversed(cs))

    def slot_index(self, coords) -> int:
        s = 0
        for c, o in zip(coords, self.orders):
            s = s * o + c
        return s

    @property
    def n_factors(self) -> int:
        return len(factorize(self.m))

    def representatives(self) -> list[int]:
        """T[slot] = prod g_i^{e_i} mod m, one representative of each coset
        of <p> in (Z/mZ)*, ordered by hypercube index (HElib's zmsRep)."""
        reps = []
        for s in range(self.nslots):
            cs = self.coords(s)
            t = 1
            for g, e in zip(self.gens, cs):
                t = t * pow(g, e, self.m) % self.m
            reps.append(t)
        return reps

    # -- evaluation-order bookkeeping -------------------------------------
    def exponents(self) -> np.ndarray:
        """Exponent (of the 2N-th root for pow2 / m-th root for odd m)
        evaluated at each data index."""
        if self.pow2:
            assert_true(self.eval_exponents is not None, "Context must attach NTT order")
            return self.eval_exponents % (2 * self.n_eval)
        return np.arange(self.m, dtype=np.int64)

    def automorph_perm(self, k: int) -> np.ndarray:
        if not hasattr(self, "_perm_cache"):
            self._perm_cache = {}
        if k in self._perm_cache:
            return self._perm_cache[k]
        p = self._automorph_perm(k)
        self._perm_cache[k] = p
        return p

    def _automorph_perm(self, k: int) -> np.ndarray:
        """Gather indices g such that new[j] = old[g[j]] applies X -> X^k.

        new eval at exponent e equals old eval at exponent e*k (both mod the
        root order)."""
        ordm = 2 * self.n_eval if self.pow2 else self.m
        assert_true(math.gcd(k, ordm if self.pow2 else self.m) == 1, 'invariant: math.gcd(k, ordm if self.pow2 else self.m) == 1')
        exps = self.exponents()
        pos = -np.ones(ordm, dtype=np.int64)
        pos[exps] = np.arange(len(exps))
        tgt = (exps * (k % ordm)) % ordm
        g = pos[tgt]
        assert_true((g >= 0).all(), "automorphism leaves evaluation set")
        return g.astype(np.int32)

    def phim_poly(self) -> np.ndarray:
        return np.array(cyclotomic_poly(self.m), dtype=object)

    def __repr__(self):
        return (f"PAlgebra(m={self.m}, p={self.p}, phi={self.phi_m}, d={self.d}, "
                f"nslots={self.nslots}, gens={self.gens}, orders={self.orders}, "
                f"native={self.native})")
