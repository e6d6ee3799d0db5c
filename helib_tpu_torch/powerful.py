"""Powerful-basis representation for composite m = prod m_t (pairwise
coprime) (helib_tpu.powerful).

The role of HElib's powerful.cpp/powerful.h (PowerfulTranslationIndexes,
PowerfulConversion, PowerfulDCRT), made simpler by the representation:
ring elements live mod X^m - 1 (ops/ntt.py), so the powerful basis is the
tensor decomposition

    Z[X]/(X^m - 1)  ~=  (x) Z[X_t]/(X_t^{m_t} - 1),     X -> prod X_t

realized by the CRT index bijection j <-> (j mod m_1, ..., j mod m_k).
Conversions are index permutations (gathers), and the m-point DFT factors
into per-axis m_t-point DFTs -- the structural fact behind the factor-tree
EvalMap (evalmap.py).  Host numpy, bit-identical to helib_tpu.
"""

from __future__ import annotations

import math
from functools import reduce

import numpy as np

from .nt.numbth import inv_mod
from .exceptions import assert_true


class PowerfulBasis:
    def __init__(self, m: int, mvec: list[int]):
        assert_true(reduce(lambda a, b: a * b, mvec, 1) == m,
                    'invariant: prod(mvec) == m')
        for i in range(len(mvec)):
            for j in range(i + 1, len(mvec)):
                assert_true(math.gcd(mvec[i], mvec[j]) == 1,
                            'invariant: mvec pairwise coprime')
        self.m = m
        self.mvec = list(mvec)
        # CRT bijection: j  <->  tuple(j mod m_t); linear index of the tuple
        # in row-major order over mvec.
        k = len(mvec)
        js = np.arange(m, dtype=np.int64)
        coords = [(js % mt) for mt in mvec]
        lin = np.zeros(m, dtype=np.int64)
        for t in range(k):
            stride = int(np.prod(mvec[t + 1:], dtype=np.int64))
            lin = lin + coords[t] * stride
        # poly coefficient j goes to powerful position lin[j]
        self.to_powerful_perm = np.empty(m, dtype=np.int64)
        self.to_powerful_perm[lin] = js       # powerful[pos] = poly[j]
        self.from_powerful_perm = lin         # poly[j] = powerful[lin[j]]
        # crt unit factors: X = prod_t X_t^{u_t} with u_t = (m/m_t)^{-1} mod m_t
        self.crt_units = [(m // mt) * inv_mod((m // mt) % mt, mt) % m
                          for mt in mvec]

    # -- conversions (pure gathers) ---------------------------------------
    def poly_to_powerful(self, coeffs):
        """coeffs indexed by X-power j -> tensor [m_1, ..., m_k]."""
        arr = coeffs[..., self.to_powerful_perm]
        return arr.reshape(*coeffs.shape[:-1], *self.mvec)

    def powerful_to_poly(self, tensor):
        flat = tensor.reshape(*tensor.shape[:-len(self.mvec)], self.m)
        return flat[..., self.from_powerful_perm]

    # -- mod-Phi_m powerful basis (the role of HElib's PowerfulDCRT) -------
    #
    # True powerful basis  prod_t W_t^{j_t},  W_t = X^{m/m_t},
    # j_t < phi(m_t)  — the basis in which recryption rounds and in which
    # the factor-tree EvalMap places/extracts coefficients (evalmap.py).
    # Conversion from the m-length mod-(X^m-1) representation: gather to the
    # W-tensor (X^j = prod W_t^{e_t} with e_t = j * (m/m_t)^{-1} mod m_t),
    # then reduce each axis mod Phi_{m_t} over Z.

    def _w_tables(self):
        if hasattr(self, "_wt"):
            return self._wt
        from .nt.cyclotomic import cyclotomic_poly
        from .nt.numbth import phi_n
        m, mvec = self.m, self.mvec
        phis = [phi_n(mt) for mt in mvec]
        cyc = [[int(c) for c in cyclotomic_poly(mt)] for mt in mvec]
        # gather: full tensor position (e_t) <- poly coeff j
        gather = np.zeros(m, dtype=np.int64)
        for j in range(m):
            lin = 0
            for t, mt in enumerate(mvec):
                e_t = j * inv_mod((m // mt) % mt, mt) % mt
                lin = lin * mt + e_t
            gather[lin] = j
        # scatter: reduced tuple (e_t < phi(m_t)) -> poly exponent j
        grids = np.indices(phis)
        scat = np.zeros(grids.shape[1:], dtype=np.int64)
        for t, mt in enumerate(mvec):
            scat = scat + grids[t] * (m // mt)
        scat %= m
        self._wt = (phis, cyc, gather, scat.reshape(-1))
        return self._wt

    def poly_to_w_powerful(self, vals, N: int) -> np.ndarray:
        """m-length integer coefficient vector (mod X^m - 1) -> flat
        phi(m)-length powerful coordinates, BALANCED mod N (N may be a
        bignum; arithmetic is exact over Z then balanced)."""
        phis, cyc, gather, _ = self._w_tables()
        T = np.array([int(v) for v in np.asarray(vals)],
                     dtype=object)[gather].reshape(self.mvec)
        for t, mt in enumerate(self.mvec):
            phc, ft = cyc[t], phis[t]
            T = np.moveaxis(T, t, 0)
            for i in range(mt - 1, ft - 1, -1):
                c = T[i].copy()
                for l in range(ft + 1):
                    if phc[l]:
                        T[i - ft + l] -= c * phc[l]
            T = np.moveaxis(T, 0, t)
        sl = tuple(slice(0, f) for f in phis)
        flat = T[sl].reshape(-1)
        half = N // 2
        return np.array([((int(v) + half) % N) - half for v in flat],
                        dtype=object)

    def w_powerful_to_poly(self, flat) -> np.ndarray:
        """Flat phi(m)-length powerful coordinates (small ints) -> m-length
        coefficient vector mod X^m - 1 (a scatter; exponent map is
        injective)."""
        _, _, _, scat = self._w_tables()
        out = np.zeros(self.m, dtype=np.int64)
        out[scat] = np.asarray(flat, dtype=np.int64)
        return out

    def __repr__(self):
        return f"PowerfulBasis(m={self.m}, mvec={self.mvec})"


def factor_mvec(m: int) -> list[int]:
    """Default mvec: the prime-power factorization of m."""
    from .nt.numbth import factorize
    return [p**e for p, e in factorize(m)]
