"""Linearized polynomials: Fp-linear maps on slots as sum c_i * x^{p^i}
(helib_tpu.algos.linpoly).

HElib's buildLinPolyCoeffs (include/helib/NumbTh.h:210,
EncryptedArray::buildLinPolyCoeffs) and the applyLinPoly helpers: any
Fp-linear map L on the slot ring E = GR(p^r, d) is x -> sum_{i<d} c_i
x^{p^i}; the c_i solve a d x d linear system over E (Gaussian elimination
with unit pivots, i.e. nonzero mod p).  Host Python, bit-identical to
helib_tpu; the application runs on the context's device.
"""

from __future__ import annotations

import numpy as np

from ..nt import polymod as pm
from ..exceptions import assert_true


def _e_mul(a, b, G, pr):
    return pm.pmulmod(list(a), list(b), G, pr)


def _e_pow_p(a, p, e_pow, G, pr):
    """Frobenius x -> x^{p^e_pow} in E."""
    out = list(a)
    for _ in range(e_pow):
        out = pm.ppowmod(out, p, G, pr)
    return out


def lin_poly_coeffs(ea, images: list) -> list[np.ndarray]:
    """Solve for c_0..c_{d-1} with sum_i c_i * (Y^k)^{p^i} = images[k].

    images[k]: length-<=d coeff vector (element of E) = desired image of the
    basis element Y^k.  Returns list of d coefficient vectors over Z_{p^r}."""
    d, p, pr = ea.d, ea.p, ea.pr
    G = ea.G
    # A[k][i] = (Y^k)^{p^i} as elements of E
    A = [[None] * d for _ in range(d)]
    for k in range(d):
        bk = [0] * k + [1]
        for i in range(d):
            A[k][i] = _e_pow_p(bk, p, i, G, pr)
    rhs = [pm.trim([int(v) % pr for v in img]) for img in images]
    # Gaussian elimination over E
    n = d
    Arows = [[list(A[k][i]) for i in range(n)] for k in range(n)]
    for col in range(n):
        piv = None
        for row in range(col, n):
            v = Arows[row][col]
            if v and any(x % p for x in v):     # unit in GR(p^r, d)
                piv = row
                break
        assert_true(piv is not None, "singular linearized-poly system")
        Arows[col], Arows[piv] = Arows[piv], Arows[col]
        rhs[col], rhs[piv] = rhs[piv], rhs[col]
        inv = pm.poly_inv_mod(Arows[col][col], G, p, ea.r)
        Arows[col] = [_e_mul(inv, v, G, pr) for v in Arows[col]]
        rhs[col] = _e_mul(inv, rhs[col], G, pr)
        for row in range(n):
            if row == col:
                continue
            f = Arows[row][col]
            if not f:
                continue
            Arows[row] = [pm.psub(v, _e_mul(f, w, G, pr), pr)
                          for v, w in zip(Arows[row], Arows[col])]
            rhs[row] = pm.psub(rhs[row], _e_mul(f, rhs[col], G, pr), pr)
    out = []
    for i in range(n):
        c = np.zeros(d, dtype=np.int64)
        v = rhs[i]
        c[:len(v)] = v
        out.append(c)
    return out


def apply_linearized(ea, ctxt, coeffs: list, key):
    """sum_i encode(c_i) * sigma^{p^i}(ctxt) — applies the linear map
    slot-wise (HElib's applyLinPoly1)."""
    acc = None
    frob = ctxt
    for i, ci in enumerate(coeffs):
        if i > 0:
            frob = frob.copy().frobenius(1, key)
        if not np.any(ci):
            continue
        t = frob.copy()
        t.mul_constant_fat(ea.const_fat(ci))
        acc = t if acc is None else acc.add(t)
    if acc is None:
        acc = ctxt.copy()
        acc.mul_constant_poly(np.zeros(1, dtype=np.int64))
    return acc


def projection_maps(ea) -> list[list[np.ndarray]]:
    """For each j < d: the linearized-poly coefficients extracting slot
    coefficient j into the constant term (used by intraSlot unpack)."""
    maps = []
    for j in range(ea.d):
        images = []
        for k in range(ea.d):
            img = np.zeros(ea.d, dtype=np.int64)
            img[0] = 1 if k == j else 0
            images.append(img)
        maps.append(lin_poly_coeffs(ea, images))
    return maps
