"""Factor-aligned hypercube structure for composite m = prod m_t.

helib_tpu.nt.factoralign: the generator/representative bookkeeping inside
HElib's EvalMap (src/EvalMap.cpp:85-115 dprodvec/dvec/init_representatives):
choose one hypercube generator per coprime factor m_t (CRT-lifted so it is
1 modulo the other factors), with the reference's relative-degree tower

    dprod[nf] = 1;  dprod[t] = dprod[t+1] * ord_{m_t}(p^{dprod[t+1]})

and local representative sets R_t = {g_t^i : i < phi(m_t)/d_t}.  The factor
tree EvalMap requires this alignment (the greedy generators of
nt/numbth.find_generators generally are not factor-aligned).
"""

from __future__ import annotations

import math
from functools import reduce

from .numbth import (phi_n, mult_order, primitive_root, factorize,
                     crt_combine)
from ..exceptions import assert_true


def factor_aligned_structure(m: int, p: int, mvec: list[int]):
    """Returns dict with:
      gens    : CRT-lifted generators (one per factor with D_t > 1)
      orders  : dim sizes D_t
      native  : whether g^{D_t} is in <p> mod m
      dims_factor : which factor each dim belongs to
      d       : total ord(p) in (Z/mZ)*
      dvec    : relative degrees per factor
      local_reps : per factor, the exponents i < D_t (reps g_t^i mod m_t)
      local_gens : per factor, the generator of (Z/m_t)*
    Raises if the inert-prefix condition fails (same as the reference)."""
    nf = len(mvec)
    assert_true(reduce(lambda a, b: a * b, mvec, 1) == m, 'invariant: reduce(lambda a, b: a * b, mvec, 1) == m')
    for i in range(nf):
        for j in range(i + 1, nf):
            assert_true(math.gcd(mvec[i], mvec[j]) == 1, 'invariant: math.gcd(mvec[i], mvec[j]) == 1')
        assert_true(mvec[i] % 2 == 1, "factor-aligned path expects odd factors")
        # prefix factors need a CYCLIC unit group (their whole group is the
        # hypercube dim); the LAST factor only needs a cyclic quotient
        # (Z/m_t)*/<p> — this admits the reference's composite last factors,
        # e.g. m=35113 mvec {37, 949=13*73} (bgv_thinboot.cpp:129-145)
        if i != nf - 1:
            assert_true(len(factorize(mvec[i])) == 1,
                        "prefix factors must be prime powers (cyclic unit groups)")
    dprod = [1] * (nf + 1)
    for t in reversed(range(nf)):
        p_t = pow(p, dprod[t + 1], mvec[t])
        dprod[t] = dprod[t + 1] * mult_order(p_t, mvec[t])
    d = dprod[0]
    assert_true(d == mult_order(p, m), (d, mult_order(p, m)))
    dvec = [dprod[t] // dprod[t + 1] for t in range(nf)]
    # reference inertPrefix requirement: all the relative degree lives in the
    # LAST factor (EvalMap.cpp:104-110)
    inert = 0
    while inert < nf and dvec[inert] == 1:
        inert += 1
    if inert != nf - 1 and not (inert == nf and d == 1):
        raise ValueError(f"EvalMap case not handled: dvec={dvec} "
                         f"(relative degree must sit in the last factor)")

    gens, orders, native, dims_factor = [], [], [], []
    local_gens, local_reps = [], []
    for t in range(nf):
        mt = mvec[t]
        D_t = phi_n(mt) // dvec[t]
        if len(factorize(mt)) == 1:
            g_local = primitive_root_pp(mt)
        else:
            # composite last factor: find a generator of the (cyclic)
            # quotient (Z/m_t)*/<p^{dprod[t+1]}>, the role of the
            # reference's FindGenerators over zMStar (NumbTh.cpp) for
            # non-cyclic unit groups.  Raises if the quotient is not
            # cyclic (no element of order D_t).
            g_local = quotient_generator(mt, pow(p, dprod[t + 1], mt), D_t)
        local_gens.append(g_local)
        local_reps.append(list(range(D_t)))
        if D_t == 1:
            continue
        # CRT lift: g ≡ g_local (mod m_t), g ≡ 1 (mod m/m_t)
        g = crt_combine([g_local % mt] + [1] * (nf - 1),
                        [mt] + [mv for i2, mv in enumerate(mvec) if i2 != t])
        gens.append(g)
        orders.append(D_t)
        dims_factor.append(t)
        # native iff g^{D_t} lies in <p> mod m
        gD = pow(g, D_t, m)
        in_p = False
        x = 1
        for _ in range(d):
            if x == gD:
                in_p = True
                break
            x = x * p % m
        native.append(in_p)
    # sanity: products of gens^{e} form a transversal of <p> in (Z/mZ)*
    seen = set()
    def gen_products(idx, cur):
        if idx == len(gens):
            for i in range(d):
                seen.add(cur * pow(p, i, m) % m)
            return
        for e in range(orders[idx]):
            gen_products(idx + 1, cur * pow(gens[idx], e, m) % m)
    gen_products(0, 1)
    assert_true(len(seen) == phi_n(m), f"factor-aligned reps do not form a transversal ({len(seen)} != {phi_n(m)})")
    return {"gens": gens, "orders": orders, "native": native,
            "dims_factor": dims_factor, "d": d, "dvec": dvec,
            "local_gens": local_gens, "local_reps": local_reps,
            "dprod": dprod}


def quotient_generator(mt: int, p_t: int, D_t: int) -> int:
    """Element of (Z/mt)* whose image generates the order-D_t quotient
    (Z/mt)*/<p_t>; raises ValueError if the quotient is not cyclic."""
    H = set()
    x = 1
    while x not in H:
        H.add(x)
        x = x * p_t % mt
    assert_true(len(H) * D_t == phi_n(mt), "quotient size mismatch")
    # proper divisors of D_t (quotient-order check: g^e in H for e | D_t)
    divs = [e for e in range(1, D_t) if D_t % e == 0]
    fallback = None
    for g in range(2, mt):
        if math.gcd(g, mt) != 1 or pow(g, D_t, mt) not in H:
            continue
        if all(pow(g, e, mt) not in H for e in divs):
            # prefer a g whose TRUE order is D_t: then g^{D_t} = 1 and the
            # dimension is native/good (the reference's positive ord, e.g.
            # +24 for m=35113's second dim)
            if pow(g, D_t, mt) == 1:
                return g
            if fallback is None:
                fallback = g
    if fallback is not None:
        return fallback
    raise ValueError(f"quotient (Z/{mt})*/<p> is not cyclic "
                     f"(no element of order {D_t})")


def find_aligned_mvec(m: int, p: int) -> list[int] | None:
    """Search factor orderings of m (prime powers, plus merged composite
    LAST factors a la the reference's mvec {37,949} for m=35113) for one
    satisfying the inert-prefix condition; None if no ordering works (then
    the relative degree is inherently split across factors, as for
    m=45/p=2)."""
    from itertools import permutations
    base = [q**e for q, e in factorize(m)]
    for perm in permutations(base):
        try:
            factor_aligned_structure(m, p, list(perm))
            return list(perm)
        except (ValueError, AssertionError):
            continue
    # merge a subset of factors into one composite LAST factor
    if len(base) > 2:
        from itertools import combinations
        for k in range(2, len(base)):
            for sub in combinations(range(len(base)), k):
                last = 1
                for i in sub:
                    last *= base[i]
                rest = [b for i, b in enumerate(base) if i not in sub]
                for perm in permutations(rest):
                    try:
                        mv = list(perm) + [last]
                        factor_aligned_structure(m, p, mv)
                        return mv
                    except (ValueError, AssertionError):
                        continue
    return None


def primitive_root_pp(q: int) -> int:
    """Generator of the (cyclic) unit group of an odd prime power."""
    fac = factorize(q)
    assert_true(len(fac) == 1 and fac[0][0] % 2 == 1, 'invariant: len(fac) == 1 and fac[0][0] % 2 == 1')
    pr, e = fac[0]
    g = primitive_root(pr)
    if e == 1:
        return g
    # lift: g or g + pr generates mod pr^2 (hence mod pr^e)
    if pow(g, pr - 1, pr * pr) == 1:
        g += pr
    assert_true(mult_order(g, q) == phi_n(q), 'invariant: mult_order(g, q) == phi_n(q)')
    return g
