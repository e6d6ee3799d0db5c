"""Polynomial arithmetic and factorization mod p^r (host, exact).

helib_tpu.nt.polymod: the role of the NTL-backed machinery behind HElib's
PAlgebraMod (factoring Phi_m mod p^r into equal-degree factors and building
CRT tables; reference src/PAlgebra.cpp `PAlgebraModDerived`, PolyMod.cpp).

Polynomials are Python lists of ints, low -> high degree, always reduced mod
the working modulus.  Setup-time only; no performance pressure.  The
random draws of `equal_degree_factor` are helib_tpu's, so the factors come
out in the same order.
"""

from __future__ import annotations

import random

from .numbth import inv_mod
from ..exceptions import assert_true


def trim(a):
    while a and a[-1] == 0:
        a = a[:-1]
    return a


def padd(a, b, m):
    n = max(len(a), len(b))
    return trim([((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % m
                 for i in range(n)])


def psub(a, b, m):
    n = max(len(a), len(b))
    return trim([((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % m
                 for i in range(n)])


def pmul(a, b, m):
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % m
    return trim(out)


def pdivmod(a, b, m):
    """Division with remainder; leading coeff of b must be invertible mod m."""
    a = list(a)
    db, da = len(b) - 1, len(a) - 1
    if da < db:
        return [], trim(a)
    inv = inv_mod(b[-1] % m, m)
    q = [0] * (da - db + 1)
    for i in range(da - db, -1, -1):
        c = a[i + db] * inv % m
        q[i] = c
        if c:
            for j in range(db + 1):
                a[i + j] = (a[i + j] - c * b[j]) % m
    return trim(q), trim(a)


def pmod(a, b, m):
    return pdivmod(a, b, m)[1]


def pmulmod(a, b, f, m):
    return pmod(pmul(a, b, m), f, m)


def ppowmod(a, e, f, m):
    r = [1]
    a = pmod(a, f, m)
    while e:
        if e & 1:
            r = pmulmod(r, a, f, m)
        a = pmulmod(a, a, f, m)
        e >>= 1
    return r


def pgcd(a, b, p):
    """GCD mod prime p, monic."""
    a, b = trim([x % p for x in a]), trim([x % p for x in b])
    while b:
        a, b = b, pmod(a, b, p)
    if a:
        inv = inv_mod(a[-1], p)
        a = [x * inv % p for x in a]
    return a


def make_monic(a, m):
    inv = inv_mod(a[-1] % m, m)
    return [x * inv % m for x in a]


def equal_degree_factor(f, d, p, rng=None):
    """Factor monic squarefree f (mod prime p) into irreducible factors all of
    degree d (Cantor-Zassenhaus; GF(2) via trace maps)."""
    rng = rng or random.Random(0xC0FFEE)
    n = len(f) - 1
    assert_true(n % d == 0, 'invariant: n % d == 0')
    if n == d:
        return [make_monic(f, p)]
    while True:
        h = [rng.randrange(p) for _ in range(n)]
        h = trim(h)
        if len(h) <= 1:
            continue
        if p == 2:
            # trace map T(h) = h + h^2 + h^4 + ... + h^(2^(d-1)) mod f
            t = list(h)
            acc = list(h)
            for _ in range(d - 1):
                acc = pmulmod(acc, acc, f, p)
                t = padd(t, acc, p)
            g = pgcd(f, t, p)
        else:
            e = (p**d - 1) // 2
            he = ppowmod(h, e, f, p)
            g = pgcd(f, psub(he, [1], p), p)
        if 0 < len(g) - 1 < n:
            q, rem = pdivmod(f, g, p)
            assert_true(not rem, 'invariant: not rem')
            return equal_degree_factor(g, d, p, rng) + \
                equal_degree_factor(q, d, p, rng)


def poly_xgcd(a, b, p):
    """Extended gcd mod prime p: (g, u, v) with u*a + v*b = g (monic)."""
    r0, r1 = trim([x % p for x in a]), trim([x % p for x in b])
    s0, s1 = [1], []
    t0, t1 = [], [1]
    while r1:
        q, r = pdivmod(r0, r1, p)
        r0, r1 = r1, r
        s0, s1 = s1, psub(s0, pmul(q, s1, p), p)
        t0, t1 = t1, psub(t0, pmul(q, t1, p), p)
    if r0:
        inv = inv_mod(r0[-1], p)
        r0 = [x * inv % p for x in r0]
        s0 = [x * inv % p for x in s0]
        t0 = [x * inv % p for x in t0]
    return r0, s0, t0


def hensel_lift_pair(f, g, h, p, pk):
    """Given f ≡ g*h mod pk (g,h coprime mod p, g monic), lift to mod pk*p...
    One Hensel step from modulus pk to pk*p (linear lift).

    Returns (g', h') with f ≡ g'h' mod (pk*p), g' ≡ g, h' ≡ h mod pk."""
    m = pk * p
    # e = (f - g*h)/pk  mod p
    diff = psub(f, pmul(g, h, m), m)
    e = [(x // pk) % p for x in diff]
    e = trim(e)
    _, u, v = poly_xgcd(g, h, p)  # u*g + v*h = 1 mod p
    # dg = (v*e mod g), dh = u*e + (v*e div g)*h satisfy dg*h + dh*g = e
    q1, dgm = pdivmod(pmul(v, e, p), g, p)
    dh2 = trim([x % p for x in padd(pmul(u, e, p), pmul(q1, h, p), p)])
    gp = padd(g, [pk * x % m for x in dgm], m)
    hp = padd(h, [pk * x % m for x in dh2], m)
    return gp, hp


def lift_factorization(f, factors_mod_p, p, r):
    """Lift f ≡ prod(factors) (mod p) to mod p^r (iterated pairwise lifts).

    factors are monic mod p; returns monic factors mod p^r."""
    if r == 1:
        return [list(fac) for fac in factors_mod_p]

    def lift_split(fpoly, facs, pk_target):
        """Recursively split fpoly ≡ prod facs, lifting mod p -> pk_target."""
        if len(facs) == 1:
            return [make_monic([x % pk_target for x in fpoly], pk_target)]
        mid = len(facs) // 2
        g = facs[0]
        for fac in facs[1:mid]:
            g = pmul(g, fac, p)
        h = facs[mid]
        for fac in facs[mid + 1:]:
            h = pmul(h, fac, p)
        # lift the pair g*h = fpoly from mod p to mod pk_target
        pk = p
        gg, hh = list(g), list(h)
        while pk < pk_target:
            gg, hh = hensel_lift_pair(fpoly, gg, hh, p, pk)
            pk *= p
        return (lift_split(gg, facs[:mid], pk_target) +
                lift_split(hh, facs[mid:], pk_target))

    return lift_split(f, [list(x) for x in factors_mod_p], p**r)


def poly_inv_mod(a, f, p, r=1):
    """Inverse of a mod (f, p^r): xgcd mod p, then Newton-lift to p^r."""
    g, u, _ = poly_xgcd(a, f, p)
    assert_true(g == [1], "not invertible")
    inv = u
    pk = p
    pr = p**r
    while pk < pr:
        pk = pk * pk
        m = min(pk, pr)
        # inv <- inv*(2 - a*inv) mod (f, m)
        t = pmod(pmul(a, inv, m), f, m)
        two_minus = psub([2], t, m)
        inv = pmod(pmul(inv, two_minus, m), f, m)
    return pmod([x % pr for x in inv], f, pr)
