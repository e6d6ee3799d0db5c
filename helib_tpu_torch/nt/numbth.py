"""Host-side number theory utilities.

The roles played by HElib's NumbTh layer (src/NumbTh.cpp,
include/helib/NumbTh.h) on top of NTL/GMP.  Everything here is
exact-integer, runs once at Context-build time on the host, and is
implemented with Python ints / NumPy only.
"""

from __future__ import annotations

import math
from functools import lru_cache
from ..exceptions import assert_true


# ---------------------------------------------------------------------------
# primality / factoring
# ---------------------------------------------------------------------------

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all our prime sizes)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _SMALL_PRIMES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _pollard_rho(n: int) -> int:
    if n % 2 == 0:
        return 2
    x, c = 2, 1
    while True:
        y, d = x, 1
        while d == 1:
            x = (x * x + c) % n
            y = (y * y + c) % n
            y = (y * y + c) % n
            d = math.gcd(abs(x - y), n)
        if d != n:
            return d
        c += 1
        x = c + 1


@lru_cache(maxsize=4096)
def factorize(n: int) -> tuple[tuple[int, int], ...]:
    """Return tuple of (prime, exponent) pairs, ascending.

    Equivalent role: `factorize` (reference NumbTh.h:241).
    """
    if n <= 1:
        return ()
    factors: dict[int, int] = {}
    stack = [n]
    while stack:
        v = stack.pop()
        if v == 1:
            continue
        if is_prime(v):
            factors[v] = factors.get(v, 0) + 1
            continue
        for p in _SMALL_PRIMES:
            if v % p == 0:
                factors[p] = factors.get(p, 0) + 1
                stack.append(v // p)
                break
        else:
            d = _pollard_rho(v)
            stack.append(d)
            stack.append(v // d)
    return tuple(sorted(factors.items()))


def prime_factors(n: int) -> list[int]:
    return [p for p, _ in factorize(n)]


def phi_n(n: int) -> int:
    """Euler totient (reference NumbTh.h:256)."""
    r = 1
    for p, e in factorize(n):
        r *= (p - 1) * p ** (e - 1)
    return r


def divisors(n: int) -> list[int]:
    ds = [1]
    for p, e in factorize(n):
        ds = [d * p**k for d in ds for k in range(e + 1)]
    return sorted(ds)


# ---------------------------------------------------------------------------
# multiplicative structure of (Z/mZ)*
# ---------------------------------------------------------------------------

def mult_order(x: int, m: int) -> int:
    """Multiplicative order of x mod m (reference `multOrd`, NumbTh.h:152)."""
    x %= m
    if math.gcd(x, m) != 1:
        return 0
    order = phi_n(m)
    for p in prime_factors(order):
        while order % p == 0 and pow(x, order // p, m) == 1:
            order //= p
    return order


def primitive_root(p: int) -> int:
    """Smallest primitive root mod prime p."""
    order = p - 1
    pf = prime_factors(order)
    g = 2
    while True:
        if all(pow(g, order // q, p) != 1 for q in pf):
            return g
        g += 1


def root_of_unity(order: int, q: int) -> int:
    """An element of exact multiplicative order `order` mod prime q.

    Requires order | q-1.  Deterministic given (order, q): derived from the
    smallest generator (mirrors the deterministic seeding of root tables in
    reference CModulus.cpp:94-100, though the values differ).
    """
    if (q - 1) % order != 0:
        raise ValueError(f"{order} does not divide {q}-1")
    g = primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    assert_true(mult_order(w, q) == order, 'invariant: mult_order(w, q) == order')
    return w


def find_generators(m: int, p: int) -> tuple[list[int], list[int], list[bool]]:
    """Find generators of (Z/mZ)* / <p> with orders and 'native' flags.

    Returns (gens, orders, native) where native[i] is True iff the order of
    gens[i] in the quotient group equals its order in (Z/mZ)* ("good
    dimension").  Mirrors the role of `findGenerators` (reference
    NumbTh.h:260, PAlgebra.cpp) — greedy selection of generators giving a
    hypercube structure on the quotient group.
    """
    phi = phi_n(m)
    d = mult_order(p, m)
    n_slots = phi // d

    # subgroup generated by p
    sub = {1}
    x = p % m
    while x not in sub:
        sub.add(x)
        x = x * p % m
    cur = set(sub)  # subgroup generated so far: <p, chosen gens>

    gens: list[int] = []
    orders: list[int] = []
    native: list[bool] = []

    units = [x for x in range(1, m) if math.gcd(x, m) == 1]
    while len(cur) < phi:
        # pick the element with the largest order in the quotient group
        best, best_qord = None, 1
        for x in units:
            if x in cur:
                continue
            # order of x in (Z/mZ)*/cur : smallest e with x^e in cur
            e = 1
            y = x
            while y not in cur:
                y = y * x % m
                e += 1
            if e > best_qord:
                best, best_qord = x, e
        if best is None:
            break
        full_ord = mult_order(best, m)
        gens.append(best)
        orders.append(best_qord)
        native.append(full_ord == best_qord and pow(best, best_qord, m) == 1)
        # extend subgroup
        new = set()
        pw = 1
        for _ in range(best_qord):
            for s in cur:
                new.add(s * pw % m)
            pw = pw * best % m
        cur = new

    assert_true(len(cur) == phi, "generator search failed to cover (Z/mZ)*")
    total = 1
    for o in orders:
        total *= o
    assert_true(total == n_slots, (total, n_slots))
    return gens, orders, native


# ---------------------------------------------------------------------------
# modular helpers
# ---------------------------------------------------------------------------

def inv_mod(a: int, m: int) -> int:
    return pow(a, -1, m)


def balanced_mod(a: int, m: int) -> int:
    """Representative of a mod m in (-m/2, m/2]."""
    a %= m
    if a > m // 2 or (m % 2 == 0 and a == m // 2):
        # HElib's balanced reduction picks (-m/2, m/2]; keep a in (-m/2, m/2]
        if a > m - a:
            a -= m
    return a


def crt_combine(residues: list[int], moduli: list[int]) -> int:
    """CRT: value mod prod(moduli) with given residues."""
    q = 1
    for mi in moduli:
        q *= mi
    x = 0
    for r, mi in zip(residues, moduli):
        qi = q // mi
        x += r * qi * inv_mod(qi % mi, mi)
    return x % q


def mobius(n: int) -> int:
    """Moebius mu(n)."""
    fac = factorize(n)
    if any(e > 1 for _, e in fac):
        return 0
    return -1 if len(fac) % 2 else 1


def phim_idempotent(m: int, modulus: int):
    """The CRT idempotent of the Phi_m component of Z_modulus[X]/(X^m - 1):
    Pi with Pi = 1 (mod Phi_m), Pi = 0 (mod (X^m-1)/Phi_m).

    Closed form via Ramanujan sums: Pi = (1/m) sum_k c_m(k) X^k with
    c_m(k) = mu(m/gcd(k,m)) * phi(m)/phi(m/gcd(k,m)); requires
    gcd(m, modulus) = 1.

    Ring elements are represented mod X^m - 1 (ops/ntt.py), so an element
    whose slots are divisible by p need not have a p-divisible
    representative: the cofactor ("junk") components are unconstrained.
    Multiplying a plaintext by Pi zeroes them, zero stays zero under +, *,
    automorphisms and mod switching, and Ctxt.divide_by_p becomes exact in
    the full representation -- the invariant the digit-extraction ladders
    rely on (HElib works mod Phi_m directly, CModulus.h:89)."""
    import numpy as np
    minv = inv_mod(m % modulus, modulus)
    phim = phi_n(m)
    # c_m depends only on g = gcd(k, m): precompute per divisor
    vals = {}
    for g in sorted(set(math.gcd(k, m) for k in
                        ([0] + [d for d in range(1, m + 1) if m % d == 0]))):
        d = m // g
        vals[g] = mobius(d) * (phim // phi_n(d))
    ks = np.arange(m, dtype=np.int64)
    gs = np.gcd(ks, m)
    c = np.zeros(m, dtype=np.int64)
    for g, v in vals.items():
        c[gs == g] = v
    out = (c % modulus) * minv % modulus
    half = modulus // 2
    return np.where(out > half, out - modulus, out)
