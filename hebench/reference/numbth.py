"""Number theory the reference needs, worked out again from first principles.

The same rules as the program under test states for its parameters: primes
q = k*m + 1 in (2^29, 2^30), taken from the top down, and roots of unity
derived from the smallest primitive root of q.  Plain Python integers; this
module imports nothing of the program.
"""

from __future__ import annotations

import math

PRIME_BITS = 30


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin (bases 2..37, exact below 3.3e24)."""
    if n < 2:
        return False
    bases = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    for p in bases:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in bases:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def prime_factors(n: int) -> list[int]:
    """Distinct prime factors by trial division (n < 2^31 here)."""
    out, d = [], 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


def primitive_root(q: int) -> int:
    """Smallest generator of (Z/qZ)* for a prime q."""
    pf = prime_factors(q - 1)
    g = 2
    while any(pow(g, (q - 1) // f, q) == 1 for f in pf):
        g += 1
    return g


def root_of_unity(order: int, q: int) -> int:
    """g^((q-1)/order) for the smallest generator g of prime q."""
    if (q - 1) % order:
        raise ValueError(f"{order} does not divide {q} - 1")
    return pow(primitive_root(q), (q - 1) // order, q)


def gen_primes(m: int, count: int, exclude=()) -> list[int]:
    """`count` primes q = k*m + 1 in (2^29, 2^30), largest first."""
    out, k = [], ((1 << PRIME_BITS) - 1) // m
    while len(out) < count and k > 0:
        q = k * m + 1
        if (1 << (PRIME_BITS - 1)) < q and q not in exclude and is_prime(q):
            out.append(q)
        k -= 1
    if len(out) < count:
        raise ValueError(f"only {len(out)} of {count} primes for m={m}")
    return out


def prime_chain(m: int, bits: int, c: int, scheme: str, p: int):
    """(ciphertext primes, special primes) of a parameter set: enough 30-bit
    primes for `bits`, split into c digits as equal as possible, and as many
    special primes as the largest digit has."""
    n_ctxt = max(2, math.ceil(bits / (PRIME_BITS - 0.1)))
    base, rem = divmod(n_ctxt, c)
    n_special = base + (1 if rem else 0)
    excl = (p,) if scheme == "bgv" else ()
    primes = gen_primes(m, n_ctxt + n_special, exclude=excl)
    return primes[:n_ctxt], primes[n_ctxt:]
