"""NTT-friendly prime generation.

Role equivalent: reference src/PrimeGenerator.h:36-60 (primes of the form
k*m + 1 near a target bit size so that order-m roots of unity exist).

Design departure (as in helib_tpu): the device modular arithmetic uses
fixed-width ~30-bit primes (uint32 residues, Barrett/Shoup reduction with 32-bit
multiplies — see helib_tpu_torch/ops/modops.py).  Unlike HElib, which mixes prime
sizes (small/ctxt/special, HELIB_SP_NBITS up to 60), every device prime here
lives in (2^(W-1), 2^W) with W = PRIME_BITS.  Modulus chains are therefore
longer but each limb is cheap; this mirrors the HEXL <=49-bit precedent
(reference src/macro.h:17-21) taken one step further for 32-bit integer lanes.
"""

from __future__ import annotations

from .numbth import is_prime

PRIME_BITS = 30  # device prime width; residues fit uint32, products fit 60 bits

# Auxiliary primes for Bluestein convolutions (general odd m): need power-of-2
# roots of unity of order up to 2^AUX_POW2 (supports m up to 2^(AUX_POW2-2)).
AUX_POW2 = 18


def gen_primes(m: int, count: int, bits: int = PRIME_BITS,
               exclude: frozenset[int] | tuple[int, ...] = (),
               descending: bool = True) -> list[int]:
    """Generate `count` primes q ≡ 1 (mod m) with q in (2^(bits-1), 2^bits).

    For power-of-2 m this also guarantees 2N-th roots (m = 2N), enabling the
    negacyclic NTT; for odd m it guarantees order-m roots for the full-m DFT.
    """
    excl = set(exclude)
    out: list[int] = []
    hi = (1 << bits) - 1
    lo = 1 << (bits - 1)
    k = hi // m
    while len(out) < count and k > 0:
        q = k * m + 1
        if lo < q <= hi and q not in excl and is_prime(q):
            out.append(q)
        k -= 1
    if len(out) < count:
        raise RuntimeError(
            f"only found {len(out)}/{count} primes ≡1 mod {m} at {bits} bits")
    if not descending:
        out.reverse()
    return out


def gen_aux_primes(count: int = 3, bits: int = PRIME_BITS,
                   pow2: int = AUX_POW2) -> list[int]:
    """Global auxiliary primes ≡ 1 mod 2^pow2 for exact Bluestein convolution."""
    return gen_primes(1 << pow2, count, bits=bits)
