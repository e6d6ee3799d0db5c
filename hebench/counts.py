"""The least time the card needs for the transforms of one operation.

`conv_bound_ms` and `ntt_bound_ms` are frozen copies of the bounds the
smoke run (chip_smoke.py) puts beside each kernel row, taking shapes
instead of tensors.  `transforms` works out, from a configuration's sizes
alone, which transforms a relinearized product makes: it reads neither the
program's counters nor its launch arguments, so a later kernel that fuses
or splits launches is held to the same work.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet (dense, at 700 W): HBM3 bandwidth.
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiplies a second.  Not a published figure: derived from
# the published 67 TFLOP/s FP32 rate (2 flops an FMA) and Hopper issuing
# INT32 multiplies at half the FP32 lane rate: 67e12 / 2 / 2.
INT32_MUL_PER_S = 67e12 / 4

PRIME_BITS = 30


def conv_bound_ms(x_shape, khat_shape) -> tuple[float, float]:
    """(bytes bound, multiplies bound) in ms for one Bluestein convolution
    launch on x [..., 3, P, B] with spectral kernels khat [3, P, B]: x read
    and out written once, khat/khat_sh and the four [3, B] tables read once;
    3 32-bit multiplies per Shoup product, (B/2) log2 B butterflies each way
    plus the khat and B^-1 products per row."""
    n = x_shape[-1]
    numel = math.prod(x_shape)
    rows = numel // n
    nbytes = 4 * (2 * numel + 2 * math.prod(khat_shape) + 4 * 3 * n + 3)
    muls = rows * 3 * n * (int(math.log2(n)) + 2)
    return nbytes / HBM_BYTES_PER_S * 1e3, muls / INT32_MUL_PER_S * 1e3


def ntt_bound_ms(x_shape, inverse: bool) -> tuple[float, float]:
    """(bytes bound, multiplies bound) in ms for one negacyclic NTT launch
    on x [..., P, n]: x read and out written once, the direction's two flat
    [P, n] tables and q read once; 3 32-bit multiplies per Shoup product,
    (n/2) log2 n butterflies per row plus the n^-1 product of the inverse."""
    n, P = x_shape[-1], x_shape[-2]
    numel = math.prod(x_shape)
    rows = numel // n
    nbytes = 4 * (2 * numel + 2 * P * n + P)
    muls = rows * 3 * ((n // 2) * int(math.log2(n)) + (n if inverse else 0))
    return nbytes / HBM_BYTES_PER_S * 1e3, muls / INT32_MUL_PER_S * 1e3


def chain_sizes(cfg: dict) -> tuple[int, list[int], int]:
    """(ciphertext primes L, digit sizes, special primes S) of a
    configuration: ceil(bits / 29.9) primes of 30 bits in c digits as equal
    as possible, as many special primes as the largest digit."""
    L = max(2, math.ceil(cfg["bits"] / (PRIME_BITS - 0.1)))
    base, rem = divmod(L, cfg["c"])
    digits = [base + (1 if i < rem else 0) for i in range(cfg["c"])]
    digits = [d for d in digits if d > 0]
    return L, digits, max(digits)


def transforms(cfg: dict) -> list[tuple[bool, int]]:
    """(inverse?, rows) of each transform one relinearized product at the
    top level makes, special primes dropped: the digit decomposition's
    inverse of the L rows and, per digit, the forward transform of the rows
    it is extended onto (L + S less its own); then, for each of the two
    parts, the scaled mod-down's inverse of the S special rows and forward
    transform of its correction onto the L rows."""
    L, digits, S = chain_sizes(cfg)
    out = [(True, L)] + [(False, L + S - d) for d in digits]
    return out + [(True, S), (False, L)] * 2


def transform_bound_ms(cfg: dict, batch: int, plan=transforms) -> float:
    """The least time of one call's transforms at `batch` ciphertexts: the
    sum over the transforms `plan(cfg)` gives (by default a relinearized
    product's) of the larger of the bytes and multiplies bounds.  Odd m: a Bluestein convolution of B = 2^ceil(log2(2m-1)) on
    the three auxiliary primes; power-of-2 m: an NTT of n = m/2."""
    m = cfg["m"]
    total = 0.0
    for inverse, rows in plan(cfg):
        if m % 2:
            B = 1 << math.ceil(math.log2(2 * m - 1))
            total += max(conv_bound_ms((batch, 3, rows, B), (3, rows, B)))
        else:
            total += max(ntt_bound_ms((batch, rows, m // 2), inverse))
    return total
