"""What a decrypted result should be, per scheme, in plain PyTorch.

BGV at any m: plaintexts are polynomials mod (Phi_m(X), p^r); a decrypted
value (in Z[X]/(X^m - 1) at odd m, Z[X]/(X^(m/2) + 1) at power-of-2 m) is
reduced mod p^r and then mod Phi_m.  CKKS at power-of-2 m: slot j is the value
at zeta^(5^j mod m), zeta = exp(i pi / n), of the decrypted coefficients
divided by the ciphertext's scale; a rotation by r moves slot j to j + r.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch


# ---------------------------------------------------------------------- BGV

def _poly_divexact(a: list, b: list) -> list:
    """Exact quotient of integer polynomials (coefficients low first), b
    monic."""
    a, q = list(a), [0] * (len(a) - len(b) + 1)
    for i in range(len(q) - 1, -1, -1):
        c = q[i] = a[i + len(b) - 1]
        if c:
            for j, bj in enumerate(b):
                a[i + j] -= c * bj
    return q


@lru_cache(maxsize=16)
def phi_poly(m: int) -> tuple:
    """The coefficients of the m-th cyclotomic polynomial, low first:
    Phi_m(X) = Phi_rad(X^(m/rad)) for rad the product of m's primes, and
    Phi_(np)(X) = Phi_n(X^p) / Phi_n(X) for a prime p not dividing n."""
    primes, k, d = [], m, 2
    while d * d <= k:
        if k % d == 0:
            primes.append(d)
            while k % d == 0:
                k //= d
        d += 1
    if k > 1:
        primes.append(k)
    poly, n = [-1, 1], 1                       # Phi_1 = X - 1
    for p in primes:
        up = [0] * (len(poly) - 1) * p + [0]
        for i, c in enumerate(poly):
            up[i * p] = c
        poly, n = _poly_divexact(up, poly), n * p
    e = m // n
    out = [0] * ((len(poly) - 1) * e + 1)
    for i, c in enumerate(poly):
        out[i * e] = c
    return tuple(out)


def reduce_phim(a: torch.Tensor, m: int, pr: int) -> torch.Tensor:
    """[..., n] coefficients (any n, read mod X^m - 1) mod (Phi_m, pr).
    Returns [..., phi(m)]."""
    phi = phi_poly(m)
    deg = len(phi) - 1
    if a.shape[-1] > m:
        full = torch.zeros(*a.shape[:-1], m * -(-a.shape[-1] // m),
                           dtype=torch.int64)
        full[..., :a.shape[-1]] = a
        a = full.reshape(*a.shape[:-1], -1, m).sum(-2)
    a = a % pr
    if a.shape[-1] <= deg:
        out = torch.zeros(*a.shape[:-1], deg, dtype=torch.int64)
        out[..., :a.shape[-1]] = a
        return out
    if deg == m - 1:                           # prime m: one step
        return (a[..., :m - 1] - a[..., m - 1:m]) % pr
    if m & (m - 1) == 0:                       # power of 2: X^(m/2) = -1
        full = torch.zeros(*a.shape[:-1], m, dtype=torch.int64)
        full[..., :a.shape[-1]] = a
        return (full[..., :deg] - full[..., deg:]) % pr
    a = a.clone()
    ph = torch.tensor(phi, dtype=torch.int64)
    for i in range(a.shape[-1] - 1, deg - 1, -1):
        c = a[..., i:i + 1]
        a[..., i - deg:i + 1] = (a[..., i - deg:i + 1] - c * ph) % pr
    return a[..., :deg]


def cyclic_mul(a: torch.Tensor, b: torch.Tensor, m: int,
               pr: int) -> torch.Tensor:
    """Exact product mod (X^m - 1, pr) of polynomials [..., <= m] with
    coefficients in [0, pr), through float64 FFTs of 8-bit limbs (each
    limb product sums to under 2^31, far inside float64's 53 bits)."""
    B = 1 << math.ceil(math.log2(2 * m))
    n_limbs = max(1, -(-(pr - 1).bit_length() // 8))
    spec = lambda x: [torch.fft.rfft(((x >> (8 * i)) & 255).to(
        torch.float64), n=B) for i in range(n_limbs)]
    fa, fb = spec(a % pr), spec(b % pr)
    full = torch.zeros(*torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                       B, dtype=torch.int64)
    for t in range(2 * n_limbs - 1):
        acc = sum(fa[i] * fb[t - i] for i in range(n_limbs)
                  if 0 <= t - i < n_limbs)
        val = torch.fft.irfft(acc, n=B)
        rnd = torch.round(val)
        if float((val - rnd).abs().max()) > 0.25:
            raise ArithmeticError("float convolution lost exactness")
        full = (full + rnd.to(torch.int64) % pr * pow(2, 8 * t, pr)) % pr
    return (full[..., :m] + full[..., m:2 * m]) % pr


def bgv_mul(a, b, m: int, pr: int):
    return reduce_phim(cyclic_mul(torch.as_tensor(a), torch.as_tensor(b), m,
                                  pr), m, pr)


def bgv_add(a, b, m: int, pr: int):
    return reduce_phim((torch.as_tensor(a) + torch.as_tensor(b)) % pr, m, pr)


def bgv_automorph(a, k: int, m: int, pr: int):
    """a(X^k) mod (Phi_m, pr)."""
    a = torch.as_tensor(a)
    out = torch.zeros(*a.shape[:-1], m, dtype=torch.int64)
    idx = torch.arange(a.shape[-1]) * k % m
    out.index_add_(-1, idx, a % pr)
    return reduce_phim(out % pr, m, pr)


# --------------------------------------------------------------------- CKKS

def slot_index(m: int) -> torch.Tensor:
    """Position (5^j mod m - 1)/2, j < m/4, of slot j among the values at
    zeta^(2t+1), t < m/2."""
    n_slots = m // 4
    idx, e = [], 1
    for _ in range(n_slots):
        idx.append((e - 1) // 2)
        e = e * 5 % m
    return torch.tensor(idx)


def ckks_decode(x: torch.Tensor, m: int) -> torch.Tensor:
    """Real coefficients [..., n] (already divided by the scale) -> complex
    slots [..., m/4]: sum_l x_l zeta^(l (2t + 1))."""
    n = m // 2
    zeta = torch.exp(1j * math.pi * torch.arange(n, dtype=torch.float64) / n)
    vals = torch.fft.ifft(x.to(torch.complex128) * zeta, dim=-1) * n
    return vals[..., slot_index(m)]
