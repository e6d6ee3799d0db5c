"""The plain reference's ring arithmetic: evaluation-domain transforms and
decryption, in plain PyTorch on the host (int64 residues, float64 FFTs).

A ciphertext part is a [P, n] tensor of residues, one row per prime, in
the evaluation domain the program's interface defines:

  * power-of-2 m (n = m/2): the ring Z_q[X]/(X^n + 1); entry i is the value
    at psi^E[i], psi = root_of_unity(2n, q) and E the exponent order of a
    radix-2 splitting of X^n + 1 (`eval_exponents`);
  * odd prime m (n = m): Z_q[X]/(X^m - 1); entry j is the value at w^j,
    w = root_of_unity(m, q).

The transforms here are written independently of the program: a radix-2
DFT for power-of-2 m, and for odd m Bluestein's chirp with the length-B
convolution done exactly through float64 FFTs of 10-bit limbs.  Decryption
is <c, (1, s)> in the evaluation domain, the inverse transform, and a
balanced mixed-radix (Garner) reconstruction over every row.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from .numbth import root_of_unity

LIMB = 10                    # bits a limb in the exact float convolution


def power_row(w: int, q: int, n: int) -> torch.Tensor:
    """[w^0, ..., w^(n-1)] mod q as int64."""
    out = torch.empty(n, dtype=torch.int64)
    out[0] = 1
    filled = 1
    while filled < n:
        take = min(filled, n - filled)
        out[filled:filled + take] = out[:take] * pow(w, filled, q) % q
        filled += take
    return out


def eval_exponents(n: int) -> list[int]:
    """Exponents of psi (order 2n) at which the power-of-2 domain holds the
    values: split X^n + 1 = X^n - psi^n in halves down to linear factors,
    each block X^h - psi^e into X^(h/2) -/+ psi^(e/2)."""
    exps = [n]
    while len(exps) < n:
        exps = [x for e in exps for x in (e // 2, e // 2 + n)]
    return exps


def _bitrev(n: int) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n)
    rev = torch.zeros(n, dtype=torch.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def dft_pow2(x: torch.Tensor, w: torch.Tensor, q: torch.Tensor):
    """Cyclic DFT of length n (a power of 2) along the last axis, row r
    with root w[r] of order n mod q[r]: y_t = sum_j x_j w^(tj).
    x [..., P, n] int64 reduced, w and q [P]."""
    n = x.shape[-1]
    qc = q[:, None]
    pw = torch.stack([power_row(int(a), int(b), n // 2 if n > 1 else 1)
                      for a, b in zip(w.tolist(), q.tolist())])
    x = x[..., _bitrev(n)]
    half = 1
    while half < n:
        block = 2 * half
        tw = pw[:, :: n // block][:, :half]            # [P, half]
        xr = x.reshape(*x.shape[:-1], n // block, 2, half)
        u = xr[..., 0, :]
        v = xr[..., 1, :] * tw[:, None, :] % qc[:, None]
        x = torch.stack([(u + v) % qc[:, None], (u - v) % qc[:, None]],
                        dim=-2).reshape(x.shape)
        half = block
    return x


@lru_cache(maxsize=64)
def _pow2_tables(primes: tuple, n: int):
    q = torch.tensor(primes, dtype=torch.int64)
    psi = [root_of_unity(2 * n, p) for p in primes]
    tw = torch.stack([power_row(a, p, n) for a, p in zip(psi, primes)])
    itw = torch.stack([power_row(pow(a, -1, p), p, n)
                       for a, p in zip(psi, primes)])
    omega = torch.tensor([a * a % p for a, p in zip(psi, primes)])
    iomega = torch.tensor([pow(a * a, -1, p) for a, p in zip(psi, primes)])
    ninv = torch.tensor([pow(n, -1, p) for p in primes])[:, None]
    order = torch.tensor([(e - 1) // 2 for e in eval_exponents(n)])
    return q, tw, itw, omega, iomega, ninv, order


def pow2_forward(a: torch.Tensor, primes: tuple) -> torch.Tensor:
    """Coefficients [..., P, n] -> values at psi^E[i]."""
    q, tw, _, omega, _, _, order = _pow2_tables(primes, a.shape[-1])
    b = a % q[:, None] * tw % q[:, None]
    return dft_pow2(b, omega, q)[..., order]


def pow2_inverse(v: torch.Tensor, primes: tuple) -> torch.Tensor:
    """Values at psi^E[i] [..., P, n] -> coefficients."""
    n = v.shape[-1]
    q, _, itw, _, iomega, ninv, order = _pow2_tables(primes, n)
    nat = torch.empty_like(v)
    nat[..., order] = v
    b = dft_pow2(nat, iomega, q) * ninv % q[:, None]
    return b * itw % q[:, None]


def _limbs(x: torch.Tensor) -> list:
    mask = (1 << LIMB) - 1
    return [((x >> (LIMB * i)) & mask).to(torch.float64) for i in range(3)]


def exact_conv_mod(a: torch.Tensor, h_spec: list, B: int, q: torch.Tensor):
    """Cyclic convolution of a [..., P, B] with a kernel given as the rfft of
    its three limbs ([P, B/2+1] each), exact, then mod q [P]."""
    a_spec = [torch.fft.rfft(t, n=B) for t in _limbs(a)]
    out = torch.zeros(a.shape, dtype=torch.int64)
    qc = q[:, None]
    for t in range(5):
        acc = None
        for i in range(3):
            j = t - i
            if 0 <= j < 3:
                term = a_spec[i] * h_spec[j]
                acc = term if acc is None else acc + term
        val = torch.fft.irfft(acc, n=B)
        rnd = torch.round(val)
        if float((val - rnd).abs().max()) > 0.25:
            raise ArithmeticError("float convolution lost exactness")
        shift = torch.tensor([pow(2, LIMB * t, p) for p in q.tolist()])
        out = (out + rnd.to(torch.int64) % qc * shift[:, None] % qc) % qc
    return out


@lru_cache(maxsize=64)
def _bluestein_tables(primes: tuple, m: int, inverse: bool):
    """Chirps and kernel spectra of the length-m DFT with w or w^-1."""
    B = 1 << math.ceil(math.log2(2 * m - 1))
    q = torch.tensor(primes, dtype=torch.int64)
    sq = [(j * j) % m for j in range(m)]
    chirp, h_spec, scale = [], [[], [], []], []
    for p in primes:
        w = root_of_unity(m, p)
        if inverse:
            w = pow(w, -1, p)
        u = pow(w, (m + 1) // 2, p)            # u^2 = w, order m
        up = power_row(u, p, m)
        uip = power_row(pow(u, -1, p), p, m)
        sqt = torch.tensor(sq)
        chirp.append(up[sqt])
        h = torch.zeros(B, dtype=torch.int64)
        h[:m] = uip[sqt]
        h[B - m + 1:] = uip[sqt][1:].flip(0)
        for i, limb in enumerate(_limbs(h)):
            h_spec[i].append(torch.fft.rfft(limb, n=B))
        scale.append(pow(m, -1, p) if inverse else 1)
    return (B, q, torch.stack(chirp), [torch.stack(s) for s in h_spec],
            torch.tensor(scale)[:, None])


def bluestein(x: torch.Tensor, primes: tuple, inverse: bool) -> torch.Tensor:
    """y_k = sum_j x_j w^(+-jk) (times m^-1 for the inverse), x [..., P, m]."""
    m = x.shape[-1]
    B, q, chirp, h_spec, scale = _bluestein_tables(primes, m, inverse)
    qc = q[:, None]
    a = torch.zeros(*x.shape[:-1], B, dtype=torch.int64)
    a[..., :m] = x % qc * chirp % qc
    y = exact_conv_mod(a, h_spec, B, q)[..., :m]
    return y * chirp % qc * scale % qc


def to_eval(a: torch.Tensor, primes: tuple, m: int) -> torch.Tensor:
    if m % 2 == 0:
        return pow2_forward(a, primes)
    return bluestein(a, primes, inverse=False)


def to_coeffs(v: torch.Tensor, primes: tuple, m: int) -> torch.Tensor:
    if m % 2 == 0:
        return pow2_inverse(v, primes)
    return bluestein(v, primes, inverse=True)


def garner_digits(r: torch.Tensor, primes: tuple) -> torch.Tensor:
    """Balanced mixed-radix digits d [..., P, n] of the integer x with
    x = r[i] mod primes[i] and |x| < prod(primes)/2:
    x = d_0 + q_0 (d_1 + q_1 (d_2 + ...)), each d_i in (-q_i/2, q_i/2]."""
    digits = []
    for i, qi in enumerate(primes):
        v = r[..., i, :] % qi
        for j in range(i):
            v = (v - digits[j]) % qi * pow(primes[j], -1, qi) % qi
        digits.append(torch.where(v > qi // 2, v - qi, v))
    return torch.stack(digits, dim=-2)


def digits_mod(d: torch.Tensor, primes: tuple, p: int) -> torch.Tensor:
    """The integer of balanced digits d, reduced mod p."""
    acc = torch.zeros(d.shape[:-2] + d.shape[-1:], dtype=torch.int64)
    w = 1
    for i, qi in enumerate(primes):
        acc = (acc + d[..., i, :] % p * (w % p)) % p
        w *= qi
    return acc


def digits_float(d: torch.Tensor, primes: tuple) -> torch.Tensor:
    """The integer of balanced digits d as float64, highest digit first."""
    acc = torch.zeros(d.shape[:-2] + d.shape[-1:], dtype=torch.float64)
    weights = [1]
    for qi in primes[:-1]:
        weights.append(weights[-1] * qi)
    for i in reversed(range(len(primes))):
        acc = acc + d[..., i, :].to(torch.float64) * float(weights[i])
    return acc


class SecretKey:
    """The secret key's coefficients and its value in the evaluation domain
    of each prime set asked for."""

    def __init__(self, coeffs, m: int):
        self.coeffs = torch.as_tensor(coeffs, dtype=torch.int64)
        self.m = m
        self._eval: dict = {}

    def eval(self, primes: tuple) -> torch.Tensor:
        if primes not in self._eval:
            q = torch.tensor(primes, dtype=torch.int64)[:, None]
            a = self.coeffs[None, :].expand(len(primes), -1) % q
            self._eval[primes] = to_eval(a.contiguous(), primes, self.m)
        return self._eval[primes]


def decrypt_digits(c0: torch.Tensor, c1: torch.Tensor, sk: SecretKey,
                   primes: tuple) -> torch.Tensor:
    """Balanced digits of <(c0, c1), (1, s)> in the coefficient domain,
    for parts [..., P, n] on `primes`."""
    q = torch.tensor(primes, dtype=torch.int64)[:, None]
    x = (c0 % q + c1 % q * sk.eval(primes)) % q
    return garner_digits(to_coeffs(x, primes, sk.m), primes)
