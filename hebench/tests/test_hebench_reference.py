"""The plain reference against known small cases: its primes, its
transforms against the naive sums, decryption of a ciphertext built by
hand, the BGV plaintext ops and the CKKS decode."""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from hebench.reference import numbth, ring, schemes  # noqa: E402


def naive_eval(a, q, points):
    """sum_j a_j x^j mod q at each point, Python ints."""
    return [sum(int(c) * pow(x, j, q) for j, c in enumerate(a)) % q
            for x in points]


def test_primes_and_roots():
    qs = numbth.gen_primes(8009, 3)
    assert qs == sorted(qs, reverse=True)
    for q in qs:
        assert numbth.is_prime(q) and q % 8009 == 1 and q < 2 ** 30
    w = numbth.root_of_unity(8009, qs[0])
    assert pow(w, 8009, qs[0]) == 1 and w != 1
    L, S = numbth.prime_chain(8009, 380, 3, "bgv", 2)
    assert (len(L), len(S)) == (13, 5)
    L, S = numbth.prime_chain(65536, 440, 3, "ckks", -1)
    assert (len(L), len(S)) == (15, 5)


@pytest.mark.parametrize("m", [13, 31])
def test_bluestein_matches_naive_dft(m):
    qs = tuple(numbth.gen_primes(m, 2))
    rng = np.random.default_rng(m)
    a = torch.from_numpy(np.stack([rng.integers(0, q, m) for q in qs]))
    v = ring.to_eval(a, qs, m)
    for r, q in enumerate(qs):
        w = numbth.root_of_unity(m, q)
        assert v[r].tolist() == naive_eval(a[r].tolist(), q,
                                           [pow(w, k, q) for k in range(m)])
    assert torch.equal(ring.to_coeffs(v, qs, m), a)


@pytest.mark.parametrize("m", [16, 64])
def test_negacyclic_matches_naive_and_order(m):
    n = m // 2
    qs = tuple(numbth.gen_primes(m, 2))
    rng = np.random.default_rng(m)
    a = torch.from_numpy(np.stack([rng.integers(0, q, n) for q in qs]))
    v = ring.to_eval(a, qs, m)
    for r, q in enumerate(qs):
        psi = numbth.root_of_unity(2 * n, q)
        pts = [pow(psi, e, q) for e in ring.eval_exponents(n)]
        assert v[r].tolist() == naive_eval(a[r].tolist(), q, pts)
    assert torch.equal(ring.to_coeffs(v, qs, m), a)


def test_garner_balanced():
    qs = tuple(numbth.gen_primes(64, 4))
    xs = [0, 1, -1, 12345678901234567, -(2 ** 100) + 3]
    r = torch.tensor([[x % q for x in xs] for q in qs])
    d = ring.garner_digits(r, qs)
    assert ring.digits_mod(d, qs, 7).tolist() == [x % 7 for x in xs]
    f = ring.digits_float(d, qs)
    assert all(math.isclose(float(fv), x, rel_tol=1e-12, abs_tol=0.5)
               for fv, x in zip(f, xs))


@pytest.mark.parametrize("m", [31, 64])
def test_decrypts_hand_made_ciphertext(m):
    """c1 uniform, c0 = -c1 s + x: decryption gives x back exactly."""
    n = m if m % 2 else m // 2
    qs = tuple(numbth.gen_primes(m, 3))
    rng = np.random.default_rng(3)
    s = rng.integers(-1, 2, n)
    x = rng.integers(-1000, 1000, n)
    sk = ring.SecretKey(s, m)
    q = torch.tensor(qs)[:, None]
    c1 = torch.from_numpy(np.stack([rng.integers(0, p, n) for p in qs]))
    xe = ring.to_eval(torch.from_numpy(x)[None, :].expand(3, -1) % q, qs, m)
    c0 = (xe - c1 * sk.eval(qs)) % q
    d = ring.decrypt_digits(c0[None], c1[None], sk, qs)[0]
    assert ring.digits_float(d, qs).tolist() == x.astype(float).tolist()


def test_bgv_plaintext_ops():
    m, p = 7, 2
    a = torch.tensor([1, 0, 1, 0, 0, 1])           # 1 + X^2 + X^5
    b = torch.tensor([0, 1, 0, 0, 0, 0])           # X
    # X + X^3 + X^6, X^6 = 1 + X + ... + X^5 mod (Phi_7, 2)
    assert schemes.bgv_mul(a, b, m, p).tolist() == [1, 0, 1, 0, 1, 1]
    # a(X^3) = 1 + X^6 + X^15 = 1 + X^6 + X
    assert schemes.bgv_automorph(a, 3, m, p).tolist() == [0, 0, 1, 1, 1, 1]
    assert schemes.bgv_add(a, b, m, p).tolist() == [1, 1, 1, 0, 0, 1]


def test_ckks_decode_matches_naive():
    m = 32
    n = m // 2
    rng = np.random.default_rng(1)
    x = rng.normal(size=n)
    z = schemes.ckks_decode(torch.from_numpy(x), m).numpy()
    zeta = np.exp(1j * np.pi / n)
    want = [sum(x[l] * zeta ** (l * pow(5, j, m)) for l in range(n))
            for j in range(m // 4)]
    assert np.allclose(z, want)


def naive_mulmod(a, b, m, pr):
    """a * b mod (Phi_m, pr) by schoolbook product and long division."""
    prod = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            prod[i + j] += int(x) * int(y)
    phi = schemes.phi_poly(m)
    deg = len(phi) - 1
    for i in range(len(prod) - 1, deg - 1, -1):
        c = prod[i]
        for j, f in enumerate(phi):
            prod[i - deg + j] -= c * f
    return [x % pr for x in prod[:deg]]


@pytest.mark.parametrize("m, pr", [(7, 2), (15, 289), (16, 65537),
                                   (31, 17 ** 2), (9, 4)])
def test_bgv_ops_at_any_m_and_pr(m, pr):
    """Products, sums and automorphisms mod (Phi_m, p^r) at prime,
    composite and power-of-2 m against the schoolbook answers."""
    deg = len(schemes.phi_poly(m)) - 1
    rng = np.random.default_rng(m + pr)
    a, b = (torch.from_numpy(rng.integers(0, pr, (2, deg))) for _ in "ab")
    got = schemes.bgv_mul(a, b, m, pr)
    for r in range(2):
        assert got[r].tolist() == naive_mulmod(a[r].tolist(), b[r].tolist(),
                                               m, pr)
    assert schemes.bgv_add(a, b, m, pr).tolist() == ((a + b) % pr).tolist()
    # a(X^k) by substitution and long division
    k = 7 if m == 16 else 2 if m % 2 else 3
    k = next(j for j in range(k, m) if math.gcd(j, m) == 1)
    sub = [0] * (k * (deg - 1) + 1)
    for j, c in enumerate(a[0].tolist()):
        sub[j * k] += c
    phi = schemes.phi_poly(m)
    for i in range(len(sub) - 1, deg - 1, -1):
        c = sub[i]
        for j, f in enumerate(phi):
            sub[i - deg + j] -= c * f
    assert schemes.bgv_automorph(a, k, m, pr)[0].tolist() == [
        x % pr for x in sub[:deg]]


def test_phi_poly_known():
    assert schemes.phi_poly(7) == (1,) * 7
    assert schemes.phi_poly(16) == (1, 0, 0, 0, 0, 0, 0, 0, 1)
    assert schemes.phi_poly(15) == (1, -1, 0, 1, -1, 1, 0, -1, 1)
    assert schemes.phi_poly(12) == (1, 0, -1, 0, 1)
