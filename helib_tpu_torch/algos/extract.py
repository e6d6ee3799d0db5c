"""Homomorphic base-p digit extraction, the bootstrap's nonlinear core
(helib_tpu.algos.extract).

HElib's extractDigits (src/extractDigits.cpp:28-130): iterated "digit
polynomial" maps; digits[j] ends up holding the j-th base-p digit of each
slot integer, at plaintext space p^(r-j).  Also the Chen-Han lower-degree
digit removal (extractDigits.cpp:131-329).
"""

from __future__ import annotations

from ..nt.numbth import inv_mod
from .polyeval import poly_eval
from ..exceptions import assert_true


def build_digit_polynomial(p: int, e: int) -> list[int]:
    """Degree-p poly F with: z = z0 + p^t*z1 (0<=z0<p, t<e) =>
    F(z) ≡ z0 (mod p^{t+1}).  F(x) = x^p + poly'(x) with poly' interpolating
    z - z^p at the balanced digits (HElib's buildDigitPolynomial)."""
    pe = p**e
    xs = [j - p // 2 for j in range(p)]
    ys = []
    for z in xs:
        v = (z - pow(z % pe, p, pe)) % pe
        if v > pe // 2:
            v -= pe
        ys.append(v)
    # Lagrange interpolation mod p^e (pairwise differences < p, invertible)
    coeffs = [0] * p
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        num = [1]
        den = 1
        for j, xj in enumerate(xs):
            if j == i:
                continue
            num = _poly_mul(num, [(-xj) % pe, 1], pe)
            den = den * (xi - xj) % pe
        f = yi % pe * inv_mod(den % pe, pe) % pe
        for k2, c in enumerate(num):
            coeffs[k2] = (coeffs[k2] + f * c) % pe
    out = coeffs + [0] * (p + 1 - len(coeffs))
    out = out[:p] + [1]          # + x^p
    return out


def _poly_mul(a, b, m):
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] = (out[i + j] + ai * bj) % m
    return out


def extract_digits(ctxt, key, r: int | None = None) -> list:
    """Returns digits[0..r-1]; slot i of digits[j] = j-th base-p digit of the
    integer in slot i of ctxt (HElib's extractDigits, extractDigits.cpp:70)."""
    ctx = ctxt.ctx
    p = ctx.p
    rr = _int_log(ctxt.ptxt_space, p)
    r = rr if (r is None or r <= 0 or r > rr) else r
    x2p = build_digit_polynomial(p, r) if p > 3 else None

    digits = [None] * r
    from ..recryption import _boot_trace
    for i in range(r):
        _boot_trace(f"extractDigits round {i}/{r} (k={ctxt.k})")
        tmp = ctxt.copy()
        for j in range(i):
            _boot_trace(f"  digit {j}: lift (k={digits[j].k})")
            if p == 2:
                digits[j] = digits[j].square(key)
            elif p == 3:
                digits[j] = digits[j].multiply(digits[j], key).multiply(
                    digits[j], key)
            else:
                digits[j] = poly_eval(x2p, digits[j], key)
            _boot_trace(f"  digit {j}: sub+divide (k={tmp.k})")
            tmp = tmp.sub(digits[j])
            tmp.divide_by_p()
        digits[i] = tmp
    return digits


def _int_log(v: int, p: int) -> int:
    r = 0
    while v > 1:
        assert_true(v % p == 0, 'invariant: v % p == 0')
        v //= p
        r += 1
    return r


# ---------------------------------------------------------------------------
# Chen-Han lower-degree digit removal ("Faster Homomorphic Digit Removal";
# HElib's extractDigits.cpp:131-329: compute_a_vals / compute_magic_poly /
# extendExtractDigits)
# ---------------------------------------------------------------------------

def _series_mul(a, b, length, mod):
    out = [0] * length
    for i, ai in enumerate(a[:length]):
        if not ai:
            continue
        for j, bj in enumerate(b[:length - i]):
            out[i + j] = (out[i + j] + ai * bj) % mod
    return out


def _series_inv(a, length, mod):
    """Power-series inverse of a (a[0] invertible) mod `mod`, trunc length."""
    inv0 = inv_mod(a[0] % mod, mod)
    out = [inv0] + [0] * (length - 1)
    for k in range(1, length):
        s = 0
        for i in range(1, min(k, len(a) - 1) + 1):
            s = (s + a[i] * out[k - i]) % mod
        out[k] = (-inv0 * s) % mod
    return out


def compute_a_vals(p: int, e: int) -> list[int]:
    """a[m] = a(m)/m! for m = p..(e-1)(p-1)+1 from the generating series
    p*(x+1)^p / ((x+1)^p - x^p), per Chen-Han (HElib's compute_a_vals,
    extractDigits.cpp:131-167)."""
    from math import comb, gcd
    pe, p2e = p**e, p**(2 * e)
    length = (e - 1) * (p - 1) + 2
    xp1p = [comb(p, i) % p2e for i in range(p + 1)]   # (x+1)^p
    denom = list(xp1p[:length]) + [0] * max(0, length - p - 1)
    if p < length:
        denom[p] = (denom[p] - 1) % p2e               # (x+1)^p - x^p
    inv = _series_inv(denom, length, p2e)
    poly = _series_mul(xp1p, inv, length, p2e)
    poly = [c * p % p2e for c in poly]
    a = [0] * length
    m_fac = 1
    for m in range(2, p):
        m_fac = m_fac * m % p2e
    for m in range(p, length):
        m_fac = m_fac * m % p2e
        c = poly[m]
        d = gcd(m_fac, p2e)
        assert_true(d != 0 and d <= pe and c % d == 0, "cannot divide")
        mfd = (m_fac // d) % pe
        cd = (c // d) % pe
        a[m] = cd * inv_mod(mfd, pe) % pe
    return a


def _poly_add(a, b, m):
    out = [0] * max(len(a), len(b))
    for i, c in enumerate(a):
        out[i] = c % m
    for i, c in enumerate(b):
        out[i] = (out[i] + c) % m
    return out


def compute_magic_poly(p: int, e: int) -> list[int]:
    """Chen-Han magic polynomial G with G(x) ≡ (x mod p) (mod p^e) for all x,
    degree (e-1)(p-1)+1; (x mod p) in [0,1] for p=2, else in (-p/2, p/2)
    (HElib's compute_magic_poly, extractDigits.cpp:173-214)."""
    a = compute_a_vals(p, e)
    pe = p**e
    length = (e - 1) * (p - 1) + 2
    poly = [0]
    term = [1]
    for m in range(p):
        term = _poly_mul(term, [(-m) % pe, 1], pe)
    for m in range(p, length):
        poly = _poly_add(poly, [c * a[m] % pe for c in term], pe)
        term = _poly_mul(term, [(-m) % pe, 1], pe)
    if p % 2 == 1:
        # poly <- poly(X + (p-1)/2)
        sh = (p - 1) // 2
        poly2 = [0]
        for c in reversed(poly):
            poly2 = _poly_add(_poly_mul(poly2, [sh, 1], pe), [c], pe)
        poly = poly2
    # G = X - poly
    res = [(-c) % pe for c in poly]
    while len(res) < 2:
        res.append(0)
    res[1] = (res[1] + 1) % pe
    while len(res) > 1 and res[-1] == 0:
        res.pop()
    return res


def extend_extract_digits(ctxt, key, r: int, e: int) -> list:
    """Chen-Han digit extraction: input slots hold integers mod p^{r+e};
    digits[j] gets the j-th base-p digit with plaintext space p^{e+r-j},
    using the degree-((e+r-j-1)(p-1)+1) magic polynomials instead of repeated
    p-th powers (HElib's extendExtractDigits, extractDigits.cpp:225-329)."""
    ctx = ctxt.ctx
    p = ctx.p
    x2p = build_digit_polynomial(p, r) if p > 3 else None
    G = [compute_magic_poly(p, e + r - i) for i in range(r)]

    digits = [None] * r
    digits0 = [None] * r
    for i in range(r):
        tmp = ctxt.copy()
        for j in range(i):
            if digits[j].capacity() >= digits0[j].capacity():
                # optimization: the magic-poly digit is at a better level
                tmp = tmp.sub(digits[j])
            else:
                if p == 2:
                    digits0[j] = digits0[j].square(key)
                elif p == 3:
                    d = digits0[j]
                    digits0[j] = d.multiply(d, key).multiply(d, key)
                else:
                    digits0[j] = poly_eval(x2p, digits0[j], key)
                tmp = tmp.sub(digits0[j])
            tmp.divide_by_p()
        digits0[i] = tmp
        digits[i] = poly_eval(G[i], tmp, key)
    return digits
