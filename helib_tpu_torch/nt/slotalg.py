"""Vectorized slot-algebra construction for large m (numpy, host-side).

helib_tpu.nt.slotalg, in the role of HElib's PAlgebraModDerived table
construction (src/PAlgebra.cpp — factorization of Phi_m mod p^r, CRT
tables, mapToSlots) — but built DIRECTLY instead of by generic polynomial
factorization: the irreducible factors of Phi_m mod p are the minimal
polynomials of zeta^t over GF(p), zeta an order-m element of GF(p^d)
(d = ord_p mod m), t running over the slot representatives.  Computing each
factor as prod_j (Y - zeta^{t p^j}) with batched numpy GF(p^d) arithmetic
replaces Cantor-Zassenhaus equal-degree factorization (pure-Python
O(phi(m)^2) at large degree) with O(nslots * d^3) vectorized work, and the
per-factor quadratic Hensel lift to p^r costs O(phi(m) * d) per Newton step
per slot (all batched).

Everything here is exact integer arithmetic (int64 with 15-bit split matmuls
where products could overflow; all moduli p^r < 2^30).  The tables stay in
host numpy: the device has no exact int64 matmul.  The random draws
(`find_irreducible`, `order_m_element`) are helib_tpu's, so the tables are
bit-identical to its.
"""

from __future__ import annotations

import numpy as np

from .numbth import prime_factors
from . import polymod as pm
from ..exceptions import assert_true


# ---------------------------------------------------------------------------
# exact float64-blocked integer matmul (entries < 2^30, inner dim <= ~2^11)
# ---------------------------------------------------------------------------

def exact_matmul(A: np.ndarray, B: np.ndarray, mod: int) -> np.ndarray:
    """(A @ B) % mod for int64 A, B with entries in [0, 2^30): split each
    factor into 15-bit halves so the four float64 BLAS products are exact
    (|partial sums| < 2^15 * 2^15 * K < 2^53 for inner dim K < 2^23)."""
    A = np.asarray(A, dtype=np.int64)
    B = np.asarray(B, dtype=np.int64)
    a_hi, a_lo = (A >> 15).astype(np.float64), (A & 0x7FFF).astype(np.float64)
    b_hi, b_lo = (B >> 15).astype(np.float64), (B & 0x7FFF).astype(np.float64)
    hh = (a_hi @ b_hi).astype(np.int64) % mod
    hl = (a_hi @ b_lo).astype(np.int64) % mod
    lh = (a_lo @ b_hi).astype(np.int64) % mod
    ll = (a_lo @ b_lo).astype(np.int64) % mod
    return (((hh << 30) + ((hl + lh) << 15) + ll) % mod)


# ---------------------------------------------------------------------------
# batched GF(p^r)[Y]/h arithmetic: elements are [batch, d] int64 arrays
# ---------------------------------------------------------------------------

class GaloisBatch:
    """Batched arithmetic in R = Z_{q}[Y]/(h), h monic of degree d (q = p or
    p^r; a field for q = p, a Galois ring for q = p^r)."""

    def __init__(self, h, q: int):
        h = [int(c) % q for c in h]
        assert_true(h[-1] == 1, "h must be monic")
        self.q = q
        self.d = d = len(h) - 1
        self.h = np.array(h, dtype=np.int64)
        # R[i] = Y^{d+i} mod h as a length-d row, i < d-1
        R = np.zeros((max(d - 1, 0), d), dtype=np.int64)
        cur = (-self.h[:d]) % q          # Y^d mod h
        for i in range(d - 1):
            R[i] = cur
            nxt = np.zeros(d, dtype=np.int64)
            nxt[1:] = cur[:d - 1]
            nxt = (nxt + cur[d - 1] * ((-self.h[:d]) % q)) % q
            cur = nxt
        self.R = R

    def mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """[batch, d] x [batch, d] -> [batch, d] (broadcasts batch dims)."""
        q, d = self.q, self.d
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        batch = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        conv = np.zeros(batch + (2 * d - 1,), dtype=np.int64)
        for i in range(d):
            conv[..., i:i + d] = (conv[..., i:i + d]
                                  + a[..., i:i + 1] * b) % q
        low = conv[..., :d]
        if d > 1:
            high = conv[..., d:]
            hi2 = high.reshape(-1, d - 1)
            red = exact_matmul(hi2, self.R, q).reshape(batch + (d,))
            low = (low + red) % q
        return low

    def pow_int(self, a: np.ndarray, e: int) -> np.ndarray:
        """a^e, same exponent for the whole batch."""
        out = np.zeros_like(np.asarray(a, dtype=np.int64))
        out[..., 0] = 1
        base = np.asarray(a, dtype=np.int64)
        while e:
            if e & 1:
                out = self.mul(out, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return out

    def pow_vec(self, a: np.ndarray, es: np.ndarray) -> np.ndarray:
        """a (single element, [d]) raised to per-row exponents es [batch]."""
        es = np.asarray(es, dtype=np.int64)
        nb = len(es)
        out = np.zeros((nb, self.d), dtype=np.int64)
        out[:, 0] = 1
        base = np.asarray(a, dtype=np.int64).reshape(1, self.d)
        bits = int(es.max()).bit_length() if nb else 0
        for i in range(bits):
            sel = ((es >> i) & 1).astype(bool)
            if sel.any():
                out[sel] = self.mul(out[sel], base)
            base = self.mul(base, base)
        return out


# ---------------------------------------------------------------------------
# order-m element of GF(p^d) and batched minimal polynomials
# ---------------------------------------------------------------------------

def find_irreducible(p: int, d: int, seed: int = 5) -> list[int]:
    """Random monic irreducible of degree d over GF(p) (Rabin test via pm;
    degree is small — the slot dimension d)."""
    if d == 1:
        return [0, 1]
    rng = np.random.default_rng(seed)
    x = [0, 1]
    while True:
        h = [int(v) for v in rng.integers(0, p, d)] + [1]
        # x^{p^d} == x mod h and gcd(x^{p^{d/l}} - x, h) == 1 for prime l | d
        xp = pm.ppowmod(x, p**d, h, p)
        if pm.trim(pm.psub(xp, x, p)):
            continue
        ok = True
        for l in prime_factors(d):
            xq = pm.ppowmod(x, p**(d // l), h, p)
            g = pm.pgcd(pm.psub(xq, x, p), h, p)
            if len(g) != 1:
                ok = False
                break
        if ok:
            return h


def order_m_element(m: int, p: int, d: int, h: list[int],
                    seed: int = 7) -> np.ndarray:
    """zeta of multiplicative order exactly m in GF(p^d) = GF(p)[z]/h."""
    assert_true((p**d - 1) % m == 0, "m must divide p^d - 1")
    F = GaloisBatch(h, p)
    co = (p**d - 1) // m
    rng = np.random.default_rng(seed)
    qs = prime_factors(m)
    while True:
        u = rng.integers(0, p, (1, d)).astype(np.int64)
        if not u.any():
            continue
        z = F.pow_int(u, co)[0]
        if not z[1:].any() and z[0] in (0, 1):   # in GF(p) subfield corner
            if m == 1:
                return z
        ok = z.any()
        for qq in qs:
            w = F.pow_int(z.reshape(1, -1), m // qq)[0]
            if not w[1:].any() and w[0] == 1:
                ok = False
                break
        if ok:
            return z


def batched_minpolys(m: int, p: int, d: int, reps, h: list[int],
                     zeta: np.ndarray) -> np.ndarray:
    """[nreps, d+1] minimal polynomials F_t = prod_{j<d} (Y - zeta^{t p^j})
    over GF(p) (coefficients land in the prime field)."""
    F = GaloisBatch(h, p)
    reps = np.asarray(reps, dtype=np.int64)
    nr = len(reps)
    roots = F.pow_vec(zeta, reps % m)          # zeta^t
    # P[t] = prod_j (Y - root_j),  root_{j+1} = root_j^p
    P = np.zeros((nr, d + 1, d), dtype=np.int64)
    P[:, 0, 0] = 1                              # constant poly 1
    deg = 0
    cur = roots
    for j in range(d):
        negc = (-cur) % p
        newP = np.zeros_like(P)
        newP[:, 1:deg + 2] = P[:, :deg + 1]
        prod = F.mul(P[:, :deg + 1].reshape(-1, d),
                     np.repeat(negc, deg + 1, axis=0)).reshape(nr, deg + 1, d)
        newP[:, :deg + 1] = (newP[:, :deg + 1] + prod) % p
        P = newP
        deg += 1
        if j < d - 1:
            cur = F.pow_int(cur, p)
    assert_true(not P[:, :, 1:].any(), "minimal poly has non-GF(p) coefficients")
    out = P[:, :, 0]
    assert_true((out[:, d] == 1).all(), 'invariant: (out[:, d] == 1).all()')
    return out


# ---------------------------------------------------------------------------
# batched polynomial kernels over Z_{p^r} (rows = slots)
# ---------------------------------------------------------------------------

def batched_divmod(A: np.ndarray, F: np.ndarray, q: int):
    """Row-wise synthetic division A = Q*F + R with F monic [rows, d+1];
    A [rows, n].  Returns (Q [rows, n-d], R [rows, d]).

    Works on the transposed [n, rows] layout so each reduction step touches
    a contiguous [d, rows] block (the row-major column slice thrashes the
    cache once n*rows outgrows L2)."""
    A = np.asarray(A, dtype=np.int64) % q
    F = np.asarray(F, dtype=np.int64) % q
    rows, n = A.shape
    d = F.shape[1] - 1
    work = np.ascontiguousarray(A.T)            # [n, rows]
    FlT = np.ascontiguousarray(F[:, :d].T)      # [d, rows]
    nq = n - d
    Q = np.zeros((max(nq, 0), rows), dtype=np.int64)
    for i in range(nq - 1, -1, -1):
        c = work[i + d]
        Q[i] = c
        work[i:i + d] = (work[i:i + d] - c[None, :] * FlT) % q
    R = np.ascontiguousarray(work[:d].T) % q
    if R.shape[1] < d:  # n < d: remainder is A itself, padded to degree d-1
        R = np.concatenate(
            [R, np.zeros((rows, d - R.shape[1]), dtype=np.int64)], axis=1)
    return np.ascontiguousarray(Q.T), R


def batched_divmod_same(a: np.ndarray, f: np.ndarray, q: int):
    """Synthetic division of ONE dividend by per-row monic divisors: a [n]
    broadcast over rows of f [rows, df+1]."""
    rows = f.shape[0]
    A = np.broadcast_to(np.asarray(a, dtype=np.int64) % q,
                        (rows, len(a))).copy()
    d = f.shape[1] - 1
    if A.shape[1] > 8 * max(d, 1) and d > 1:
        return batched_divmod_fold(A, f, q)
    return batched_divmod(A, f, q)


def _fold_matrices(F: np.ndarray, q: int):
    """Per-row matrices for d-step folding mod monic F [rows, d+1]:
    MB[:, :, j] = Y^{d+j} mod F  (reduction),
    QM[:, :, j] = quotient of Y^{d+j} by F (degree <= j < d).
    Both follow the recursion Y^{d+j} = Y * Y^{d+j-1}:
      M_j = (Y*M_{j-1} mod F),  G_j = Y*G_{j-1} + topcoeff(M_{j-1})."""
    F = np.asarray(F, dtype=np.int64) % q
    rows, dp1 = F.shape
    d = dp1 - 1
    MB = np.zeros((rows, d, d), dtype=np.int64)
    QM = np.zeros((rows, d, d), dtype=np.int64)
    negF = (-F[:, :d]) % q
    cur = negF.copy()            # Y^d mod F
    g = np.zeros((rows, d), dtype=np.int64)
    g[:, 0] = 1                  # quotient of Y^d by F is 1
    for j in range(d):
        MB[:, :, j] = cur
        QM[:, :, j] = g
        if j < d - 1:
            top = cur[:, d - 1].copy()
            nxt = np.zeros_like(cur)
            nxt[:, 1:] = cur[:, :d - 1]
            cur = (nxt + top[:, None] * negF) % q
            gn = np.zeros_like(g)
            gn[:, 1:] = g[:, :d - 1]
            gn[:, 0] = top
            g = gn % q
    return MB, QM


def _bmv(M: np.ndarray, v: np.ndarray, q: int) -> np.ndarray:
    """Exact batched [rows,d,d] @ [rows,d] mod q via 15-bit split."""
    hi = np.einsum('rij,rj->ri', M >> 15, v) % q
    lo = np.einsum('rij,rj->ri', M & 0x7FFF, v)
    return ((hi << 15) + lo) % q


def batched_divmod_fold(A: np.ndarray, F: np.ndarray, q: int):
    """Blocked synthetic division (quotient AND remainder): the block-Horner
    fold of batched_rem_long, additionally emitting the quotient block
    QM @ acc at every step — O(n/d) batched matvecs instead of the O(n)
    per-coefficient loop (the construction hot spot of the slot CRT tables
    at reference sizes, e.g. phi(m)=24000, 1200 slots)."""
    A = np.asarray(A, dtype=np.int64) % q
    F = np.asarray(F, dtype=np.int64) % q
    rows, n = A.shape
    d = F.shape[1] - 1
    nq = n - d
    if nq <= 0:
        R = np.zeros((rows, d), dtype=np.int64)
        R[:, :n] = A
        return np.zeros((rows, 0), dtype=np.int64), R
    MB, QM = _fold_matrices(F, q)
    nb = (n + d - 1) // d
    pad = nb * d - n
    a_p = np.concatenate([A, np.zeros((rows, pad), dtype=np.int64)], axis=1)
    blks = a_p.reshape(rows, nb, d)
    acc = blks[:, nb - 1].copy()
    Q = np.zeros((rows, nb - 1, d), dtype=np.int64)
    for i in range(nb - 2, -1, -1):
        Q[:, i] = _bmv(QM, acc, q)
        acc = (_bmv(MB, acc, q) + blks[:, i]) % q
    return Q.reshape(rows, (nb - 1) * d)[:, :nq], acc


def batched_rem_long(a: np.ndarray, F: np.ndarray, q: int) -> np.ndarray:
    """Remainder of a long polynomial mod per-row monic F [rows, d+1],
    block-Horner formulation: a = sum_i blk_i (Y^d)^i with deg blk_i < d,
    folded top-down through the multiply-by-Y^d matrix — turns the
    O(n)-step synthetic division into O(n/d) batched [rows,d,d] matvecs.
    a: [n] (shared) or [rows, n] (per-row)."""
    F = np.asarray(F, dtype=np.int64) % q
    rows, dp1 = F.shape
    d = dp1 - 1
    a = np.asarray(a, dtype=np.int64) % q
    shared = a.ndim == 1
    n = a.shape[-1]
    if n <= d:
        out = np.zeros((rows, d), dtype=np.int64)
        out[:, :n] = a[None, :] if shared else a
        return out
    # MB[:, :, i] = Y^{d+i} mod F (columns i < d)
    MB = np.zeros((rows, d, d), dtype=np.int64)
    cur = (-F[:, :d]) % q
    for i in range(d):
        MB[:, :, i] = cur
        if i < d - 1:
            nxt = np.zeros_like(cur)
            nxt[:, 1:] = cur[:, :d - 1]
            nxt = (nxt + cur[:, d - 1:d] * ((-F[:, :d]) % q)) % q
            cur = nxt
    nb = (n + d - 1) // d
    pad = nb * d - n
    if shared:
        a_p = np.concatenate([a, np.zeros(pad, dtype=np.int64)])
        blks = a_p.reshape(nb, d)
        acc = np.broadcast_to(blks[nb - 1], (rows, d)).copy()
    else:
        a_p = np.concatenate([a, np.zeros((rows, pad), dtype=np.int64)],
                             axis=1)
        blks = a_p.reshape(rows, nb, d)
        acc = blks[:, nb - 1].copy()
    for i in range(nb - 2, -1, -1):
        # acc <- MB @ acc + blk_i  (exact via 15-bit split of MB)
        hi = np.einsum('rij,rj->ri', MB >> 15, acc) % q
        lo = np.einsum('rij,rj->ri', MB & 0x7FFF, acc)
        acc = ((hi << 15) + lo) % q
        acc = (acc + (blks[i][None, :] if shared else blks[:, i])) % q
    return acc


def batched_mulmod(a: np.ndarray, b: np.ndarray, F: np.ndarray, q: int):
    """[rows, d] * [rows, d] mod (per-row monic F [rows, d+1], q)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    rows, d = a.shape
    conv = np.zeros((rows, 2 * d - 1), dtype=np.int64)
    for i in range(d):
        conv[:, i:i + d] = (conv[:, i:i + d] + a[:, i:i + 1] * b) % q
    if d == 1:
        return conv % q
    _, rem = batched_divmod(conv, F, q)
    return rem


def batched_inv_modF(a: np.ndarray, F: np.ndarray, p: int, r: int):
    """Per-row inverse of a mod (F, p^r): Fermat x^{p^d - 2} in GF(p^d)
    (F irreducible mod p), then Newton lift x <- x(2 - a*x) to p^r."""
    a = np.asarray(a, dtype=np.int64)
    rows, d = a.shape
    e = p**d - 2
    inv = np.zeros_like(a)
    inv[:, 0] = 1
    base = a % p
    while e:
        if e & 1:
            inv = batched_mulmod(inv, base, F, p)
        e >>= 1
        if e:
            base = batched_mulmod(base, base, F, p)
    pk = p
    pr = p**r
    while pk < pr:
        pk = min(pk * pk, pr)
        ax = batched_mulmod(a % pk, inv, F, pk)
        ax = (-ax) % pk
        ax[:, 0] = (ax[:, 0] + 2) % pk
        inv = batched_mulmod(inv, ax, F, pk)
    return inv


def hensel_lift_factors(phim, F_p: np.ndarray, p: int, r: int) -> np.ndarray:
    """Lift factors F_t of Phi_m mod p to factors mod p^r (quadratic Newton,
    per-factor; reference lifts via NTL MulMod trees).  phim: Phi_m coeff
    vector (ints); F_p: [rows, d+1] mod p."""
    if r == 1:
        return F_p % p
    pr = p**r
    rows, dp1 = F_p.shape
    d = dp1 - 1
    F = F_p.astype(np.int64) % pr
    phim_pr = np.array([int(c) % pr for c in phim], dtype=np.int64)
    k = 1
    while k < r:
        k2 = min(2 * k, r)
        q = p**k2
        # A = Phi_m mod F^2 (mod q), then A = F*Hbar + R1
        F2 = np.zeros((rows, 2 * d + 1), dtype=np.int64)
        for i in range(dp1):
            F2[:, i:i + dp1] = (F2[:, i:i + dp1] + F[:, i:i + 1] * F) % q
        A = batched_rem_long(phim_pr % q, F2, q)
        Hbar, R1 = batched_divmod(A, F, q)
        # Hbar = (Phi_m/F) mod F (length d); R1 = Phi_m mod F ≡ 0 mod p^k
        # delta = R1 * Hbar^{-1} mod (F, q):  F <- F + delta
        W = batched_inv_modF(Hbar, F, p, k2)
        delta = batched_mulmod(R1, W, F, q)
        F[:, :d] = (F[:, :d] + delta) % q
        k = k2
    # final verification: Phi_m mod F ≡ 0 mod p^r
    rem = batched_rem_long(phim_pr, F % pr, pr)
    assert_true(not rem.any(), "Hensel lift failed")
    return F % pr


def batched_crt_units(phim, F: np.ndarray, p: int, r: int) -> np.ndarray:
    """CRT idempotents: unit_t = cof_t * (cof_t^{-1} mod F_t) mod Phi_m,
    cof_t = Phi_m / F_t (all mod p^r).  Returns [rows, phi] int64."""
    pr = p**r
    phim_pr = np.array([int(c) % pr for c in phim], dtype=np.int64)
    rows, dp1 = F.shape
    d = dp1 - 1
    phi = len(phim) - 1
    cof, rem = batched_divmod_same(phim_pr, F, pr)
    assert_true(not rem.any(), 'invariant: not rem.any()')
    # cof mod F, then batched inversion mod (F, p^r)
    cof_red = batched_rem_long(cof, F, pr)
    units = np.zeros((rows, phi), dtype=np.int64)
    inv = batched_inv_modF(cof_red, F, p, r)
    # unit = cof * inv  (degree (phi-d) + (d-1) = phi-1 < phi: no reduction
    # mod Phi_m needed)
    for j in range(d):
        cj = inv[:, j]
        if not cj.any():
            continue
        hi = min(phi, j + cof.shape[1])
        units[:, j:hi] = (units[:, j:hi] + cj[:, None]
                          * cof[:, :hi - j]) % pr
    return units


def batched_inv_matrices(B: np.ndarray, p: int, r: int) -> np.ndarray:
    """Inverses of [rows, d, d] integer matrices mod p^r: batched Gauss-Jordan
    mod p + batched Newton lift (exact 15-bit-split matmuls)."""
    pr = p**r
    rows, d, _ = B.shape
    A = (B % p).astype(np.int64)
    X = np.broadcast_to(np.eye(d, dtype=np.int64), (rows, d, d)).copy()
    # Gauss-Jordan mod p, vectorized over rows (pivoting: factor-slot
    # matrices are Vandermonde-like and generically need row swaps)
    for col in range(d):
        bad = (A[:, col, col] % p) == 0
        if bad.any():
            for t in np.nonzero(bad)[0]:
                piv = next(i for i in range(col, d) if A[t, i, col] % p)
                A[t, [col, piv]] = A[t, [piv, col]]
                X[t, [col, piv]] = X[t, [piv, col]]
        ip = _inv_mod_vec(A[:, col, col], p)
        A[:, col] = (A[:, col] * ip[:, None]) % p
        X[:, col] = (X[:, col] * ip[:, None]) % p
        f = A[:, :, col].copy()
        f[:, col] = 0
        A = (A - f[:, :, None] * A[:, col:col + 1, :]) % p
        X = (X - f[:, :, None] * X[:, col:col + 1, :]) % p
    # Newton lift: X <- X(2I - BX) mod p^{2k}
    pk = p
    Bm = B.astype(np.int64)
    eye2 = 2 * np.eye(d, dtype=np.int64)
    while pk < pr:
        pk = min(pk * pk, pr)
        BX = _bmm(Bm % pk, X, pk)
        X = _bmm(X, (eye2 - BX) % pk, pk)
    return X % pr


def _bmm(A, B, q):
    """Batched [rows, d, d] matmul mod q (q < 2^30), exact via 15-bit split."""
    a_hi, a_lo = A >> 15, A & 0x7FFF
    out = (np.matmul(a_hi, B) % q << 15) + np.matmul(a_lo, B)
    return out % q


def _inv_mod_vec(v: np.ndarray, p: int) -> np.ndarray:
    """Elementwise modular inverse mod prime p (Fermat; p < 2^31)."""
    out = np.ones_like(v)
    e = p - 2
    base = v % p
    while e:
        if e & 1:
            out = out * base % p
        base = base * base % p
        e >>= 1
    return out
