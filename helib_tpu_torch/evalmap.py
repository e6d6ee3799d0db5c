"""Factor-tree ThinEvalMap: scalable slot<->coefficient maps.

helib_tpu.evalmap; the role of HElib's ThinEvalMap (src/EvalMap.cpp:
495-930, include/helib/EvalMap.h:87-104): the linear maps of
thin bootstrapping decomposed along the coprime factorization m = prod m_t
into one MatMul1D stage per hypercube dimension — O(sum D_t) rotations
instead of the dense sigma-span solve (recryption.LinearMapR) whose
construction is O(phi(m)^4).

Derivation in OUR slot conventions (slot with representative t holds
a(Y^t) in E = Z_{p^r}[Y]/G; reps t = prod gens^{coords}; factor-aligned
gens are 1 mod the other factors):

Powerful basis: monomials  prod_t W_t^{j_t},  W_t = X^{m/m_t},
j_t < phi(m_t) (HElib's PowerfulDCRT, powerful.cpp).  Under the slot-e
evaluation X -> Y^{t_e}:  W_t -> Y^{(m/m_t) * (locgen_t^{e_t} mod m_t)},
which depends ONLY on the dim-t coordinate e_t — so both maps factor into
one MatMul1D per dimension:

  * slotToCoeff (forward): stage matrix M_t[e][J] = node_t(e)^{J*step_t}
    with node_t(e) = Y^{(m/m_t)*locgen_t^e} and step_t = phi(m_t)/D_t
    (1 on the inert prefix, d on the last factor: HElib's point
    "inflation", EvalMap.cpp:700).  The output ring element is EXACTLY
    y = sum_J v_J * prod_t W_t^{J_t*step_t}: the slots land on powerful
    coefficients (J_t*step_t).
  * coeffToSlot (inverse): per prefix dim the inverse Vandermonde
    (exact evaluation inverse, all phi(m_t) primitive m_t-th roots); for
    the last factor a trace-solved extraction matrix W with
        Tr(sum_k W[J][k] * s_k) = a_{J*d}
    for ANY element with last-factor coefficients a_n (the role of the
    HElib's ThinStep1 deflation, EvalMap.cpp:537-620), then traceMap.
    The composition extracts powerful coefficients EXACTLY mod p^r for
    arbitrary inputs — the property digit extraction needs (the input of
    coeffToSlot during recryption is NOT thin).

The trace here is the Galois-ring trace sum_k sigma^k with sigma the
Frobenius LIFT Y -> Y^p mod (G, p^r) (matching ctxt.frobenius /
trace_map), not x -> x^p (they differ for r > 1).

Requires a Context built with a factor-aligned mvec
(nt/factoralign.find_aligned_mvec).  The stage matrices are built in host
Python and numpy, bit-identical to helib_tpu's; their diagonals are cached
on the context's device by the stage executors (algos/matmul.py)."""

from __future__ import annotations

import numpy as np

from .nt import polymod as pm
from .nt.numbth import phi_n
from .ea import EncryptedArray
from .algos.matmul import MatMul1D
from .exceptions import assert_true


# ---------------------------------------------------------------------------
# E-arithmetic helpers (E = Z_{p^r}[Y]/G)
# ---------------------------------------------------------------------------

def _e_mat_inv(A, G, p, r):
    """Inverse of a matrix with entries in E (coeff lists), Gauss-Jordan
    (the role of HElib's ppInvert over zz_pE)."""
    pr = p**r
    n = len(A)
    M = [[list(A[i][j]) for j in range(n)] for i in range(n)]
    Inv = [[([1] if i == j else []) for j in range(n)] for i in range(n)]
    for col in range(n):
        piv = next((i for i in range(col, n)
                    if M[i][col] and _e_is_unit(M[i][col], G, p)), None)
        assert_true(piv is not None, "singular E-matrix")
        if piv != col:
            M[col], M[piv] = M[piv], M[col]
            Inv[col], Inv[piv] = Inv[piv], Inv[col]
        ip = pm.poly_inv_mod(M[col][col], G, p, r)
        M[col] = [pm.pmulmod(x, ip, G, pr) for x in M[col]]
        Inv[col] = [pm.pmulmod(x, ip, G, pr) for x in Inv[col]]
        for i2 in range(n):
            if i2 == col or not M[i2][col]:
                continue
            f = M[i2][col]
            M[i2] = [pm.psub(a, pm.pmulmod(f, b, G, pr), pr)
                     for a, b in zip(M[i2], M[col])]
            Inv[i2] = [pm.psub(a, pm.pmulmod(f, b, G, pr), pr)
                       for a, b in zip(Inv[i2], Inv[col])]
    return Inv


def _e_is_unit(x, G, p):
    xr = pm.trim([c % p for c in x])
    if not xr:
        return False
    Gp = [c % p for c in G]
    return pm.pgcd(xr, Gp, p) == [1]


def _inv_scalar_matrix(A: np.ndarray, p: int, r: int) -> np.ndarray:
    """Inverse of an integer matrix mod p^r (vectorized Gauss-Jordan)."""
    pr = p**r
    n = A.shape[0]
    M = (A % pr).astype(np.int64)
    Inv = np.eye(n, dtype=np.int64)
    for col in range(n):
        piv = col + int(np.argmax(M[col:, col] % p != 0))
        assert_true(M[piv, col] % p != 0, "singular scalar matrix")
        if piv != col:
            M[[col, piv]] = M[[piv, col]]
            Inv[[col, piv]] = Inv[[piv, col]]
        ip = pow(int(M[col, col]), -1, pr)
        M[col] = (M[col] * ip) % pr
        Inv[col] = (Inv[col] * ip) % pr
        f = M[:, col].copy()
        f[col] = 0
        M = (M - np.outer(f, M[col])) % pr
        Inv = (Inv - np.outer(f, Inv[col])) % pr
    return Inv


def _frob(x, G, p, r):
    """Frobenius lift sigma(x) = x(Y^p) mod (G, p^r) — the Galois-ring
    automorphism (slot-level action of ctxt.frobenius)."""
    pr = p**r
    Yp = pm.ppowmod([0, 1], p, G, pr)
    acc = []
    for c in reversed(list(x)):
        acc = pm.padd(pm.pmulmod(acc, Yp, G, pr), [int(c) % pr], pr)
    return acc


def _trace(x, G, p, r, d):
    """Galois-ring trace Tr(x) = sum_{k<d} sigma^k(x) mod (G, p^r)."""
    pr = p**r
    x0 = pm.pmod([int(c) % pr for c in x], G, pr)
    acc = list(x0)
    xk = list(x0)
    for _ in range(1, d):
        xk = _frob(xk, G, p, r)
        acc = pm.padd(acc, xk, pr)
    return acc


# ---------------------------------------------------------------------------

class ThinEvalMapTree:
    """Factor-tree eval map.  fat=False: the THIN map (slot constants <->
    powerful coefficients, HElib's ThinEvalMap).  fat=True: the FULL map
    (HElib's EvalMap, EvalMap.cpp:52-493): ALL phi(m) powerful coefficients
    packed d-per-slot into the extension-ring slots — the prefix stages stay
    E-linear MatMul1Ds, the last-factor stage becomes a BlockMatMul1D whose
    d x d blocks are sub-blocks of the last-factor CRT evaluation matrix S
    (forward) or S^{-1} (inverse); no trace step.

    Packing convention (fat): slot with last-dim coordinate J holds
    sum_{i<d} v[..., J*d+i] * Y^i where v are powerful coefficients."""

    def __init__(self, ea: EncryptedArray, invert: bool, fat: bool = False):
        ctx = ea.ctx
        pal = ctx.pal
        assert_true(pal.aligned is not None, "Context must be built with mvec")
        s = pal.aligned
        mvec = list(pal.mvec)
        self.ea = ea
        self.invert = invert
        self.fat = fat
        nf = len(mvec)
        d = pal.d
        p, r, pr = ea.p, ea.r, ea.pr
        G = ea.G
        m = ctx.m

        phis = [phi_n(mt) for mt in mvec]
        Dvec = [phis[t] // s["dvec"][t] for t in range(nf)]
        self.steps = [phis[t] // Dvec[t] for t in range(nf)]  # 1,...,1,d
        self.Dvec = Dvec
        fac_to_dim = {f: i for i, f in enumerate(s["dims_factor"])}

        def nodes(t, count=None):
            mt = mvec[t]
            cof = m // mt
            g = s["local_gens"][t] % mt
            cnt = Dvec[t] if count is None else count
            return [pm.ppowmod([0, 1], (cof * pow(g, e, mt)) % m, G, pr)
                    for e in range(cnt)]

        def vand(t, step):
            """M[e][J] = node_t(e)^{J*step}: out_e = sum_J M[e][J] in_J
            (MatMul1D orientation)."""
            nd = nodes(t)
            sz = len(nd)
            ndp = [pm.ppowmod(x, step, G, pr) for x in nd]
            M = [[None] * sz for _ in range(sz)]
            for e in range(sz):
                M[e][0] = [1]
                for J in range(1, sz):
                    M[e][J] = pm.pmulmod(M[e][J - 1], ndp[e], G, pr)
            return M

        # stage kinds: ("matmul", dim, M[E entries]) | ("const", c[E]) |
        #              ("blockmatmul", dim, S[(D*d)x(D*d) over Z_{p^r}]) |
        #              ("lin", B[d x d over Z_{p^r}])
        self.stages = []
        fat = fat and d > 1          # d == 1: fat == thin (trace is trivial)
        self._fat_stages = fat
        if not invert:
            if fat:
                # the block stage is Z_{p^r}-linear but NOT E-linear: it must
                # see the unmixed packed inputs, so it runs BEFORE the
                # E-linear prefix stages (inverse direction: after them)
                S = self._last_factor_system(nodes(nf - 1), G, p, r, d)
                if Dvec[nf - 1] > 1:
                    self.stages.append(("blockmatmul", fac_to_dim[nf - 1], S))
                else:
                    self.stages.append(("lin", S))
            for t in range(nf - 1 if fat else nf):
                if Dvec[t] > 1:
                    self.stages.append(
                        ("matmul", fac_to_dim[t], vand(t, self.steps[t])))
        else:
            for t in range(nf - 1):
                if Dvec[t] > 1:
                    self.stages.append(
                        ("matmul", fac_to_dim[t],
                         _e_mat_inv(vand(t, 1), G, p, r)))
            if fat:
                S = self._last_factor_system(nodes(nf - 1), G, p, r, d)
                Sinv = _inv_scalar_matrix(S, p, r)
                if Dvec[nf - 1] > 1:
                    self.stages.append(
                        ("blockmatmul", fac_to_dim[nf - 1], Sinv))
                else:
                    self.stages.append(("lin", Sinv))
            else:
                W = self._last_factor_extractor(nodes(nf - 1), G, p, r, d)
                if Dvec[nf - 1] > 1:
                    self.stages.append(("matmul", fac_to_dim[nf - 1], W))
                else:
                    self.stages.append(("const", W[0][0]))

        # stage executors are built ONCE so their device-resident constant
        # caches persist across applications (HElib's EvalMap holds its
        # MatMul1DExec objects with upgraded caches, EvalMap.h:54-104)
        self._execs = []
        for st in self.stages:
            if st[0] == "matmul":
                _, dim, M = st
                self._execs.append(MatMul1D(ea, dim,
                                            lambda i, j, M=M: M[i][j]))
            elif st[0] == "blockmatmul":
                from .algos.matmul import BlockMatMul1D
                _, dim, S = st
                self._execs.append(BlockMatMul1D(
                    ea, dim,
                    lambda i, j, S=S, d=d: S[i * d:(i + 1) * d,
                                             j * d:(j + 1) * d]))
            elif st[0] == "lin":
                from .algos.linpoly import lin_poly_coeffs
                B = np.asarray(st[1], dtype=np.int64)
                self._execs.append(
                    lin_poly_coeffs(ea, [B[:, k2] for k2 in range(d)]))
            else:
                from .encoded import FatEncodedPtxt
                c = np.zeros(ea.d, dtype=np.int64)
                cc = np.asarray(st[1], dtype=np.int64)
                c[:len(cc)] = cc
                self._execs.append(FatEncodedPtxt(
                    ea.ctx, ea.encode([c] * ea.nslots), space=ea.pr))

    @staticmethod
    def _last_factor_system(pts, G, p, r, d):
        """S[(k*d + c), n] = coeff_c(pts_k^n mod G) for n < sz*d: the
        Z_{p^r}-linear CRT evaluation map from the last factor's powerful
        coefficients a_n to the slot coefficient vectors
        (Z_{p^r}[W]/Phi_{m_l} ~= prod_k E; HElib's EvalMap Step1/2 matrices,
        EvalMap.cpp:120-250, in direct coefficient form).  Invertible mod p
        since the pts_k are representatives of distinct Frobenius orbits."""
        pr = p**r
        sz = len(pts)
        n_tot = sz * d
        Pw = np.zeros((sz, n_tot, d), dtype=np.int64)
        cur = [[1] for _ in range(sz)]
        for n in range(n_tot):
            for k in range(sz):
                v = cur[k]
                Pw[k, n, :len(v)] = v
            if n + 1 < n_tot:
                cur = [pm.pmulmod(cur[k], pts[k], G, pr) for k in range(sz)]
        return Pw.transpose(0, 2, 1).reshape(n_tot, n_tot) % pr

    @staticmethod
    def _last_factor_extractor(pts, G, p, r, d):
        """W (sz x sz over E) with Tr(sum_k W[J][k] * s_k) = a_{J*d} for any
        element u = sum_{n < sz*d} a_n * (last-factor root)^n with slot
        values s_k = u(pts_k): solve the Tr(Y^lam * pts_k^n) linear system
        (HElib's Step1 deflation in direct form)."""
        pr = p**r
        sz = len(pts)
        n_tot = sz * d
        pows = [[None] * n_tot for _ in range(sz)]
        for k in range(sz):
            pows[k][0] = [1]
            for n in range(1, n_tot):
                pows[k][n] = pm.pmulmod(pows[k][n - 1], pts[k], G, pr)
        # system matrix Msys[n][(k, lam)] = Tr(Y^lam * pts_k^n).  Trace is
        # Z_{p^r}-linear, so with T[lam][j] = Tr(Y^{lam+j} mod G) it is one
        # exact matmul against the power coefficients (vectorized — the
        # naive per-entry trace loop is O(sz^2 d^4) Python ops and hours at
        # HElib's m=31775 sizes).
        T = np.zeros((d, d), dtype=np.int64)
        yi = [1]
        trs = []
        for i in range(2 * d - 1):
            tr = _trace(yi, G, p, r, d)
            assert_true(len(tr) <= 1, "trace is not a constant")
            trs.append((int(tr[0]) if tr else 0) % pr)
            yi = pm.pmulmod(yi, [0, 1], G, pr)
        for lam in range(d):
            T[lam] = trs[lam:lam + d]
        # P[k, n, j] = coeff j of pts_k^n
        Pw = np.zeros((sz, n_tot, d), dtype=np.int64)
        for k in range(sz):
            for n in range(n_tot):
                v = pows[k][n]
                Pw[k, n, :len(v)] = v
        # exact mod-p^r matmul via 15-bit split (p^r < 2^30, d <= 64)
        lo, hi = Pw & 0x7FFF, Pw >> 15
        M3 = ((np.einsum('knj,lj->knl', hi, T) % pr << 15)
              + np.einsum('knj,lj->knl', lo, T)) % pr     # [sz, n_tot, d]
        Msys = M3.transpose(1, 0, 2).reshape(n_tot, n_tot)
        Minv = _inv_scalar_matrix(Msys, p, r)
        W = [[None] * sz for _ in range(sz)]
        for J in range(sz):
            x = Minv[:, J * d] % pr
            for k in range(sz):
                W[J][k] = [int(v) for v in x[k * d:(k + 1) * d]]
        return W

    def apply(self, ctxt, key):
        from .recryption import _boot_trace
        ea = self.ea
        cur = ctxt
        for si, (st, ex) in enumerate(zip(self.stages, self._execs)):
            _boot_trace(f"evalmap stage {si}/{len(self.stages)} "
                        f"({st[0]}, k={getattr(cur, 'k', '-')})")
            if st[0] == "const":
                cur = cur.copy()
                cur.mul_constant_fat(ex)
            elif st[0] == "lin":
                from .algos.linpoly import apply_linearized
                cur = apply_linearized(ea, cur, ex, key)
            else:
                cur = ex.apply(cur, key)
        if self.invert and not self._fat_stages:
            cur = cur.copy().trace_map(key)
        return cur
