"""Key-switching matrix generation strategies (helib_tpu.ksstrategy).

Which automorphism matrices to pre-generate (rotations are the expensive
resource; HElib's keySwitching.h add*Matrices), and the multi-hop
key-switch map that `Ctxt.smart_automorph` takes when an exact matrix is
missing (HElib's setKeySwitchMap).
"""

from __future__ import annotations

import math
from collections import deque

from .keys import SecKey, SKHandle
from .nt.numbth import inv_mod

KS_GIANT_STEP_THRESHOLD = 50   # HElib keySwitching.h:225 (BSGS cutoff)
KS_MIN_THRESHOLD = 8           # HElib HELIB_KEYSWITCH_MIN_THRESH


def add_relin_matrix(sk: SecKey):
    sk.gen_ks_matrix(SKHandle(2, 1, 0))


def add_1d_matrices(sk: SecKey, dim: int | None = None):
    """Matrices for all powers of each generator (add1DMatrices)."""
    pal = sk.ctx.pal
    m = sk.ctx.m
    dims = range(len(pal.gens)) if dim is None else [dim]
    for d in dims:
        g, D = pal.gens[d], pal.orders[d]
        for j in range(1, D):
            sk.gen_ks_matrix(SKHandle(1, pow(g, j, m), 0))
            if not pal.native[d]:
                # bad dims also need the wrapped automorphism g^{j-D}
                sk.gen_ks_matrix(SKHandle(1, pow(g, j - D, m), 0))


def add_some_1d_matrices(sk: SecKey, bound: int = KS_GIANT_STEP_THRESHOLD):
    """BSGS subset for big dims (addSome1DMatrices): for dims of order
    above `bound`, only baby steps [1, g) and giant steps multiples of g."""
    pal = sk.ctx.pal
    m = sk.ctx.m
    for d in range(len(pal.gens)):
        g, D = pal.gens[d], pal.orders[d]
        if D <= bound:
            add_1d_matrices(sk, d)
            continue
        gs = int(math.isqrt(D))
        for j in list(range(1, gs)) + list(range(gs, D, gs)):
            sk.gen_ks_matrix(SKHandle(1, pow(g, j, m), 0))


def add_frb_matrices(sk: SecKey):
    """Frobenius powers X -> X^{p^j} (addFrbMatrices)."""
    ctx = sk.ctx
    for j in range(1, ctx.pal.d):
        sk.gen_ks_matrix(SKHandle(1, pow(ctx.p, j, ctx.m), 0))


def ks_giant_step_size(D: int) -> int:
    """ceil(sqrt(D)), the giant-step size shared with the BSGS matmuls
    (KSGiantStepSize)."""
    if D <= 0:
        raise ValueError("step size must be positive")
    g = math.isqrt(D)
    return g if g * g >= D else g + 1


def add_some_frb_matrices(sk: SecKey, bound: int = KS_GIANT_STEP_THRESHOLD):
    """BSGS subset of Frobenius matrices when ord(p) is large
    (addSomeFrbMatrices)."""
    ctx = sk.ctx
    d = ctx.pal.d
    if bound >= d:
        add_frb_matrices(sk)
        return
    g = ks_giant_step_size(d)
    for j in list(range(1, g)) + list(range(g, d, g)):
        sk.gen_ks_matrix(SKHandle(1, pow(ctx.p, j, ctx.m), 0))


def add_bsgs_frb_matrices(sk: SecKey):
    """Force the BSGS Frobenius set (addBSGSFrbMatrices)."""
    add_some_frb_matrices(sk, 0)


def add_minimal_frb_matrices(sk: SecKey):
    """Cheapest Frobenius set: s(X^p) plus one giant step when ord(p) is
    large; other powers are reached by hop chains
    (addMinimalFrbMatrices)."""
    ctx = sk.ctx
    d = ctx.pal.d
    if d <= 1:
        return
    sk.gen_ks_matrix(SKHandle(1, ctx.p % ctx.m, 0))
    if d > KS_MIN_THRESHOLD:
        g = ks_giant_step_size(d)
        sk.gen_ks_matrix(SKHandle(1, pow(ctx.p, g, ctx.m), 0))


def add_matrices_4_network(sk: SecKey, pp):
    """Exactly the automorphism matrices a built permutation network uses
    (addMatrices4Network, keySwitching.h:249, keySwitching.cpp:667); `pp`
    is an algos.optimize_perms.PermPrecomp."""
    pal = sk.ctx.pal
    m = sk.ctx.m
    for dim, amt in sorted(pp.needed_rotations()):
        dim, amt = int(dim), int(amt)
        if amt % pal.orders[dim] == 0:
            continue
        g, D = int(pal.gens[dim]), int(pal.orders[dim])
        amt %= D
        sk.gen_ks_matrix(SKHandle(1, pow(g, amt, m), 0))
        if not pal.native[dim]:
            sk.gen_ks_matrix(SKHandle(1, pow(g, amt - D, m), 0))


def add_all_matrices(sk: SecKey):
    """Every automorphism (addAllMatrices): heavyweight."""
    m = sk.ctx.m
    for k in range(2, m):
        if math.gcd(k, m) == 1:
            sk.gen_ks_matrix(SKHandle(1, k, 0))


def add_minimal_1d_matrices(sk: SecKey):
    """One matrix per generator and its inverse, the cheapest set that
    reaches every rotation by hops (addMinimal1DMatrices)."""
    pal = sk.ctx.pal
    m = sk.ctx.m
    for d in range(len(pal.gens)):
        g = pal.gens[d]
        sk.gen_ks_matrix(SKHandle(1, g % m, 0))
        sk.gen_ks_matrix(SKHandle(1, inv_mod(g, m), 0))


def hop_path(key, kexp: int) -> list[int] | None:
    """Decompose X -> X^kexp into the key's one-hop automorphisms (a
    breadth-first search over the group they generate): a list of hop
    exponents whose product is kexp mod m, or None."""
    m = key.ctx.m
    avail = sorted({h[1] for h in key.matrices if h[0] == 1 and h[1] != 1})
    if not avail:
        return None
    kexp %= m
    if kexp == 1:
        return []
    prev: dict[int, tuple[int, int]] = {1: (0, 0)}
    dq = deque([1])
    while dq:
        cur = dq.popleft()
        for a in avail:
            nxt = cur * a % m
            if nxt not in prev:
                prev[nxt] = (cur, a)
                if nxt == kexp:
                    path = []
                    node = kexp
                    while node != 1:
                        p, a2 = prev[node]
                        path.append(a2)
                        node = p
                    return list(reversed(path))
                dq.append(nxt)
    return None
