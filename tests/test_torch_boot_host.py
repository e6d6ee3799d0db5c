"""Port vs helib_tpu, host only and exact: the bootstrapping layer's tables
and host algebra.  PowerfulBasis (tables and round trips up to m=31775),
factor_mvec, set_ae, the digit and Chen-Han polynomials, the Chen-Han cost
heuristic, phim_idempotent, make_divisible, _phim_project, every
ThinEvalMapTree stage matrix (thin and fat, both directions; m=15 takes
the `lin` and `const` branches) must be equal in both packages.
LinearMapR's terms are held in tests/test_torch_boot.py, on the maps of
the m=31 RecryptData both packages build there."""

import types

import numpy as np
import pytest
import torch

from helib_tpu import powerful as jpw, recryption as jrc, evalmap as jem
from helib_tpu.algos import extract as jex
from helib_tpu.context import Context as JContext
from helib_tpu.ea import EncryptedArray as JEA
from helib_tpu.nt import numbth as jnt

from helib_tpu_torch import powerful as tpw, recryption as trc, evalmap as tem
from helib_tpu_torch.algos import extract as tex
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ea import EncryptedArray as TEA
from helib_tpu_torch.nt import numbth as tnt

torch.set_num_threads(1)

JAX = types.SimpleNamespace(Context=JContext, EA=JEA, pw=jpw, rc=jrc,
                            em=jem, kw={})
PORT = types.SimpleNamespace(Context=TContext, EA=TEA, pw=tpw, rc=trc,
                             em=tem, kw={"device": "cpu"})


def _plain(x):
    """Nested lists of Python ints from numpy arrays, lists and tuples."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.integer, int)):
        return int(x)
    return x


@pytest.mark.parametrize("m,mvec", [(255, (3, 5, 17)), (1271, (31, 41)),
                                    (31775, (31, 25, 41))])
def test_powerful_basis(m, mvec):
    jb, tb = jpw.PowerfulBasis(m, list(mvec)), tpw.PowerfulBasis(m, list(mvec))
    for name in ("to_powerful_perm", "from_powerful_perm"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    assert tb.crt_units == jb.crt_units
    assert _plain(tb._w_tables()) == _plain(jb._w_tables())
    rng = np.random.default_rng(m)
    coeffs = rng.integers(-1000, 1000, m)
    np.testing.assert_array_equal(
        tb.powerful_to_poly(tb.poly_to_powerful(coeffs)), coeffs)
    np.testing.assert_array_equal(tb.poly_to_powerful(coeffs),
                                  jb.poly_to_powerful(coeffs))
    # a bignum modulus, as raw_mod_switch passes Q
    N = 2**200 + 235
    vals = np.array([int(v) * 2**150 + int(w) for v, w in
                     zip(rng.integers(-2**40, 2**40, m),
                         rng.integers(0, 2**60, m))], dtype=object)
    got = tb.poly_to_w_powerful(vals, N)
    assert [int(v) for v in got] == [int(v) for v in
                                     jb.poly_to_w_powerful(vals, N)]
    # round trip: small powerful coordinates -> poly -> the same coordinates
    flat = rng.integers(-50, 50, len(got))
    poly = tb.w_powerful_to_poly(flat)
    np.testing.assert_array_equal(poly, jb.w_powerful_to_poly(flat))
    assert [int(v) for v in tb.poly_to_w_powerful(poly, 1 << 20)] == \
        flat.tolist()


@pytest.mark.parametrize("m", [15, 255, 1271, 31775, 8009, 4096])
def test_factor_mvec(m):
    assert tpw.factor_mvec(m) == jpw.factor_mvec(m)


@pytest.mark.parametrize("m,hwt,mvec", [(31, 16, None), (1271, 64, (31, 41)),
                                        (31775, 64, (31, 25, 41))])
def test_set_ae(m, hwt, mvec):
    """set_ae reads m, p, r, the factor count and the scale only: contexts
    with a short prime chain suffice."""
    kw = dict(m=m, p=2, r=1, bits=60, c=2, mvec=mvec)
    got = trc.set_ae(TContext(**kw, device="cpu"), hwt)
    assert got == jrc.set_ae(JContext(**kw), hwt)
    e, ep = got
    assert e > ep >= 0 and 2**e + 1 < (1 << 30)


@pytest.mark.parametrize("p", [2, 3, 5, 7])
def test_digit_and_magic_polynomials(p):
    for e in range(1, 5):
        assert tex.build_digit_polynomial(p, e) == \
            jex.build_digit_polynomial(p, e)
        assert tex.compute_a_vals(p, e) == jex.compute_a_vals(p, e)
        G = tex.compute_magic_poly(p, e)
        assert G == jex.compute_magic_poly(p, e)
        pe = p**e
        for x in range(pe):
            want = x % p if p == 2 else ((x + p // 2) % p) - p // 2
            assert sum(c * pow(x, i, pe) for i, c in enumerate(G)) % pe == \
                want % pe


@pytest.mark.parametrize("force", [-1, 0, 1])
def test_use_chen_han(force, monkeypatch):
    monkeypatch.setattr(jrc, "fhe_force_chen_han", force)
    monkeypatch.setattr(trc, "fhe_force_chen_han", force)
    grid = [(p, r, b) for p in (2, 3, 5, 17, 257) for r in range(1, 7)
            for b in range(0, 5)]
    got = [trc._use_chen_han(*g) for g in grid]
    assert got == [jrc._use_chen_han(*g) for g in grid]
    if force:
        assert all(got) == (force > 0) and any(got) == (force > 0)
    else:
        assert any(got) and not all(got)


@pytest.mark.parametrize("m,modulus", [(27, 8), (45, 128), (1271, 256),
                                       (1271, 4097)])
def test_phim_idempotent(m, modulus):
    np.testing.assert_array_equal(tnt.phim_idempotent(m, modulus),
                                  jnt.phim_idempotent(m, modulus))
    assert tnt.mobius(m) == jnt.mobius(m)


@pytest.mark.parametrize("m,modulus", [(255, 128), (1271, 256),
                                       (1271, 1 << 20)])
def test_make_divisible_and_phim_project(m, modulus):
    """The raw mod switch's host steps on seeded vectors: make_divisible to
    p^e' under q = p^e + 1, then the projection onto the Phi_m component
    (its float64 FFT branch at the smaller moduli, the exact int64 branch
    at 2^20)."""
    rng = np.random.default_rng(m + modulus)
    q, p2ep = 2**12 + 1, 2**5
    z = rng.integers(-(q // 2), q // 2 + 1, m)
    got = trc.make_divisible(z, p2ep, q)
    np.testing.assert_array_equal(got, jrc.make_divisible(z, p2ep, q))
    assert not np.any(got % p2ep)
    ctx = types.SimpleNamespace(m=m, pal=types.SimpleNamespace(pow2=False))
    poly = rng.integers(-modulus, modulus, m)
    np.testing.assert_array_equal(trc._phim_project(ctx, poly, modulus),
                                  jrc._phim_project(ctx, poly, modulus))


def _maps(pkg, params, e_r):
    ctx = pkg.Context(**params, **pkg.kw)
    ea, ea_big = pkg.EA(ctx), pkg.EA(ctx, r_override=e_r)
    return [pkg.em.ThinEvalMapTree(E, invert=inv, fat=fat)
            for E, inv, fat in ((ea, False, False), (ea_big, True, False),
                                (ea_big, True, True), (ea, False, True))]


@pytest.mark.parametrize("params,e_r", [
    (dict(m=15, p=2, r=1, bits=60, c=2, mvec=(3, 5)), 4),
    (dict(m=255, p=2, r=1, bits=60, c=2, mvec=(3, 5, 17)), 5),
    (dict(m=1271, p=2, r=1, bits=60, c=2, mvec=(31, 41)), 8)])
def test_evalmap_stage_matrices(params, e_r):
    """Every stage of the four maps RecryptData and FatRecryptData build
    (slotToCoeff mod p^r, coeffToSlot and the fat first map at the big
    space p^e_r, the fat second map): the same kinds, dimensions and
    matrices; the tree's steps and Dvec too."""
    for jm, tm in zip(_maps(JAX, params, e_r), _maps(PORT, params, e_r)):
        assert (tm.steps, tm.Dvec, tm._fat_stages) == (jm.steps, jm.Dvec,
                                                       jm._fat_stages)
        assert [s[0] for s in tm.stages] == [s[0] for s in jm.stages]
        assert _plain(tm.stages) == _plain(jm.stages)


# ---------------------------------------------------------------------------
# the native raw mod switch (power-of-2 m)
# ---------------------------------------------------------------------------

def _primes_above(n, start=1 << 29):
    """tests/test_native.py's primes."""
    out, x = [], start + 1
    while len(out) < n:
        if x % 2 and all(x % i for i in range(3, int(x ** 0.5) + 1, 2)):
            out.append(x)
        x += 2
    return out


@pytest.mark.parametrize("q,p2r", [(2**8 + 1, 2), (2**10 + 1, 4),
                                   (3**6 + 1, 9)])
def test_crt_mod_switch_matches_helib_tpu(q, p2r):
    """CrtCombiner.mod_switch against helib_tpu's on tests/test_native.py's
    inputs (17 primes above 2^29, 512 residues from default_rng(5))."""
    from helib_tpu.nt.native import combiner_for as jcomb
    from helib_tpu_torch.nt.native import available, combiner_for as tcomb
    assert available(), "the native combiner did not build"
    rng = np.random.default_rng(5)
    qs = _primes_above(17)
    res = np.stack([rng.integers(0, q_, 512).astype(np.uint32) for q_ in qs])
    np.testing.assert_array_equal(tcomb(qs).mod_switch(res, q, p2r),
                                  jcomb(qs).mod_switch(res, q, p2r))


def test_raw_mod_switch_native_path_equals_object_ints(monkeypatch):
    """At power-of-2 m with the power basis raw_mod_switch takes the native
    rounding; it gives the object-int loop's integers."""
    from helib_tpu_torch.keys import SecKey, PubKey
    from helib_tpu_torch.nt import native
    ctx = TContext(m=64, p=3, r=2, bits=120, c=2, device="cpu")
    sk = SecKey(ctx, seed=3)
    rng = np.random.default_rng(4)
    ct = PubKey(sk).encrypt_bgv(rng.integers(0, 9, ctx.phi_m), rng)
    assert native.available()
    fast = trc.raw_mod_switch(ct, 2**12 + 1)
    monkeypatch.setattr(native, "combiner_for", lambda qs: None)
    slow = trc.raw_mod_switch(ct, 2**12 + 1)
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a, b)


def test_rt_from_coeffs_round_trips_bignum_coefficients():
    """dcrt.rt_from_coeffs: balanced coefficients far above one prime come
    back from the eval domain exactly, and small ones as
    small_coeffs_to_rt gives them."""
    from helib_tpu_torch import dcrt
    ctx = TContext(m=45, p=2, r=1, bits=150, c=3, device="cpu")
    rng = np.random.default_rng(9)
    big = [int(v) * (1 << 100) + int(w) for v, w in
           zip(rng.integers(-2**20, 2**20, ctx.n_eval),
               rng.integers(0, 2**40, ctx.n_eval))]
    rows = ctx.rows_of(ctx.L, False)
    ev = dcrt.rt_from_coeffs(ctx, big, ctx.L, False)
    back = dcrt.crt_reconstruct(
        ctx, dcrt.to_host(dcrt.rt_to_coeff_residues(ctx, ev, ctx.L, False)),
        rows)
    assert [int(v) for v in back] == big
    small = rng.integers(-3, 4, ctx.n_eval)
    assert torch.equal(dcrt.rt_from_coeffs(ctx, small, ctx.L, True),
                       dcrt.small_coeffs_to_rt(ctx, small, ctx.L, True))
