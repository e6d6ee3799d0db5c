"""Port vs helib_tpu, host only: the slot algebra -- polynomial arithmetic
and factoring mod p^r (nt/polymod), the vectorized table construction
(nt/slotalg), the factor-aligned hypercube (nt/factoralign,
PAlgebra(mvec=...)), the EncryptedArray tables with encode and decode on
both constructions, and the PtxtBGV slot oracle.  Every value must be equal."""

import random

import numpy as np
import pytest
import torch

from helib_tpu.context import Context as JContext
from helib_tpu.ea import EncryptedArray as JEA
from helib_tpu.nt import factoralign as jfa
from helib_tpu.nt import polymod as jpm
from helib_tpu.nt import slotalg as jsa
from helib_tpu.nt.cyclotomic import cyclotomic_poly as jcyclo
from helib_tpu.palgebra import PAlgebra as JPAlgebra
from helib_tpu.ptxt import PtxtBGV as JPtxt

from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ea import EncryptedArray as TEA
from helib_tpu_torch.nt import factoralign as tfa
from helib_tpu_torch.nt import polymod as tpm
from helib_tpu_torch.nt import slotalg as tsa
from helib_tpu_torch.nt.cyclotomic import cyclotomic_poly
from helib_tpu_torch.palgebra import PAlgebra as TPAlgebra
from helib_tpu_torch.ptxt import PtxtBGV as TPtxt, PtxtArray as TPtxtArray

torch.set_num_threads(1)


def _eq(a, b):
    """Equal nested results (lists, tuples, arrays, ints)."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ---------------------------------------------------------------- polymod

def _poly(rng, deg, q):
    return tpm.trim([rng.randrange(q) for _ in range(deg)] + [1])


def _polymod_case(name, mod):
    """The results of one polymod function of module `mod` on inputs drawn
    from a seeded random.Random."""
    rng = random.Random(11)
    q = 7 ** 2
    a, b, f = _poly(rng, 9, q), _poly(rng, 5, q), _poly(rng, 6, q)
    if name == "ring":
        return [mod.padd(a, b, q), mod.psub(a, b, q), mod.pmul(a, b, q),
                mod.pdivmod(a, b, q), mod.pmulmod(a, b, f, q),
                mod.ppowmod(a, 1000, f, q), mod.make_monic([3, 1, 5], q)]
    if name == "gcd":
        return [mod.pgcd(a, b, 7), mod.poly_xgcd(a, b, 7)]
    phi = [c % 2 for c in jcyclo(255)]
    if name == "equal_degree_factor":
        return mod.equal_degree_factor(phi, 8, 2)
    if name == "lift_factorization":
        phi19 = [c % 19 for c in jcyclo(45)]
        facs = jpm.equal_degree_factor(phi19, 2, 19)
        return mod.lift_factorization([c % 19 ** 3 for c in jcyclo(45)],
                                      facs, 19, 3)
    if name == "hensel_lift_pair":
        facs = jpm.equal_degree_factor(phi, 8, 2)
        g, h = facs[0], [1]
        for fac in facs[1:]:
            h = jpm.pmul(h, fac, 2)
        return mod.hensel_lift_pair([c % 4 for c in jcyclo(255)], g, h, 2, 2)
    if name == "poly_inv_mod":
        F = jpm.lift_factorization([c % 8 for c in jcyclo(255)],
                                   jpm.equal_degree_factor(phi, 8, 2),
                                   2, 3)[0]
        return mod.poly_inv_mod([1, 1, 0, 1], F, 2, 3)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["ring", "gcd", "equal_degree_factor",
                                  "lift_factorization", "hensel_lift_pair",
                                  "poly_inv_mod"])
def test_polymod_equals_reference(name):
    _eq(_polymod_case(name, jpm), _polymod_case(name, tpm))


# ---------------------------------------------------------------- slotalg

def _slotalg_case(name, sa):
    rng = np.random.default_rng(17)
    q = 2 ** 20
    if name == "exact_matmul":
        A = rng.integers(0, 2 ** 30, (7, 40))
        B = rng.integers(0, 2 ** 30, (40, 9))
        return sa.exact_matmul(A, B, (1 << 30) - 35)
    if name == "galois_batch":
        h = sa.find_irreducible(2, 20)
        F = sa.GaloisBatch(h, q)
        a = rng.integers(0, q, (5, 20))
        return [h, F.R, F.mul(a, a[::-1]), F.pow_int(a, 77),
                F.pow_vec(a[0], np.arange(1, 30))]
    m, p, d, mvec = 1271, 2, 20, (31, 41)
    pal = JPAlgebra(m, p, mvec=mvec)
    reps = pal.representatives()
    h = jsa.find_irreducible(p, d)
    zeta = jsa.order_m_element(m, p, d, h)
    phim = jcyclo(m)
    Fp = jsa.batched_minpolys(m, p, d, reps, h, zeta)
    if name == "minpolys":
        return [sa.find_irreducible(p, d), sa.order_m_element(m, p, d, h),
                sa.batched_minpolys(m, p, d, reps, h, zeta)]
    if name == "hensel_lift_factors":
        return sa.hensel_lift_factors(phim, Fp, p, 3)
    F = jsa.hensel_lift_factors(phim, Fp, p, 2)
    if name == "crt_units":
        return sa.batched_crt_units(phim, F, p, 2)
    if name == "inv_matrices":
        B = rng.integers(0, 4, (6, 5, 5))
        B[:, range(5), range(5)] |= 1    # odd diagonal: invertible mod 2
        B = np.triu(B)
        return sa.batched_inv_matrices(B + np.tril(B.transpose(0, 2, 1), -1)
                                       * 2, p, 2)
    a = rng.integers(0, 4, 600)
    if name == "divmod":
        return [sa.batched_divmod_same(a, F, 4),          # folded
                sa.batched_divmod_same(a[:50], F, 4),     # synthetic
                sa.batched_divmod_fold(np.tile(a, (len(F), 1)), F, 4),
                sa.batched_rem_long(a, F, 4),
                sa.batched_mulmod(F[:, :d], F[:, 1:], F, 4),
                sa.batched_inv_modF(F[:, 1:], F, p, 2)]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["exact_matmul", "galois_batch",
                                  "minpolys", "hensel_lift_factors",
                                  "crt_units", "inv_matrices", "divmod"])
def test_slotalg_equals_reference(name):
    _eq(_slotalg_case(name, jsa), _slotalg_case(name, tsa))


# ------------------------------------------------- factoralign, PAlgebra

MVECS = [(255, (3, 5, 17)), (1271, (31, 41)), (31775, (31, 25, 41))]


@pytest.mark.parametrize("m,mvec", MVECS)
def test_factor_aligned_palgebra_equals_reference(m, mvec):
    j, t = JPAlgebra(m, 2, mvec=mvec), TPAlgebra(m, 2, mvec=mvec)
    assert (t.gens, t.orders, t.native, t.d, t.nslots) == (
        j.gens, j.orders, j.native, j.d, j.nslots)
    _eq(j.aligned, t.aligned)
    assert t.representatives() == j.representatives()
    assert t.n_factors == j.n_factors == len(mvec)
    assert [t.coords(s) for s in range(0, t.nslots, 7)] == [
        j.coords(s) for s in range(0, j.nslots, 7)]
    assert all(t.slot_index(t.coords(s)) == s for s in range(t.nslots))
    np.testing.assert_array_equal(t.phim_poly(), j.phim_poly())
    if m == 31775:   # the thin-bootstrapping slot ring: a bad last dimension
        assert (t.orders, t.native) == ([30, 20, 2], [True, True, False])


def test_factoralign_helpers_equal_reference():
    assert tfa.find_aligned_mvec(255, 2) == jfa.find_aligned_mvec(255, 2)
    assert tfa.find_aligned_mvec(45, 2) == jfa.find_aligned_mvec(45, 2)
    assert tfa.find_aligned_mvec(35113, 2) == jfa.find_aligned_mvec(35113, 2)
    assert [tfa.primitive_root_pp(q) for q in (25, 49, 121)] == [
        jfa.primitive_root_pp(q) for q in (25, 49, 121)]
    assert tfa.quotient_generator(949, pow(2, 1, 949), 24) == \
        jfa.quotient_generator(949, pow(2, 1, 949), 24)
    with pytest.raises(ValueError):
        tfa.factor_aligned_structure(45, 2, [9, 5])
    # the port's own cyclotomic polynomial, which every table starts from
    assert tuple(cyclotomic_poly(31775)) == tuple(jcyclo(31775))


# ------------------------------------------------------ EncryptedArray

EA_CASES = [  # (m, p, r, mvec, HELIB_FAST_EA)
    (31, 2, 1, None, False), (45, 19, 1, None, False),
    (257, 2, 1, None, False), (255, 2, 1, (3, 5, 17), True),
    (1271, 2, 1, (31, 41), False), (45, 19, 2, None, False)]
EA_IDS = ["m31", "m45p19", "m257", "m255-fast", "m1271", "m45p19r2"]


@pytest.fixture(scope="module", params=EA_CASES, ids=EA_IDS)
def eas(request):
    m, p, r, mvec, fast = request.param
    with pytest.MonkeyPatch.context() as mp:
        if fast:
            mp.setenv("HELIB_FAST_EA", "1")
        else:
            mp.delenv("HELIB_FAST_EA", raising=False)
        params = dict(m=m, p=p, r=r, bits=60, c=2, mvec=mvec)
        j = JEA(JContext(**params))
        t = TEA(TContext(**params, device="cpu"))
    return j, t, fast or m == 1271


def test_ea_tables_equal_reference(eas):
    j, t, fast = eas
    assert bool(t._fast) == bool(j._fast) == fast
    assert (t.d, t.nslots, t.pr) == (j.d, j.nslots, j.pr)
    assert list(t.G) == list(j.G) and t.reps == j.reps
    for name in ("factors", "B", "C", "units"):
        _eq(getattr(j, name), getattr(t, name))


def test_ea_encode_decode_equal_reference(eas):
    j, t, _ = eas
    rng = np.random.default_rng(29)
    slots = [rng.integers(0, t.pr, t.d) for _ in range(t.nslots)]
    ints = [int(v) for v in rng.integers(0, t.pr, t.nslots)]
    for vals in (slots, ints, slots[:3]):
        poly = t.encode(vals)
        np.testing.assert_array_equal(poly, j.encode(vals))
        assert poly.shape == (t.ctx.phi_m,)
        _eq(j.decode(poly), t.decode(poly))
    _eq(slots, [v % t.pr for v in t.decode(t.encode(slots))])
    np.testing.assert_array_equal(t.decode_ints(t.encode(ints)), ints)
    ep = t.encode_ptxt(slots)
    assert ep.is_bgv and ep.space == t.ctx.ptxt_space
    np.testing.assert_array_equal(ep.coeffs, j.encode_ptxt(slots).coeffs)
    for key in ((0, 0, 1), (len(t.ctx.pal.orders) - 1, 1, 2)):
        np.testing.assert_array_equal(t.mask_poly(*key), j.mask_poly(*key))
        assert t.mask_poly(*key) is t.mask_poly(*key)      # cached


# ------------------------------------------------------------- PtxtBGV

def _ptxt_ops(P, ea, a, b):
    pa, pb = P(ea, a), P(ea, b)
    outs = [pa.add(pb), pa.sub(pb), pa.multiply(pb), pa.square(),
            pa.power(5), pa.negate(), pa.rotate(3), pa.shift(2),
            pa.shift(-5), pa.frobenius(1), pa.total_sums(),
            pa.running_sums()]
    outs += [pa.rotate_1d(dim, 1) for dim in range(len(ea.ctx.pal.orders))]
    return [o.slots for o in outs] + [pa.ints(), pa.encode()]


@pytest.mark.parametrize("case", [0, 1, 3], ids=["m31", "m45p19",
                                                 "m255-fast"])
def test_ptxt_bgv_ops_equal_reference(case):
    m, p, r, mvec, fast = EA_CASES[case]
    with pytest.MonkeyPatch.context() as mp:
        if fast:
            mp.setenv("HELIB_FAST_EA", "1")
        params = dict(m=m, p=p, r=r, bits=60, c=2, mvec=mvec)
        j, t = JEA(JContext(**params)), TEA(TContext(**params, device="cpu"))
    rng = np.random.default_rng(31)
    a = [rng.integers(0, t.pr, t.d) for _ in range(t.nslots)]
    b = [int(v) for v in rng.integers(0, t.pr, t.nslots)]
    _eq(_ptxt_ops(JPtxt, j, a, b), _ptxt_ops(TPtxt, t, a, b))
    pa = TPtxt(t, a)
    assert TPtxt.decode(t, pa.encode()) == pa and pa.copy() == pa
    arr = TPtxtArray(t, b)
    np.testing.assert_array_equal(arr.store(), np.array(b) % t.pr)
    assert arr.distance(TPtxtArray(t).load(b)) == 0.0
