"""Port vs helib_tpu, encrypted, on the host CPU: the BGV slot layer's chain
-- encrypt, multiply, add_constant(encode_ptxt), mul_by_constant of a
FatEncodedPtxt, the global rotate by 1 and by 5, shift_1d on the bad
dimension, total_sums, running_sums, replicate and replicate_all -- run
once in each package on the same keys.  At m=255, mvec=(3, 5, 17), the
hypercube has orders [2, 4, 2] with the last dimension bad, as at m=31775
([30, 20, 2]).  After each step the ciphertexts must be equal residue for
residue and decrypt to the PtxtBGV oracle; m=45, p=19 takes the
f != 1 branch of add_constant_fat.  Also SecKey(hwt=64) and the CKKS
encode_ptxt."""

import types

import numpy as np
import pytest
import torch

from helib_tpu import ksstrategy as jks
from helib_tpu import encoded as jenc
from helib_tpu.algos import replicate as jrep, sums as jsums
from helib_tpu.ckks import EncryptedArrayCKKS as JCKKS
from helib_tpu.context import Context as JContext
from helib_tpu.ea import EncryptedArray as JEA
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.ops import ntt as jntt

from helib_tpu_torch import ksstrategy as tks
from helib_tpu_torch import encoded as tenc
from helib_tpu_torch.algos import replicate as trep, sums as tsums
from helib_tpu_torch.ckks import EncryptedArrayCKKS as TCKKS
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ea import EncryptedArray as TEA
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.ops.modops import to_host
from helib_tpu_torch.ptxt import PtxtBGV

torch.set_num_threads(1)

JAX = types.SimpleNamespace(Context=JContext, EA=JEA, SecKey=JSecKey,
                            PubKey=JPubKey, ks=jks, enc=jenc, sums=jsums,
                            rep=jrep, kw={})
PORT = types.SimpleNamespace(Context=TContext, EA=TEA, SecKey=TSecKey,
                             PubKey=TPubKey, ks=tks, enc=tenc, sums=tsums,
                             rep=trep, kw={"device": "cpu"})

M255 = dict(m=255, p=2, r=1, bits=300, c=3, mvec=(3, 5, 17))
M45 = dict(m=45, p=19, r=1, bits=300, c=3)
INT_FACTOR = 5


def _shift_1d(pt, dim, amt):
    """Oracle of EncryptedArray.shift_1d: rotate along dim, zero the slots
    whose coordinate came from outside [0, D)."""
    pal = pt.ea.ctx.pal
    out = pt.rotate_1d(dim, amt)
    for s in range(pt.ea.nslots):
        e = pal.coords(s)[dim]
        if (amt > 0 and e < amt) or (amt < 0 and e >= pal.orders[dim] + amt):
            out.slots[s] = np.zeros(pt.ea.d, dtype=np.int64)
    return out


def _replicated(pt, pos):
    out = pt.copy()
    out.slots = [pt.slots[pos].copy() for _ in pt.slots]
    return out


def _setup(pkg, params, seed):
    ctx = pkg.Context(**params, **pkg.kw)
    sk = pkg.SecKey(ctx, seed=seed)
    pkg.PubKey(sk)
    pkg.ks.add_some_1d_matrices(sk)
    return ctx, sk, pkg.EA(ctx)


def _slot_chain(pkg, params, seed=5):
    """[(step, ciphertext)] of the slot chain in one package."""
    ctx, sk, ea = _setup(pkg, params, seed)
    rng = np.random.default_rng(7)
    a = [rng.integers(0, ea.pr, ea.d) for _ in range(ea.nslots)]
    b = [rng.integers(0, ea.pr, ea.d) for _ in range(ea.nslots)]
    ca, cb = ea.encrypt(a, sk.pubkey, rng), ea.encrypt(b, sk.pubkey, rng)
    c = ca.multiply(cb, sk)
    steps = [("encrypt", ca), ("multiply", c.copy())]
    c.add_constant(ea.encode_ptxt(b))
    steps.append(("add_constant", c.copy()))
    c.mul_by_constant(pkg.enc.FatEncodedPtxt(ctx, ea.encode(a),
                                             space=ea.pr))
    steps.append(("mul_by_constant", c.copy()))
    last = len(ctx.pal.orders) - 1
    steps += [("rotate1", ea.rotate(c.copy(), 1, sk)),
              ("rotate5", ea.rotate(c.copy(), 5, sk)),
              ("shift_1d", ea.shift_1d(c.copy(), last, 1, sk)),
              ("total_sums", pkg.sums.total_sums(ea, c.copy(), sk)),
              ("running_sums", pkg.sums.running_sums(ea, c.copy(), sk)),
              ("replicate", pkg.rep.replicate(ea, c.copy(), 3, sk))]
    steps += [(f"replicate_all{i}", x) for i, x in enumerate(
        pkg.rep.replicate_all(ea, c.copy(), sk))]
    return dict(steps), (ctx, sk, ea, a, b)


def _oracle(ea, a, b):
    pa, pb = PtxtBGV(ea, a), PtxtBGV(ea, b)
    prod = pa.multiply(pb)
    c = prod.add(pb).multiply(pa)
    last = len(ea.ctx.pal.orders) - 1
    out = {"encrypt": pa, "multiply": prod, "add_constant": prod.add(pb),
           "mul_by_constant": c, "rotate1": c.rotate(1),
           "rotate5": c.rotate(5), "shift_1d": _shift_1d(c, last, 1),
           "total_sums": c.total_sums(), "running_sums": c.running_sums(),
           "replicate": _replicated(c, 3)}
    out.update({f"replicate_all{i}": _replicated(c, i)
                for i in range(ea.nslots)})
    return out


@pytest.fixture(autouse=True)
def _staged_reference(monkeypatch):
    monkeypatch.setattr(jntt, "USE_PALLAS", False)


@pytest.fixture(scope="module")
def chain255():
    """The m=255 chain in both packages, once each (fast table construction)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HELIB_FAST_EA", "1")
        mp.setattr(jntt, "USE_PALLAS", False)
        jsteps, _ = _slot_chain(JAX, M255)
        tsteps, (ctx, sk, ea, a, b) = _slot_chain(PORT, M255)
        assert ea._fast
    return jsteps, tsteps, sk, ea, _oracle(ea, a, b)


@pytest.fixture(scope="module")
def chain45():
    """m=45, p=19: the constant ops, where Q * intFactor mod p^r is not 1.
    The chain at m=255 holds multiply and the rotations; this one adds to a
    ciphertext whose intFactor is 1 and to one labelled 5 (HElib's
    intFactor after a multiply at p > 2)."""
    def run(pkg):
        ctx, sk, ea = _setup(pkg, M45, seed=3)
        rng = np.random.default_rng(9)
        a = [rng.integers(0, ea.pr, ea.d) for _ in range(ea.nslots)]
        b = [rng.integers(0, ea.pr, ea.d) for _ in range(ea.nslots)]
        c = ea.encrypt(a, sk.pubkey, rng)
        fat = pkg.enc.FatEncodedPtxt(ctx, ea.encode(b), space=ea.pr)
        labelled = c.copy()
        labelled.intFactor = INT_FACTOR
        labelled.add_constant(fat)
        steps = [("add_constant_fat_intfactor", labelled)]
        c.add_constant(fat)
        steps.append(("add_constant_fat", c.copy()))
        c.add_constant(ea.encode_ptxt(a))
        steps.append(("add_constant_poly", c.copy()))
        c.mul_by_constant(ea.encode_ptxt(b))
        steps.append(("mul_constant_poly", c.copy()))
        c.mul_by_constant(fat)
        steps.append(("mul_constant_fat", c.copy()))
        return dict(steps), (ctx, sk, ea, a, b)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jntt, "USE_PALLAS", False)
        jsteps, _ = run(JAX)
        tsteps, (ctx, sk, ea, a, b) = run(PORT)
    pa, pb = PtxtBGV(ea, a), PtxtBGV(ea, b)
    inv = PtxtBGV(ea, [pow(INT_FACTOR, -1, ea.pr)] * ea.nslots)
    c = pa.add(pb).add(pa).multiply(pb).multiply(pb)
    oracle = {"add_constant_fat_intfactor": pa.multiply(inv).add(pb),
              "add_constant_fat": pa.add(pb),
              "add_constant_poly": pa.add(pb).add(pa),
              "mul_constant_poly": pa.add(pb).add(pa).multiply(pb),
              "mul_constant_fat": c}
    return jsteps, tsteps, sk, ea, oracle


def _same(j, t):
    """Equal residues, handles and noise metadata."""
    assert (t.k, t.special, t.ptxt_space, t.intFactor) == (
        j.k, j.special, j.ptxt_space, j.intFactor)
    assert abs(t.noise - j.noise) <= 1e-9
    assert [(h.powS, h.powX, h.keyID) for h, _ in t.parts] == [
        (h.powS, h.powX, h.keyID) for h, _ in j.parts]
    for (_, a), (_, b) in zip(t.parts, j.parts):
        np.testing.assert_array_equal(to_host(a), np.asarray(b))


STEPS255 = ["encrypt", "multiply", "add_constant", "mul_by_constant",
            "rotate1", "rotate5", "shift_1d", "total_sums", "running_sums",
            "replicate", "replicate_all"]
STEPS45 = ["add_constant_fat_intfactor", "add_constant_fat",
           "add_constant_poly", "mul_constant_poly", "mul_constant_fat"]


def _names(steps, name):
    return sorted(s for s in steps if s == name or (
        name == "replicate_all" and s.startswith(name)))


@pytest.mark.parametrize("name", STEPS255)
def test_slot_chain_residues_equal_reference(chain255, name):
    jsteps, tsteps, _, _, _ = chain255
    assert jsteps.keys() == tsteps.keys()
    for s in _names(tsteps, name):
        _same(jsteps[s], tsteps[s])


@pytest.mark.parametrize("name", STEPS255)
def test_slot_chain_decrypts_to_oracle(chain255, name):
    _, tsteps, sk, ea, oracle = chain255
    names = _names(tsteps, name)
    assert names and (name != "replicate_all" or len(names) == ea.nslots)
    for s in names:
        got = PtxtBGV.decode(ea, sk.decrypt_bgv(tsteps[s]))
        assert got == oracle[s], s


def test_slot_chain_reads_only_minted_matrices(chain255):
    """add_some_1d_matrices covers every rotation: the chain minted only the
    relinearization matrix beyond it."""
    _, _, sk, ea, _ = chain255
    orders, native = ea.ctx.pal.orders, ea.ctx.pal.native
    want = 1 + sum(D - 1 if nat else 2 * (D - 1)
                   for D, nat in zip(orders, native))
    assert (orders, native) == ([2, 4, 2], [True, True, False])
    assert len(sk.matrices) == want


@pytest.mark.parametrize("name", STEPS45)
def test_constant_ops_m45_p19_equal_reference(chain45, name):
    jsteps, tsteps, sk, ea, oracle = chain45
    _same(jsteps[name], tsteps[name])
    assert PtxtBGV.decode(ea, sk.decrypt_bgv(tsteps[name])) == oracle[name]


def test_add_constant_fat_takes_the_scalar_branch_at_p19(chain45):
    _, tsteps, _, ea, _ = chain45
    for name in ("add_constant_fat", "add_constant_fat_intfactor"):
        assert ea.pr == 19 and tsteps[name]._q_factor() not in (0, 1)


def test_hwt_secret_key_equals_reference():
    params = dict(m=255, p=2, r=1, bits=120, c=3, mvec=(3, 5, 17))
    jc, tc = JContext(**params), TContext(**params, device="cpu")
    jsk, tsk = JSecKey(jc, seed=141, hwt=64), TSecKey(tc, seed=141, hwt=64)
    np.testing.assert_array_equal(tsk.s_coeffs, jsk.s_coeffs)
    assert np.count_nonzero(tsk.s_coeffs) == 64
    assert tsk.sk_bound == jsk.sk_bound == tc.noise_hwt(64)
    np.testing.assert_array_equal(to_host(tsk.s_full), np.asarray(jsk.s_full))
    jpk, tpk = JPubKey(jsk), TPubKey(tsk)
    for (_, a), (_, b) in zip(tpk.enc_key, jpk.enc_key):
        np.testing.assert_array_equal(to_host(a), np.asarray(b))


def test_ckks_encode_ptxt_equals_reference():
    params = dict(m=256, p=-1, r=30, bits=240, c=3, scheme="ckks")
    jea = JCKKS(JContext(**params))
    tctx = TContext(**params, device="cpu")
    tea = TCKKS(tctx)
    z = np.random.default_rng(41).normal(size=tea.nslots) * (1 + 0.5j)
    for scale in (None, 1 << 20):
        j, t = jea.encode_ptxt(z, scale), tea.encode_ptxt(z, scale)
        np.testing.assert_array_equal(t.coeffs, j.coeffs)
        assert (t.scale, t.mag, t.space) == (j.scale, j.mag, j.space)
        assert not t.is_bgv
        fat = t.fat(tctx)
        assert fat.space is None
        full = fat.rt(tctx.L, True)
        assert full.shape == (tctx.L + tctx.S, tctx.n_eval)
        assert torch.equal(fat.rt(2, True)[:2], full[:2])
        assert torch.equal(fat.rt(2, True)[2:], full[tctx.L:])
