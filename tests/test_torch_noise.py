"""Port vs helib_tpu: noise measurement and its diagnostics -- SecKey.noise_of
on the same ciphertext (carried by helib_tpu_torch.convert) at BGV m=31 and
CKKS m=256, key_bound, balanced_mod, the native balanced_float_log2, the
HELIB_EXACT_MODSWITCH=0 and HELIB_STRICT_KS switches; and on the port alone
the fhe_stats ratios of tests/test_noise_stats.py and debugging.check_noise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helib_tpu.context import Context as JContext
from helib_tpu.ctxt import Ctxt as JCtxt
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.keys import SKHandle as JSKHandle, get_ks_matrix as jget
from helib_tpu.ckks import EncryptedArrayCKKS as JEACKKS
from helib_tpu.nt import native as jnative
from helib_tpu.nt.numbth import balanced_mod as jbalanced_mod
from helib_tpu.exceptions import LogicError as JLogicError

from helib_tpu_torch import convert, debugging, timing
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.keys import SKHandle, get_ks_matrix
from helib_tpu_torch.ckks import EncryptedArrayCKKS as TEACKKS
from helib_tpu_torch.ea import EncryptedArray as TEA
from helib_tpu_torch.nt import native as tnative
from helib_tpu_torch.nt.numbth import balanced_mod
from helib_tpu_torch.exceptions import LogicError

torch.set_num_threads(1)

PARAMS = dict(m=31, p=2, r=1, bits=300, c=3)          # test_torch_keys.py's
CKKS = dict(m=256, p=-1, r=20, bits=240, c=3, scheme="ckks")


def _parts(ct):
    return [((h.powS, h.powX, h.keyID), np.asarray(d)) for h, d in ct.parts]


def _carry(ctx, pk, jct):
    """helib_tpu ciphertext -> the port's, through convert.py."""
    return convert.ctxt_from_arrays(ctx, pk, _parts(jct), jct.k, jct.special,
                                    jct.ptxt_space, jct.noise, jct.intFactor)


@pytest.fixture(scope="module")
def bgv():
    jc, tc = JContext(**PARAMS), TContext(**PARAMS, device="cpu")
    jsk, tsk = JSecKey(jc, seed=7), TSecKey(tc, seed=7)
    tsk.gen_ks_matrix(SKHandle(2, 1, 0))
    jpk, tpk = JPubKey(jsk), TPubKey(tsk)
    pt = np.random.default_rng(2).integers(0, 2, jc.phi_m)
    jct = jpk.encrypt_bgv(pt, np.random.default_rng(5))
    return jc, tc, jsk, tsk, jpk, tpk, pt, jct


@pytest.fixture
def stats_on():
    timing.reset_stats()
    timing.fhe_stats = True
    yield
    timing.fhe_stats = False
    timing.reset_stats()


def test_noise_of_bgv_equals_helib_tpu(bgv):
    """A fresh helib_tpu encryption carried to the port, and a port product
    carried back: the same float, exactly."""
    jc, tc, jsk, tsk, jpk, tpk, pt, jct = bgv
    tct = _carry(tc, tpk, jct)
    fresh = tsk.noise_of(tct)
    assert fresh == jsk.noise_of(jct)
    assert fresh <= tct.noise + 0.5
    prod = tct.copy().multiply(tct, tsk)
    back = JCtxt(jc, jpk, [(JSKHandle(*h), jnp.asarray(d))
                           for h, d in convert.ctxt_to_arrays(prod)],
                 prod.k, prod.special, prod.ptxt_space, prod.noise)
    assert tsk.noise_of(prod) == jsk.noise_of(back)
    assert tsk.noise_of(prod) > fresh


def test_noise_of_ckks_equals_helib_tpu():
    jc, tc = JContext(**CKKS), TContext(**CKKS, device="cpu")
    jsk, tsk = JSecKey(jc, seed=3), TSecKey(tc, seed=3)
    jpk, tpk = JPubKey(jsk), TPubKey(tsk)
    rng = np.random.default_rng(257)
    vals = rng.normal(size=JEACKKS(jc).nslots)
    jct = JEACKKS(jc).encrypt(vals, jpk, rng)
    tct = convert.ctxt_from_arrays(
        tc, tpk, _parts(jct), jct.k, jct.special, jct.ptxt_space, jct.noise,
        jct.intFactor, jct.ratFactor, jct.ptxtMag)
    assert tsk.noise_of(tct) == jsk.noise_of(jct)


def test_key_bound_balanced_mod_and_float_log2(bgv):
    jc, tc, jsk, tsk, *_ = bgv
    assert tsk.key_bound(0) == jsk.key_bound(0) == tsk.sk_bound
    for a, m in [(0, 7), (3, 7), (4, 7), (-4, 7), (5, 10), (6, 10),
                 (2**70 + 5, 2**61 - 1), (-(2**65), 12)]:
        assert balanced_mod(a, m) == jbalanced_mod(a, m)
    qs = [int(q) for q in tc.all_q[:4]]
    rng = np.random.default_rng(41)
    res = rng.integers(0, np.array(qs)[:, None], (4, 64)).astype(np.uint32)
    tcomb, jcomb = tnative.combiner_for(qs), jnative.combiner_for(qs)
    assert (tcomb is None) == (jcomb is None)
    if tcomb is not None:
        tm, te = tcomb.balanced_float_log2(res)
        jm, je = jcomb.balanced_float_log2(res)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(te, je)


def test_exact_modswitch_off_gives_helib_tpu_bound(bgv, monkeypatch):
    """HELIB_EXACT_MODSWITCH=0: the worst-case mod-switch bound, as
    helib_tpu's; measured (the default), the noise is never larger."""
    jc, tc, jsk, tsk, jpk, tpk, pt, jct = bgv
    monkeypatch.setenv("HELIB_EXACT_MODSWITCH", "0")
    j = jct.copy()
    j.mod_down_to(jct.k - 2, False)
    t = _carry(tc, tpk, jct)
    t.mod_down_to(jct.k - 2, False)
    assert abs(t.noise - j.noise) <= 1e-9
    monkeypatch.delenv("HELIB_EXACT_MODSWITCH")
    measured = _carry(tc, tpk, jct)
    measured.mod_down_to(jct.k - 2, False)
    assert measured.noise <= t.noise + 1e-9
    np.testing.assert_array_equal(tsk.decrypt_bgv(measured), pt)


def test_strict_ks_refuses_to_mint(bgv, monkeypatch):
    jc, tc, jsk, tsk, *_ = bgv
    monkeypatch.setenv("HELIB_STRICT_KS", "1")
    with pytest.raises(LogicError):
        get_ks_matrix(tsk, SKHandle(1, 3, 0))
    with pytest.raises(JLogicError):
        jget(jsk, JSKHandle(1, 3, 0))
    assert (1, 3) not in tsk.matrices
    monkeypatch.delenv("HELIB_STRICT_KS")
    assert get_ks_matrix(tsk, SKHandle(1, 3, 0)) is tsk.matrices[(1, 3)]
    del tsk.matrices[(1, 3)]


def test_check_noise_after_multiply(bgv):
    jc, tc, jsk, tsk, jpk, tpk, pt, jct = bgv
    debugging.setup_debug_globals(tsk)
    try:
        ct = _carry(tc, tpk, jct)
        ct = ct.multiply(ct, tsk)
        assert debugging.check_noise(ct, "square")
    finally:
        debugging.setup_debug_globals(None)


def test_break_into_digits_and_ks_noise_ratios(stats_on):
    """tests/test_noise_stats.py's first ratio, on the port, and the
    KS-noise-ratio the same relinearizations update: a ratio of two
    estimates (key-switching noise over the product's), which helib_tpu
    gives as 1.60 and 1.23 on this circuit, so it is held to its count
    alone."""
    ctx = TContext(m=31, p=2, r=1, bits=500, c=3, device="cpu")
    sk = TSecKey(ctx, seed=211)
    pk = TPubKey(sk)
    ea = TEA(ctx)
    rng = np.random.default_rng(223)
    a = ea.encrypt(list(rng.integers(0, 2, ea.nslots)), pk, rng)
    b = ea.encrypt(list(rng.integers(0, 2, ea.nslots)), pk, rng)
    out = a.multiply(b, sk)
    out = out.multiply(out, sk)
    s = timing._stats["break-into-digits-ratio"]
    assert s.count >= 2
    assert s.max <= 1.0, f"digit norm exceeded bound: {s.max}"
    assert timing._stats["KS-noise-ratio"].count == 2


def test_ckks_encode_ratio(stats_on):
    ctx = TContext(**CKKS, device="cpu")
    eac = TEACKKS(ctx)
    rng = np.random.default_rng(227)
    for _ in range(4):
        vals = rng.normal(size=eac.nslots) + 1j * rng.normal(size=eac.nslots)
        eac.encode(vals)
    s = timing._stats["CKKS_encode_ratio"]
    assert s.count >= 4
    assert s.max <= 1.0, s.max


def test_deep_circuit_estimate_tracks_measured(stats_on):
    ctx = TContext(m=31, p=2, r=1, bits=500, c=3, device="cpu")
    sk = TSecKey(ctx, seed=229)
    pk = TPubKey(sk)
    ea = TEA(ctx)
    rng = np.random.default_rng(233)
    ct = ea.encrypt(list(rng.integers(0, 2, ea.nslots)), pk, rng)
    headroom = []
    for i in range(4):
        ct = ct.multiply(ct, sk)
        ct = ea.rotate(ct, 1 + (i % 2), sk)
        measured = sk.noise_of(ct)
        headroom.append(ct.noise - measured)
        assert measured <= ct.noise + 0.5, (i, measured, ct.noise)
    assert ct.is_correct()
    assert min(headroom) < 40, headroom
