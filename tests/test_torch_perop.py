"""Port vs helib_tpu: the per-op BGV family -- rotate (make_automorph_relin
against the jitted reference; smart_automorph with a hop path, frobenius,
sub and negate against the eager reference, whose mod-switch noise is
measured as the port's is), the key-switching strategies, encryption with
on-device sampling (held through decryption: its random bits are torch's),
the I/O formats byte for byte in both directions, and key matrices carried
across by convert.py."""

import io

import numpy as np
import pytest
import torch

import jax

from helib_tpu import io as jio
from helib_tpu import ksstrategy as jks
from helib_tpu import pipeline as jpipe
from helib_tpu.context import Context as JContext
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.keys import SKHandle as JSKHandle
from helib_tpu.ops import ntt as jntt

from helib_tpu_torch import convert
from helib_tpu_torch import dryrun
from helib_tpu_torch import io as tio
from helib_tpu_torch import ksstrategy as tks
from helib_tpu_torch import pipeline as tpipe
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ctxt import Ctxt as TCtxt
from helib_tpu_torch.dcrt import (sample_small_rt_dev, sample_gaussian_rt_dev,
                                  small_coeffs_to_rt)
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.keys import SKHandle as TSKHandle, reduce_mod_phim
from helib_tpu_torch.ops.modops import to_host

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _staged_reference(monkeypatch):
    monkeypatch.setattr(jntt, "USE_PALLAS", False)


def _kexp(ctx):
    """make_automorph_relin's default: the first hypercube generator, 3
    where there is none (m=32003, p=2 has one slot)."""
    return ctx.pal.gens[0] if ctx.pal.gens else 3


def _keys(m, bits, seed, frobenius=True):
    """Contexts and keys on both sides, drawn in one order: the public key,
    the default rotation's matrix, the Frobenius matrices."""
    params = dict(m=m, p=2, r=1, bits=bits, c=3)
    jc, tc = JContext(**params), TContext(**params, device="cpu")
    jsk, tsk = JSecKey(jc, seed=seed), TSecKey(tc, seed=seed)
    JPubKey(jsk)
    TPubKey(tsk)
    g = _kexp(tc)
    jsk.gen_ks_matrix(JSKHandle(1, g, 0))
    tsk.gen_ks_matrix(TSKHandle(1, g, 0))
    if frobenius:
        jks.add_frb_matrices(jsk)
        tks.add_frb_matrices(tsk)
    return jc, tc, jsk, tsk


@pytest.fixture(scope="module", params=[31, 127])
def both(request):
    return _keys(request.param, 300, seed=5)


def _same(j, t):
    """Equal residues, handles and noise metadata."""
    assert (t.k, t.special, t.ptxt_space, t.intFactor) == (
        j.k, j.special, j.ptxt_space, j.intFactor)
    assert abs(t.noise - j.noise) <= 1e-9
    assert [(h.powS, h.powX, h.keyID) for h, _ in t.parts] == [
        (h.powS, h.powX, h.keyID) for h, _ in j.parts]
    for (_, a), (_, b) in zip(t.parts, j.parts):
        np.testing.assert_array_equal(to_host(a), np.asarray(b))


def _encrypt_pair(jc, tc, jsk, tsk, seed):
    pt = np.random.default_rng(seed).integers(0, 2, tc.phi_m)
    jct = jsk.pubkey.encrypt_bgv(pt, np.random.default_rng(seed + 1))
    tct = tsk.pubkey.encrypt_bgv(pt, np.random.default_rng(seed + 1))
    _same(jct, tct)
    return pt, jct, tct


def _automorph_pt(pt, kexp, ctx):
    """pt(X^kexp) mod Phi_m mod 2 (host)."""
    out = np.zeros(ctx.m, dtype=np.int64)
    np.add.at(out, (np.arange(len(pt)) * kexp) % ctx.m, pt)
    return reduce_mod_phim(out % 2, ctx, 2)


def test_automorph_relin_bit_equal_to_jitted_reference(both):
    jc, tc, jsk, tsk = both
    jfn, jex = jpipe.make_automorph_relin(jc, jsk)
    tfn, tex = tpipe.make_automorph_relin(tc, tsk)
    for t, a in zip(tex, jex):
        np.testing.assert_array_equal(to_host(t), np.asarray(a))
    ref = jax.jit(jfn)(*jex)
    got = tfn(*tex)
    for g, r in zip(got, ref):
        assert g.shape == (tc.L, tc.n_eval)
        np.testing.assert_array_equal(to_host(g), np.asarray(r))


def test_smart_automorph_hop_path_and_frobenius(both):
    jc, tc, jsk, tsk = both
    m, g = tc.m, tc.pal.gens[0]
    # the first power of g without an exact matrix: reached by hops
    kexp = next(pow(g, j, m) for j in range(2, m)
                if (1, pow(g, j, m)) not in tsk.matrices)
    path = tks.hop_path(tsk, kexp)
    assert path == jks.hop_path(jsk, kexp) and len(path) >= 2
    pt, jct, tct = _encrypt_pair(jc, tc, jsk, tsk, seed=11)
    with dryrun.record_automorphs() as seen:
        trot = tct.copy().smart_automorph(kexp, tsk)
    assert seen == {kexp}
    _same(jct.copy().smart_automorph(kexp, jsk), trot)
    np.testing.assert_array_equal(tsk.decrypt_bgv(trot),
                                  _automorph_pt(pt, kexp, tc))
    tfrob = tct.copy().frobenius(1, tsk)
    _same(jct.copy().frobenius(1, jsk), tfrob)
    np.testing.assert_array_equal(tsk.decrypt_bgv(tfrob),
                                  _automorph_pt(pt, 2, tc))


def test_sub_and_negate(both):
    jc, tc, jsk, tsk = both
    pt0, jc0, tc0 = _encrypt_pair(jc, tc, jsk, tsk, seed=21)
    pt1, jc1, tc1 = _encrypt_pair(jc, tc, jsk, tsk, seed=23)
    tdiff = tc0.copy().sub(tc1)
    _same(jc0.copy().sub(jc1), tdiff)
    _same(tc0.copy().add(tc1, sub=True), tdiff)
    want = reduce_mod_phim((pt0 - pt1) % 2, tc, 2)
    np.testing.assert_array_equal(tsk.decrypt_bgv(tdiff), want)
    tneg = tc0.copy().negate()
    _same(jc0.copy().negate(), tneg)
    np.testing.assert_array_equal(tsk.decrypt_bgv(tneg),
                                  reduce_mod_phim(pt0, tc, 2))


def test_key_switching_strategies_match_reference():
    """The same matrices, in the same order, bit for bit; the same hop
    paths."""
    jc, tc = JContext(m=31, p=2, r=1, bits=60, c=3), TContext(
        m=31, p=2, r=1, bits=60, c=3, device="cpu")
    jsk, tsk = JSecKey(jc, seed=9), TSecKey(tc, seed=9)
    for name in ("add_some_1d_matrices", "add_minimal_frb_matrices",
                 "add_minimal_1d_matrices", "add_relin_matrix"):
        getattr(jks, name)(jsk)
        getattr(tks, name)(tsk)
    assert list(tsk.matrices) == list(jsk.matrices)
    for key, W in tsk.matrices.items():
        J = jsk.matrices[key]
        assert (W.prg_seed, W.ptxt_space) == (J.prg_seed, J.ptxt_space)
        for a, b in zip(W.b + W.a, J.b + J.a):
            np.testing.assert_array_equal(to_host(a), np.asarray(b))
    for kexp in range(2, 31):
        assert tks.hop_path(tsk, kexp) == jks.hop_path(jsk, kexp)
    assert tks.ks_giant_step_size(10) == jks.ks_giant_step_size(10) == 4


def test_encrypt_decrypts_and_is_deterministic(both):
    jc, tc, jsk, tsk = both
    pk = tsk.pubkey
    fn = tpipe.make_encrypt(tc, pk)
    pt = np.random.default_rng(31).integers(0, 2, tc.phi_m)
    pt_eval = small_coeffs_to_rt(tc, pt, tc.L, False)
    outs = [fn(torch.Generator().manual_seed(s), pt_eval) for s in (7, 7, 8)]
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    assert not torch.equal(outs[0][0], outs[2][0])
    noise = tpipe.fresh_noise(tc, pk)
    assert abs(noise - jpipe.fresh_noise(jc, jsk.pubkey)) <= 1e-9
    for c0, c1 in (outs[0], outs[2]):
        ct = TCtxt(tc, pk, [(TSKHandle(0, 1, 0), c0),
                            (TSKHandle(1, 1, 0), c1)],
                   tc.L, False, 2, noise, 1)
        np.testing.assert_array_equal(tsk.decrypt_bgv(ct),
                                      reduce_mod_phim(pt, tc, 2))


def test_device_samplers_follow_their_distributions():
    """{-1, 0, 1} with probabilities 1/4, 1/2, 1/4 and round(N(0,1) sigma)
    * mult, checked on 40 draws of m=127 within 6 standard deviations."""
    tc = TContext(m=127, p=2, r=1, bits=60, c=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    rows = tc.rows_of(tc.L, False)
    qs = tc.qs[:, None].astype(np.int64)

    def coeffs(x):
        """The one small integer vector every prime row holds."""
        c = to_host(tc.inv_ntt(x, rows)).astype(np.int64)
        c = np.where(c > qs // 2, c - qs, c)
        assert np.all(c == c[:1])
        return c[0]
    small, gauss = [], []
    for _ in range(40):
        r, bound = sample_small_rt_dev(tc, gen, tc.L, False)
        small.append(coeffs(r))
        e, gbound = sample_gaussian_rt_dev(tc, gen, tc.L, False, mult=2)
        gauss.append(coeffs(e))
    small, gauss = np.concatenate(small), np.concatenate(gauss)
    n = small.size
    assert set(np.unique(small)) <= {-1, 0, 1}
    for v, p in ((-1, 0.25), (0, 0.5), (1, 0.25)):
        assert abs(np.sum(small == v) - n * p) <= 6 * np.sqrt(n * p * (1 - p))
    assert bound == tc.noise_small(0.5)
    assert np.all(gauss % 2 == 0)
    sigma = tc.eff_stdev()
    g = gauss / 2
    assert abs(g.mean()) <= 6 * sigma / np.sqrt(n)
    assert abs(g.std() / sigma - 1) <= 6 / np.sqrt(2 * n)
    assert abs(gbound - (1 + tc.noise_gaussian(sigma))) <= 1e-12


def _bytes(write, *args):
    buf = io.BytesIO()
    write(buf, *args)
    return buf.getvalue()


def test_io_bytes_equal_and_cross_read(both):
    jc, tc, jsk, tsk = both
    pt, jct, tct = _encrypt_pair(jc, tc, jsk, tsk, seed=41)
    tct = tct.copy().multiply(tct, tsk)      # specials in, a product ctxt
    jct = jct.copy().multiply(jct, jsk)
    for wname in ("write_context", "write_ctxt", "write_seckey",
                  "write_pubkey"):
        jobj, tobj = {"write_context": (jc, tc), "write_ctxt": (jct, tct),
                      "write_seckey": (jsk, tsk),
                      "write_pubkey": (jsk.pubkey, tsk.pubkey)}[wname]
        tb = _bytes(getattr(tio, wname), tobj)
        assert tb == _bytes(getattr(jio, wname), jobj), wname
    assert tio.context_to_json(tc) == jio.context_to_json(jc)
    assert tio.ctxt_to_json(tct) == jio.ctxt_to_json(jct)

    # the port reads helib_tpu's files ...
    ctx2 = tio.read_context(io.BytesIO(_bytes(jio.write_context, jc)),
                            device="cpu")
    assert np.array_equal(ctx2.all_q, tc.all_q)
    sk2 = tio.read_seckey(io.BytesIO(_bytes(jio.write_seckey, jsk)), ctx2)
    pk2 = tio.read_pubkey(io.BytesIO(_bytes(jio.write_pubkey, jsk.pubkey)),
                          ctx2, sk2)
    assert sk2.matrices is pk2.matrices and list(pk2.matrices) == list(
        tsk.matrices)
    for key, W in pk2.matrices.items():
        for a, b in zip(W.b + W.a, tsk.matrices[key].b + tsk.matrices[key].a):
            assert torch.equal(a, b)
    ct2 = tio.read_ctxt(io.BytesIO(_bytes(jio.write_ctxt, jct)), ctx2, pk2)
    _same(jct, ct2)
    np.testing.assert_array_equal(sk2.decrypt_bgv(ct2),
                                  tsk.decrypt_bgv(tct))
    ct3 = tio.ctxt_from_json(jio.ctxt_to_json(jct), ctx2, pk2)
    _same(jct, ct3)
    assert tio.context_from_json(jio.context_to_json(jc),
                                 device="cpu").L == tc.L
    # ... and helib_tpu reads the port's
    jc2 = jio.read_context(io.BytesIO(_bytes(tio.write_context, tc)))
    jsk2 = jio.read_seckey(io.BytesIO(_bytes(tio.write_seckey, tsk)), jc2)
    jpk2 = jio.read_pubkey(io.BytesIO(_bytes(tio.write_pubkey, tsk.pubkey)),
                           jc2, jsk2)
    jct2 = jio.read_ctxt(io.BytesIO(_bytes(tio.write_ctxt, tct)), jc2, jpk2)
    _same(jct2, tct)
    np.testing.assert_array_equal(jsk2.decrypt_bgv(jct2),
                                  tsk.decrypt_bgv(tct))
    _same(jio.ctxt_from_json(tio.ctxt_to_json(tct), jc2, jpk2), tct)


def test_convert_carries_rotation_and_frobenius_matrices(both):
    """helib_tpu's keys, matrices with powX != 1 included, carried into the
    port by convert.py rotate as the reference does."""
    jc, tc, jsk, tsk = both
    sk = convert.seckey_from_arrays(
        tc, [{k: np.asarray(v) for k, v in s.items()} for s in jsk.skeys],
        {key: convert.ksmatrix_arrays(W) for key, W in jsk.matrices.items()})
    jpk = jsk.pubkey
    sk.pubkey = convert.pubkey_from_arrays(
        tc, [((h.powS, h.powX, h.keyID), np.asarray(d))
             for h, d in jpk.enc_key], jpk.enc_noise, jpk.sk_bound,
        sk.matrices)
    assert any(key[1] != 1 for key in sk.matrices)
    pt, jct, tct = _encrypt_pair(jc, tc, jsk, tsk, seed=51)
    _same(jct.copy().frobenius(2, jsk), tct.copy().frobenius(2, sk))


@pytest.mark.slow
def test_automorph_relin_bit_equal_at_m32003():
    """The m=32003 rotate (B = 65536, K3's aux-major path) at 60 bits."""
    jc, tc, jsk, tsk = _keys(32003, 60, seed=2, frobenius=False)
    jfn, jex = jpipe.make_automorph_relin(jc, jsk)
    tfn, tex = tpipe.make_automorph_relin(tc, tsk)
    ref = jax.jit(jfn)(*jex)
    for g, r in zip(tfn(*tex), ref):
        np.testing.assert_array_equal(to_host(g), np.asarray(r))
