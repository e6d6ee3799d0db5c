"""Port vs helib_tpu: CKKS at power-of-2 m (m=256/bits=240 and
m=1024/r=35/bits=300, the configs of test_ckks.py), power-of-2 BGV at m=64,
and CKKS state carried across with helib_tpu_torch.convert.

The same seeds feed both packages.  Residues, keys, ciphertexts, pipeline
outputs and the noise/scale metadata are compared exactly; decrypted slot
values are float decodes and are compared exactly with the reference's
decrypt and within 1e-3 of the numpy product."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helib_tpu.context import Context as JContext
from helib_tpu.ctxt import Ctxt as JCtxt
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.keys import SKHandle as JSKHandle
from helib_tpu.ckks import EncryptedArrayCKKS as JEA
from helib_tpu import pipeline as jpipe

from helib_tpu_torch import convert
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.keys import SKHandle as TSKHandle
from helib_tpu_torch.ckks import EncryptedArrayCKKS as TEA
from helib_tpu_torch.ckks_ptxt import PtxtCKKS
from helib_tpu_torch import pipeline as tpipe
from helib_tpu_torch.ops.modops import to_device, to_host

torch.set_num_threads(1)

CONFIGS = [dict(m=256, r=30, bits=240, c=3),
           dict(m=1024, r=35, bits=300, c=3)]
ORACLE_TOL = 1e-3      # decrypted product vs the numpy product


@pytest.fixture(scope="module", params=CONFIGS, ids=["m256", "m1024"])
def both(request):
    """Both packages' context, keys and slot views; keys drawn in the same
    order on both sides: the public key, then the relinearization matrix."""
    params = dict(p=-1, scheme="ckks", **request.param)
    jc, tc = JContext(**params), TContext(**params, device="cpu")
    jsk, tsk = JSecKey(jc, seed=9), TSecKey(tc, seed=9)
    jpk, tpk = JPubKey(jsk), TPubKey(tsk)
    jsk.gen_ks_matrix(JSKHandle(2, 1, 0))
    tsk.gen_ks_matrix(TSKHandle(2, 1, 0))
    return jc, tc, jsk, tsk, jpk, tpk, JEA(jc), TEA(tc)


def _eq(t, a):
    np.testing.assert_array_equal(to_host(t), np.asarray(a))


def _parts_eq(tct, jct):
    assert len(tct.parts) == len(jct.parts)
    for (th, t), (jh, a) in zip(tct.parts, jct.parts):
        assert (th.powS, th.powX, th.keyID) == (jh.powS, jh.powX, jh.keyID)
        _eq(t, a)


def _meta_eq(tct, jct):
    """Exact equality of the level, noise and scale metadata."""
    assert (tct.k, tct.special, tct.ptxt_space) == (
        jct.k, jct.special, jct.ptxt_space)
    assert tct.noise == jct.noise
    assert Fraction(tct.ratFactor) == Fraction(jct.ratFactor)
    assert tct.ptxtMag == jct.ptxtMag


def _slots(ea, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, ea.nslots)
            + 1j * rng.uniform(-1, 1, ea.nslots))


def _encrypt_pair(jea, tea, jpk, tpk, seed):
    z = [_slots(tea, seed + i) for i in range(2)]
    jct = [jea.encrypt(v, jpk, np.random.default_rng(seed + 10 + i))
           for i, v in enumerate(z)]
    tct = [tea.encrypt(v, tpk, np.random.default_rng(seed + 10 + i))
           for i, v in enumerate(z)]
    return z, jct, tct


def test_prime_chain_digits_and_pow2_tables(both):
    jc, tc = both[:2]
    np.testing.assert_array_equal(tc.qs, jc.qs)
    np.testing.assert_array_equal(tc.sp, jc.sp)
    assert tc.digits == jc.digits
    assert (tc.L, tc.S, tc.n_eval, tc.phi_m) == (jc.L, jc.S, jc.n_eval,
                                                 jc.phi_m)
    assert (tc.pal.nslots, tc.pal.d, tc.pal.pow2) == (
        jc.pal.nslots, jc.pal.d, jc.pal.pow2)
    np.testing.assert_array_equal(tc.pal.eval_exponents,
                                  jc.pal.eval_exponents)
    jt, tt = jc.ntt_fwd, tc.ntt_fwd
    for name in ("tw", "tw_sh", "itw", "itw_sh"):
        for t, a in zip(getattr(tt, name), getattr(jt, name)):
            np.testing.assert_array_equal(t, np.asarray(a), err_msg=name)
    np.testing.assert_array_equal(tt.ninv, np.asarray(jt.ninv))
    # the flat rows the kernel reads: the same stages, concatenated
    rows = tc.rows_of(2, True)
    flat = tt.flat(rows)
    idx = np.array(rows)
    for name, first in (("tw", None), ("itw", jt.ninv)):
        want = np.concatenate(
            [np.zeros((len(idx), 1), np.uint32) if first is None
             else np.asarray(first)[idx]]
            + [np.asarray(a)[idx] for a in getattr(jt, name)], axis=1)
        np.testing.assert_array_equal(flat[name + "_all"], want)
    # the device tree of a row subset slices every stage table
    tree = tc.ntt_tree(rows)["fwd"]
    _eq(tree["q"], tc.all_q[idx][:, None])
    _eq(tree["tw"][-1], np.asarray(jt.tw[-1])[idx])
    _eq(tree["flat"]["itw_all_sh"], flat["itw_all_sh"])


def test_seckey_pubkey_and_relin_matrix_bit_equal(both):
    jc, tc, jsk, tsk, jpk, tpk = both[:6]
    np.testing.assert_array_equal(tsk.s_coeffs, jsk.s_coeffs)
    assert tsk.sk_bound == jsk.sk_bound
    _eq(tsk.s_full, jsk.s_full)
    assert tpk.enc_noise == jpk.enc_noise
    for (_, t), (_, a) in zip(tpk.enc_key, jpk.enc_key):
        _eq(t, a)
    jW, tW = jsk.matrices[(2, 1)], tsk.matrices[(2, 1)]
    assert (tW.prg_seed, tW.ptxt_space, tW.noise) == (
        jW.prg_seed, jW.ptxt_space, jW.noise)
    assert tW.ptxt_space == 1
    for t, a in zip(tW.b + tW.a, jW.b + jW.a):
        _eq(t, a)


def test_encode_and_encrypt_bit_equal(both):
    jea, tea = both[6:]
    z = _slots(tea, 1)
    np.testing.assert_array_equal(tea.slot_exp, jea.slot_exp)
    tcf, tscale, tmag, terr = tea.encode(z)
    jcf, jscale, jmag, jerr = jea.encode(z)
    assert list(tcf) == list(jcf)
    assert (tscale, tmag, terr) == (jscale, jmag, jerr)
    np.testing.assert_array_equal(tea.embed(tea.unembed(z)),
                                  jea.embed(jea.unembed(z)))
    _, jct, tct = _encrypt_pair(jea, tea, *both[4:6], seed=2)
    for t, j in zip(tct, jct):
        _parts_eq(t, j)
        _meta_eq(t, j)


def test_multiply_rescale_metadata_and_decrypt(both):
    jc, tc, jsk, tsk, jpk, tpk, jea, tea = both
    z, jct, tct = _encrypt_pair(jea, tea, jpk, tpk, seed=3)
    jprod, tprod = jct[0].multiply(jct[1], jsk), tct[0].multiply(tct[1], tsk)
    _meta_eq(tprod, jprod)
    _parts_eq(tprod, jprod)
    jea.rescale(jprod)
    tea.rescale(tprod)
    assert tprod.k < tc.L
    _meta_eq(tprod, jprod)
    _parts_eq(tprod, jprod)
    assert tprod.is_correct() and tprod.error_bound() == jprod.error_bound()
    got = tea.decrypt(tprod, tsk)
    np.testing.assert_array_equal(got, jea.decrypt(jprod, jsk))
    np.testing.assert_array_equal(tea.raw_decrypt(tprod, tsk),
                                  jea.raw_decrypt(jprod, jsk))
    want = PtxtCKKS(tea, z[0]).multiply(PtxtCKKS(tea, z[1]))
    assert want.distance(PtxtCKKS(tea, got)) < ORACLE_TOL


def test_square_add_and_mul_const(both):
    """Square, add (same level, and across levels with the scale-aligning
    multiply) and a constant multiply keep the same residues and metadata
    as the reference.  Adding across levels mod-switches the fresh operand
    down, which divides its scale by the dropped prime in both packages, so
    only the same-level sum is held against the numpy oracle."""
    jc, tc, jsk, tsk, jpk, tpk, jea, tea = both
    z, jct, tct = _encrypt_pair(jea, tea, jpk, tpk, seed=4)
    jsum, tsum = jct[1].copy().add(jct[0]), tct[1].copy().add(tct[0])
    _meta_eq(tsum, jsum)
    _parts_eq(tsum, jsum)
    got = tea.decrypt(tsum, tsk)
    np.testing.assert_array_equal(got, jea.decrypt(jsum, jsk))
    assert float(np.max(np.abs(got - (z[1] + z[0])))) < ORACLE_TOL
    jsq, tsq = jct[0].square(jsk), tct[0].square(tsk)
    jea.rescale(jsq)
    tea.rescale(tsq)
    _meta_eq(tsq, jsq)
    jmix, tmix = jct[1].copy().add(jsq), tct[1].copy().add(tsq)
    assert Fraction(tmix.ratFactor) == Fraction(tsq.ratFactor)
    _meta_eq(tmix, jmix)
    _parts_eq(tmix, jmix)
    c = _slots(tea, 5)
    jmc, tmc = jea.mul_const(jct[1], c), tea.mul_const(tct[1], c)
    _meta_eq(tmc, jmc)
    _parts_eq(tmc, jmc)
    got = tea.decrypt(tea.rescale(tmc), tsk)
    np.testing.assert_array_equal(got, jea.decrypt(jea.rescale(jmc), jsk))
    assert float(np.max(np.abs(got - z[1] * c))) < ORACLE_TOL


def test_batched_mult_relin_bit_equal_to_jitted_reference(both):
    jc, tc, jsk, tsk, jpk, tpk = both[:6]
    assert tpipe.fresh_noise(tc, tpk) == jpipe.fresh_noise(jc, jpk)
    jfn, jex = jpipe.make_batched_mult_relin(jc, jsk, 2)
    tfn, tex = tpipe.make_batched_mult_relin(tc, tsk, 2)
    for t, a in zip(tex, jex):
        _eq(t, a)
    rng = np.random.default_rng(6)
    qs = tc.qs.astype(np.int64)[:, None]
    x = [rng.integers(0, qs, (2, tc.L, tc.n_eval)).astype(np.uint32)
         for _ in range(4)]
    ref = jax.jit(jfn)(*map(jnp.asarray, x))
    got = tfn(*[to_device(a, "cpu") for a in x])
    for g, r in zip(got, ref):
        assert g.shape == (2, tc.L, tc.n_eval)
        _eq(g, r)


def test_pipeline_ckks_metadata_matches_traced_reference(both):
    """mult_relin under CKKS: plaintext space 1, scale P/P = 1, and the
    reference's traced noise."""
    jc, tc, jsk, tsk, jpk, tpk = both[:6]
    noise = jpipe.fresh_noise(jc, jpk)
    seen = {}

    def traced(a, b, c, d):
        def mk(x, y):
            return JCtxt(jc, jpk, [(JSKHandle(0, 1, 0), x),
                                   (JSKHandle(1, 1, 0), y)],
                         jc.L, False, 1, noise, 1)
        out = mk(a, b).tensor(mk(c, d))
        out.relinearize(jsk)
        out.drop_special_primes()
        seen["out"] = out
        parts = dict((h.powS, v) for h, v in out.parts)
        return parts[0], parts[1]

    rng = np.random.default_rng(7)
    qs = tc.qs.astype(np.int64)[:, None]
    x = [rng.integers(0, qs, (tc.L, tc.n_eval)).astype(np.uint32)
         for _ in range(4)]
    jax.jit(traced)(*map(jnp.asarray, x))
    out = tpipe.mult_relin(tc, tpk, tsk, noise, tc.L,
                           *[to_device(a, "cpu") for a in x])
    _meta_eq(out, seen["out"])
    assert out.ptxt_space == 1 and out.ratFactor == 1


def _seckey_arrays(jsk):
    return dict(
        skeys=[{"coeffs": s["coeffs"], "bound": s["bound"],
                "full": np.asarray(s["full"])} for s in jsk.skeys],
        matrices={k: convert.ksmatrix_arrays(W)
                  for k, W in jsk.matrices.items()},
        rng_state=jsk.rng.bit_generator.state)


def test_convert_carries_ckks_state_and_decrypts_product(both):
    """A helib_tpu CKKS context, key and ciphertexts carried across; the
    port multiplies, rescales and decrypts them to the reference's
    values, and a port ciphertext carried back decrypts under JAX."""
    jc, tc, jsk, _, jpk, _, jea, _ = both
    ctx = convert.context_from_params(convert.context_params(jc), "cpu")
    assert ctx.scheme == "ckks" and ctx.r == jc.r
    sk = convert.seckey_from_arrays(ctx, **_seckey_arrays(jsk))
    pk = convert.pubkey_from_arrays(
        ctx, [((h.powS, h.powX, h.keyID), np.asarray(d))
              for h, d in jpk.enc_key], jpk.enc_noise, jpk.sk_bound,
        sk.matrices)
    ea = TEA(ctx)
    z = [_slots(ea, 30 + i) for i in range(2)]
    jct = [jea.encrypt(v, jpk, np.random.default_rng(40 + i))
           for i, v in enumerate(z)]
    cts = [convert.ctxt_from_arrays(ctx, pk, **convert.ctxt_arrays(c))
           for c in jct]
    for t, j in zip(cts, jct):
        _meta_eq(t, j)
    prod = ea.rescale(cts[0].multiply(cts[1], pk))
    jprod = jea.rescale(jct[0].multiply(jct[1], jsk))
    _meta_eq(prod, jprod)
    got = ea.decrypt(prod, sk)
    np.testing.assert_array_equal(got, jea.decrypt(jprod, jsk))
    assert float(np.max(np.abs(got - z[0] * z[1]))) < ORACLE_TOL
    fields = convert.ctxt_arrays(prod)
    back = JCtxt(jc, jpk, [(JSKHandle(*h), jnp.asarray(d))
                           for h, d in fields.pop("parts")], **fields)
    np.testing.assert_array_equal(jea.decrypt(back, jsk), got)


def test_pow2_bgv_matches_reference():
    """BGV at power-of-2 m (the pow2 case of test_bgv.py): primes, keys,
    encryption, multiply and decrypt."""
    params = dict(m=64, p=17, r=1, bits=120, c=2)
    jc, tc = JContext(**params), TContext(**params, device="cpu")
    np.testing.assert_array_equal(tc.all_q, jc.all_q)
    assert tc.pal.gens == jc.pal.gens and tc.pal.nslots == jc.pal.nslots
    jsk, tsk = JSecKey(jc, seed=42), TSecKey(tc, seed=42)
    jpk, tpk = JPubKey(jsk), TPubKey(tsk)
    jsk.gen_ks_matrix(JSKHandle(2, 1, 0))
    tsk.gen_ks_matrix(TSKHandle(2, 1, 0))
    _eq(tsk.s_full, jsk.s_full)
    rng = np.random.default_rng(7)
    pts = [rng.integers(0, 17, tc.phi_m) for _ in range(2)]
    jct = [jpk.encrypt_bgv(pt, np.random.default_rng(50 + i))
           for i, pt in enumerate(pts)]
    tct = [tpk.encrypt_bgv(pt, np.random.default_rng(50 + i))
           for i, pt in enumerate(pts)]
    for t, j in zip(tct, jct):
        _parts_eq(t, j)
    jprod, tprod = jct[0].multiply(jct[1], jsk), tct[0].multiply(tct[1], tsk)
    assert (tprod.k, tprod.special) == (jprod.k, jprod.special)
    assert abs(tprod.noise - jprod.noise) <= 1e-9
    _parts_eq(tprod, jprod)
    # negacyclic product mod X^32 + 1 mod 17
    full = np.convolve(pts[0], pts[1])
    want = full[:32].copy()
    want[:len(full) - 32] -= full[32:]
    np.testing.assert_array_equal(tsk.decrypt_bgv(tprod), want % 17)
    np.testing.assert_array_equal(jsk.decrypt_bgv(jprod), want % 17)


# decrypt limits of tests/test_ckks.py:92-127
ROTATION_OPS = {"rotate": 1e-3, "rotate5": 1e-3, "conjugate": 1e-3,
                "shift": 1e-2, "real": 1e-2, "imag": 1e-2}


def _rotation_op(name, ea, ct, key):
    if name == "rotate":
        return ea.rotate(ct, 1, key), lambda z: np.roll(z, 1)
    if name == "rotate5":
        return ea.rotate(ct, 5, key), lambda z: np.roll(z, 5)
    if name == "conjugate":
        return ct.conjugate(key), np.conj
    if name == "shift":
        def shifted(z):
            out = np.roll(z, 1)
            out[0] = 0
            return out
        return ea.shift(ct, 1, key), shifted
    if name == "real":
        return ea.extract_real_part(ct, key), \
            lambda z: np.real(z).astype(np.complex128)
    return ea.extract_imaginary_part(ct, key), \
        lambda z: np.imag(z).astype(np.complex128)


@pytest.mark.parametrize("op", list(ROTATION_OPS))
def test_rotation_family_bit_equal_and_decrypts(both, op):
    """rotate (by 1 and 5), conjugate, shift and the real/imaginary
    extraction: residues and metadata equal helib_tpu's, so do the
    decrypted slots, which hold the numpy oracle within test_ckks.py's
    limits.  The key-switching matrices are minted on first use, in the
    same order on both sides."""
    jc, tc, jsk, tsk, jpk, tpk, jea, tea = both
    z = _slots(tea, 60)
    jct = jea.encrypt(z, jpk, np.random.default_rng(61))
    tct = tea.encrypt(z, tpk, np.random.default_rng(61))
    jout, want = _rotation_op(op, jea, jct, jsk)
    tout, _ = _rotation_op(op, tea, tct, tsk)
    _meta_eq(tout, jout)
    _parts_eq(tout, jout)
    got = tea.decrypt(tout, tsk)
    np.testing.assert_array_equal(got, jea.decrypt(jout, jsk))
    assert float(np.max(np.abs(got - want(z)))) < ROTATION_OPS[op]
