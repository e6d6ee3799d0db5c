"""Port vs helib_tpu: the batched BGV mult+relin pipeline (the main path)
bit for bit against the jitted reference, its noise metadata, the eager
multiply with measured mod-switch noise, and the decrypt oracle."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helib_tpu.context import Context as JContext
from helib_tpu.ctxt import Ctxt as JCtxt
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.keys import SKHandle as JSKHandle
from helib_tpu import pipeline as jpipe

from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.keys import SecKey as TSecKey, reduce_mod_phim
from helib_tpu_torch.keys import PubKey as TPubKey, SKHandle as TSKHandle
from helib_tpu_torch import pipeline as tpipe
from helib_tpu_torch.ops.modops import to_device, to_host

torch.set_num_threads(1)


def _pair(m, bits, seed=3):
    params = dict(m=m, p=2, r=1, bits=bits, c=3)
    jc, tc = JContext(**params), TContext(**params, device="cpu")
    jsk, tsk = JSecKey(jc, seed=seed), TSecKey(tc, seed=seed)
    return jc, tc, jsk, tsk


@pytest.fixture(scope="module")
def both():
    """Keys drawn in the same order on both sides whichever test runs
    first: the public key, then the relinearization matrix."""
    jc, tc, jsk, tsk = _pair(31, 300)
    JPubKey(jsk)
    TPubKey(tsk)
    jsk.gen_ks_matrix(JSKHandle(2, 1, 0))
    tsk.gen_ks_matrix(TSKHandle(2, 1, 0))
    return jc, tc, jsk, tsk


def _parts(ctx, batch, seed):
    qs = ctx.primes_of(ctx.L, False).astype(np.int64)
    rng = np.random.default_rng(seed)
    return [rng.integers(0, qs[:, None], (batch, ctx.L, ctx.n_eval)
                         ).astype(np.uint32) for _ in range(4)]


def _check_batched(jc, tc, jsk, tsk, batch, seed):
    jfn, jex = jpipe.make_batched_mult_relin(jc, jsk, batch)
    tfn, tex = tpipe.make_batched_mult_relin(tc, tsk, batch)
    for t, a in zip(tex, jex):
        np.testing.assert_array_equal(to_host(t), np.asarray(a))
    x = _parts(jc, batch, seed)
    ref = jax.jit(jfn)(*map(jnp.asarray, x))
    got = tfn(*[to_device(a, "cpu") for a in x])
    for g, r in zip(got, ref):
        assert g.shape == (batch, tc.L, tc.n_eval)
        np.testing.assert_array_equal(to_host(g), np.asarray(r))


def test_batched_mult_relin_bit_equal_to_jitted_reference(both):
    _check_batched(*both, batch=2, seed=1)


def test_pipeline_noise_matches_traced_reference(both):
    jc, tc, jsk, tsk = both
    jpk, tpk = jsk.pubkey, tsk.pubkey
    noise = jpipe.fresh_noise(jc, jpk)
    assert abs(tpipe.fresh_noise(tc, tpk) - noise) <= 1e-9
    seen = {}

    def traced(a, b, c, d):
        def mk(x, y):
            return JCtxt(jc, jpk, [(JSKHandle(0, 1, 0), x),
                                   (JSKHandle(1, 1, 0), y)],
                         jc.L, False, 2, noise, 1)
        out = mk(a, b).tensor(mk(c, d))
        out.relinearize(jsk)
        out.drop_special_primes()
        seen.update(noise=out.noise, k=out.k, special=out.special,
                    ptxt_space=out.ptxt_space)
        parts = dict((h.powS, v) for h, v in out.parts)
        return parts[0], parts[1]

    x = [a[0] for a in _parts(jc, 1, seed=2)]
    ref = jax.jit(traced)(*map(jnp.asarray, x))
    out = tpipe.mult_relin(tc, tpk, tsk, noise, tc.L,
                           *[to_device(a, "cpu") for a in x])
    assert abs(out.noise - seen["noise"]) <= 1e-9
    assert (out.k, out.special, out.ptxt_space) == (
        seen["k"], seen["special"], seen["ptxt_space"])
    parts = dict((h.powS, v) for h, v in out.parts)
    for i in (0, 1):
        np.testing.assert_array_equal(to_host(parts[i]), np.asarray(ref[i]))


def test_eager_multiply_measured_noise_and_decrypt_oracle(both):
    jc, tc, jsk, tsk = both
    jpk, tpk = jsk.pubkey, tsk.pubkey
    rng = np.random.default_rng(8)
    pts = [rng.integers(0, 2, jc.phi_m) for _ in range(2)]
    want = reduce_mod_phim(np.convolve(pts[0], pts[1]) % 2, tc, 2)
    jct = [jpk.encrypt_bgv(pt, np.random.default_rng(20 + i))
           for i, pt in enumerate(pts)]
    tct = [tpk.encrypt_bgv(pt, np.random.default_rng(20 + i))
           for i, pt in enumerate(pts)]
    jprod, tprod = jct[0].multiply(jct[1], jsk), tct[0].multiply(tct[1], tsk)
    for j, t in ((jprod, tprod), (jct[0], tct[0])):
        assert (t.k, t.special) == (j.k, j.special)
        assert abs(t.noise - j.noise) <= 1e-9
        for (_, a), (_, b) in zip(t.parts, j.parts):
            np.testing.assert_array_equal(to_host(a), np.asarray(b))
    np.testing.assert_array_equal(tsk.decrypt_bgv(tprod), want)
    np.testing.assert_array_equal(jsk.decrypt_bgv(jprod), want)
    jprod.drop_special_primes()
    tprod.drop_special_primes()
    assert abs(tprod.noise - jprod.noise) <= 1e-9
    np.testing.assert_array_equal(tsk.decrypt_bgv(tprod), want)
    # add across levels: the fresh ciphertext is mod-switched down first
    jsum, tsum = jct[0].copy().add(jprod), tct[0].copy().add(tprod)
    assert (tsum.k, tsum.special) == (jsum.k, jsum.special)
    assert abs(tsum.noise - jsum.noise) <= 1e-9
    for (_, a), (_, b) in zip(tsum.parts, jsum.parts):
        np.testing.assert_array_equal(to_host(a), np.asarray(b))
    np.testing.assert_array_equal(
        tsk.decrypt_bgv(tsum), (want + reduce_mod_phim(pts[0], tc, 2)) % 2)


@pytest.mark.slow
def test_batched_mult_relin_bit_equal_at_m8009():
    _check_batched(*_pair(8009, 380), batch=1, seed=4)
