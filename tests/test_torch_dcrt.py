"""Port vs helib_tpu: the DoubleCRT ops of the mult+relin chain at m=31,
bits=300, c=3 -- scaled mod-down, mod-up by the special primes, digit
decomposition -- exact on batched inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helib_tpu import dcrt as jdcrt
from helib_tpu.context import Context as JContext

from helib_tpu_torch import dcrt as tdcrt
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ops.modops import to_device, to_host

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ctxs():
    jc = JContext(m=31, p=2, r=1, bits=300, c=3)
    tc = TContext(m=31, p=2, r=1, bits=300, c=3, device="cpu")
    np.testing.assert_array_equal(tc.all_q, jc.all_q)
    assert tc.digits == jc.digits
    return jc, tc


def _data(ctx, k, special, seed, batch=2):
    qs = ctx.primes_of(k, special).astype(np.int64)
    rng = np.random.default_rng(seed)
    return rng.integers(0, qs[:, None], (batch, len(qs), ctx.n_eval)
                        ).astype(np.uint32)


@pytest.mark.parametrize("k,special,new_k,new_special,pr,frac", [
    (11, True, 11, False, 2, False),      # drop the specials (relin tail)
    (11, True, 11, False, 2, True),
    (11, False, 8, False, 2, True),       # drop ctxt primes
    (9, True, 7, True, 1, False),         # keep the specials, no ptxt fix
])
def test_rt_scale_down(ctxs, k, special, new_k, new_special, pr, frac):
    jc, tc = ctxs
    x = _data(jc, k, special, seed=k + new_k)
    ref = jdcrt.rt_scale_down(jc, jnp.asarray(x), k, special, new_k,
                              new_special, pr, want_frac=frac)
    got = tdcrt.rt_scale_down(tc, to_device(x, "cpu"), k, special, new_k,
                              new_special, pr, want_frac=frac)
    if frac:
        (ref, ref_frac), (got, got_frac) = ref, got
        assert got_frac.dtype == torch.float32
        np.testing.assert_array_equal(got_frac.numpy(), np.asarray(ref_frac))
    np.testing.assert_array_equal(to_host(got), np.asarray(ref))


@pytest.mark.parametrize("k", [11, 6])
def test_rt_break_into_digits(ctxs, k):
    jc, tc = ctxs
    x = _data(jc, k, False, seed=k)
    ref, ref_noise = jdcrt.rt_break_into_digits(jc, jnp.asarray(x), k)
    got, got_noise = tdcrt.rt_break_into_digits(tc, to_device(x, "cpu"), k)
    assert len(got) == len(ref) == len(jc.digit_ranges(k))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(to_host(g), np.asarray(r))
    assert abs(got_noise - ref_noise) <= 1e-9


def test_rt_add_special_and_scale(ctxs):
    jc, tc = ctxs
    x = _data(jc, 11, False, seed=5)
    ref = jdcrt.rt_add_special_and_scale(jc, jnp.asarray(x), 11)
    got = tdcrt.rt_add_special_and_scale(tc, to_device(x, "cpu"), 11)
    np.testing.assert_array_equal(to_host(got), np.asarray(ref))


def test_host_sampling_and_crt(ctxs):
    jc, tc = ctxs
    for fn in ("sample_small_bounded", "sample_gaussian_bounded"):
        rj, rt = np.random.default_rng(9), np.random.default_rng(9)
        (cj, bj), (ct, bt) = getattr(jdcrt, fn)(jc, rj), getattr(tdcrt, fn)(
            tc, rt)
        np.testing.assert_array_equal(ct, cj)
        assert bt == bj
    np.testing.assert_array_equal(
        to_host(tdcrt.small_coeffs_to_rt(tc, ct, 11, True)),
        np.asarray(jdcrt.small_coeffs_to_rt(jc, cj, 11, True)))
    rows = tc.rows_of(11, True)
    big = [3**200, -(5**90), 7, -1, 0]
    np.testing.assert_array_equal(tdcrt.coeffs_to_residues(tc, big, rows),
                                  jdcrt.coeffs_to_residues(jc, big, rows))
    res = _data(jc, 11, False, seed=4, batch=1)[0]
    rows = tc.rows_of(11, False)
    got = tdcrt.crt_reconstruct(tc, res, rows)
    assert list(got) == list(jdcrt.crt_reconstruct(jc, res, rows))
