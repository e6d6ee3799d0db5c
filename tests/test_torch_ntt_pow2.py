"""Port vs helib_tpu: the fused power-of-2 NTT (K2) -- its plain version
against the staged JAX transforms and the Pallas kernel in interpret mode,
the dispatch, the row-subset tables of a Context, and the wrapper's refusals
(the CUDA kernel itself: test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helib_tpu.context import Context as JContext
from helib_tpu.nt.primegen import gen_primes
from helib_tpu.ops import ntt as jntt
from helib_tpu.ops.pallas_ntt import apply_ntt

from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ops import ntt as tntt
from helib_tpu_torch.ops._build import launch_counts
from helib_tpu_torch.ops.ntt_fused import ntt, ntt_cuda, ntt_plain
from helib_tpu_torch.ops.modops import to_device, to_host

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _staged_reference(monkeypatch):
    monkeypatch.setattr(jntt, "USE_PALLAS", False)


def _case(n, P, lead, seed):
    qs = np.array(gen_primes(2 * n, P), dtype=np.uint32)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, qs[:, None].astype(np.int64),
                     lead + (P, n)).astype(np.uint32)
    return qs, x


@pytest.mark.parametrize("n", [8, 16, 64, 256, 2048])
def test_ntt_plain_matches_staged_reference(n):
    """Forward and inverse, negacyclic, with a leading batch dim: every
    residue equal."""
    qs, x = _case(n, 3, (2,), seed=n)
    jt = jntt.Pow2NTT(qs, n, negacyclic=True).tree()
    tt = tntt.Pow2NTT(qs, n, negacyclic=True).tree("cpu")
    ref = np.asarray(jax.jit(jntt.ntt_pow2_fwd)(jnp.asarray(x), jt))
    got = ntt_plain(to_device(x, "cpu"), tt, inverse=False)
    np.testing.assert_array_equal(to_host(got), ref)
    back = np.asarray(jax.jit(jntt.ntt_pow2_inv)(jnp.asarray(ref), jt))
    np.testing.assert_array_equal(
        to_host(ntt_plain(got, tt, inverse=True)), back)
    np.testing.assert_array_equal(back, x)


def test_ntt_plain_matches_staged_reference_at_n65536():
    """m = 131072 (n = 65536, the JAX package's MAX_PALLAS_N, which the
    port's K2 runs on 4-CTA clusters): two primes under a lead dim, both
    directions."""
    n = 1 << 16
    qs, x = _case(n, 2, (2,), seed=5)
    jt = jntt.Pow2NTT(qs, n, negacyclic=True).tree()
    tt = tntt.Pow2NTT(qs, n, negacyclic=True).tree("cpu")
    ref = np.asarray(jax.jit(jntt.ntt_pow2_fwd)(jnp.asarray(x), jt))
    got = ntt_plain(to_device(x, "cpu"), tt, inverse=False)
    np.testing.assert_array_equal(to_host(got), ref)
    back = np.asarray(jax.jit(jntt.ntt_pow2_inv)(jnp.asarray(ref), jt))
    np.testing.assert_array_equal(
        to_host(ntt_plain(got, tt, inverse=True)), back)
    np.testing.assert_array_equal(back, x)


def test_ntt_plain_matches_pallas_ntt_interpret():
    n = 2048
    qs, x = _case(n, 5, (), seed=17)
    jt = jntt.Pow2NTT(qs, n, negacyclic=True).tree()
    tt = tntt.Pow2NTT(qs, n, negacyclic=True).tree("cpu")
    ref = np.asarray(apply_ntt(jnp.asarray(x), jt, jt["q"], inverse=False,
                               interpret=True))
    got = ntt(to_device(x, "cpu"), tt, inverse=False)
    np.testing.assert_array_equal(to_host(got), ref)
    ref_inv = np.asarray(apply_ntt(jnp.asarray(ref), jt, jt["q"],
                                   inverse=True, interpret=True))
    np.testing.assert_array_equal(
        to_host(ntt(got, tt, inverse=True)), ref_inv)


def test_context_transforms_on_row_subsets_match_reference():
    """Context.fwd_ntt / inv_ntt on the row sets the ring ops use (a
    prefix, the specials, a digit's extension rows) under batch dims."""
    params = dict(m=256, p=-1, r=30, bits=240, c=3, scheme="ckks")
    jc, tc = JContext(**params), TContext(**params, device="cpu")
    rng = np.random.default_rng(3)
    for rows in (tc.rows_of(4, False), tuple(range(tc.L, tc.L + tc.S)),
                 tc.rows_of(tc.L, True)[3:]):
        qs = tc.all_q[np.array(rows)].astype(np.int64)
        x = rng.integers(0, qs[:, None], (2, 1, len(rows), tc.n_eval)
                         ).astype(np.uint32)
        got = tc.fwd_ntt(to_device(x, "cpu"), rows)
        ref = np.asarray(jc.fwd_ntt(jnp.asarray(x), rows))
        np.testing.assert_array_equal(to_host(got), ref)
        np.testing.assert_array_equal(to_host(tc.inv_ntt(got, rows)), x)
        t = tc.ntt_tree(rows)["fwd"]
        assert tuple(t["flat"]["tw_all"].shape) == (len(rows), tc.n_eval)


def test_ntt_kernel_wrapper_refuses_cpu_tensors_and_large_n():
    qs, x = _case(64, 2, (1,), seed=1)
    tab = tntt.Pow2NTT(qs, 64, negacyclic=True)
    flat = {k: to_device(v, "cpu") for k, v in tab.flat().items()}
    q = to_device(qs[:, None], "cpu")
    before = launch_counts.copy()
    with pytest.raises(ValueError, match="CUDA tensor"):
        ntt_cuda(to_device(x, "cpu"), flat, q, inverse=False)
    # n = 131072 (m = 262144) is above the kernel's 4-CTA clusters (and
    # above helib_tpu's MAX_PALLAS_N): refused, no fallback
    big = torch.zeros((1, 2, 1 << 17), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        ntt_cuda(big, flat, q, inverse=True)
    with pytest.raises(ValueError, match="power of two"):
        ntt_cuda(torch.zeros((1, 2, 48), dtype=torch.int32), flat, q, False)
    assert launch_counts == before
