"""Port vs helib_tpu: the transforms above the kernels' 2^16, which run the
staged torch transforms on the tensor's own device, as helib_tpu runs its
staged ones above MAX_PALLAS_N -- the Bluestein DFT at m=35113 (B = 131072,
HElib's big bootstrapping size) and the power-of-2 transform of
Context(m=262144) (n = 131072) -- with the staged count moving and no
kernel dispatcher reached."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helib_tpu.nt.primegen import gen_primes
from helib_tpu.ops import ntt as jntt

from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ops import conv as convmod
from helib_tpu_torch.ops import ntt as tntt
from helib_tpu_torch.ops import ntt_fused
from helib_tpu_torch.ops.modops import to_device, to_host

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_kernel_dispatch(monkeypatch):
    """helib_tpu's staged reference; the port's kernel dispatchers fail if
    reached."""
    monkeypatch.setattr(jntt, "USE_PALLAS", False)

    def refuse(*a, **k):
        raise AssertionError("a kernel dispatcher was reached above 2^16")
    for mod, name in ((convmod, "conv"), (convmod, "conv_aux"),
                      (ntt_fused, "ntt")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("inverse", [False, True])
def test_bluestein_m35113_matches_staged_reference(inverse):
    """B = 131072: two primes under a lead dim of 2, every host table equal,
    the transform equal to helib_tpu's jitted staged bluestein_apply; one
    staged convolution a call."""
    m, P = 35113, 2
    qs = np.array(gen_primes(m, P), dtype=np.uint32)
    jt = jntt.BluesteinTables(qs, m, inverse)
    tt = tntt.BluesteinTables(qs, m, inverse)
    assert tt.B == jt.B == 1 << 17
    for k, v in tt.host.items():
        np.testing.assert_array_equal(v, jt.dev[k], err_msg=k)
    tree = tt.tree("cpu", tuple(range(P)), tntt.aux_tree(tt.B, "cpu"))
    rng = np.random.default_rng(35113 + inverse)
    x = rng.integers(0, qs[:, None].astype(np.int64), (2, P, m)
                     ).astype(np.uint32)
    before = tntt.staged_transforms
    got = tntt.bluestein_apply(to_device(x, "cpu"), tree, m, tt.B)
    assert tntt.staged_transforms == before + 1
    ref = jax.jit(lambda a, t: jntt.bluestein_apply(a, t, m, jt.B))(
        jnp.asarray(x), jt.dev)
    np.testing.assert_array_equal(to_host(got), np.asarray(ref))


def test_context_pow2_m262144_matches_staged_reference():
    """Context(m=262144).fwd_ntt / inv_ntt on one and two prime rows equal
    helib_tpu's staged ntt_pow2_fwd / ntt_pow2_inv, and invert."""
    tc = TContext(m=262144, p=-1, r=20, bits=60, c=2, scheme="ckks",
                  device="cpu")
    n = tc.n_eval
    assert n == 1 << 17
    rng = np.random.default_rng(262144)
    fwd, inv = jax.jit(jntt.ntt_pow2_fwd), jax.jit(jntt.ntt_pow2_inv)
    for rows in ((0,), (0, tc.L)):
        qs = tc.all_q[np.array(rows)]
        x = rng.integers(0, qs[:, None].astype(np.int64), (len(rows), n)
                         ).astype(np.uint32)
        jt = jntt.Pow2NTT(qs, n, negacyclic=True).tree()
        before = tntt.staged_transforms
        got = tc.fwd_ntt(to_device(x, "cpu"), rows)
        ref = fwd(jnp.asarray(x), jt)
        np.testing.assert_array_equal(to_host(got), np.asarray(ref))
        back = tc.inv_ntt(got, rows)
        np.testing.assert_array_equal(to_host(back),
                                      np.asarray(inv(ref, jt)))
        np.testing.assert_array_equal(to_host(back), x)
        assert tntt.staged_transforms == before + 2
