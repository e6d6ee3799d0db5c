"""Port vs helib_tpu: staged NTTs, Bluestein tables and transforms, and the
K1 convolution's plain version (the CUDA kernel: test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helib_tpu.nt.primegen import gen_primes
from helib_tpu.ops import ntt as jntt
from helib_tpu.ops.pallas_ntt import apply_conv
from helib_tpu.ops.modops import shoup

from helib_tpu_torch.ops import ntt as tntt
from helib_tpu_torch.ops.conv import conv, conv_cuda, conv_plain
from helib_tpu_torch.ops.modops import to_device, to_host

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _staged_reference(monkeypatch):
    monkeypatch.setattr(jntt, "USE_PALLAS", False)


@pytest.mark.parametrize("n,negacyclic", [(256, True), (1024, True),
                                          (1024, False)])
def test_staged_pow2_fwd_inv(n, negacyclic):
    qs = np.array(gen_primes(2 * n, 5), dtype=np.uint32)
    jt = jntt.Pow2NTT(qs, n, negacyclic).tree()
    tt = tntt.Pow2NTT(qs, n, negacyclic).tree("cpu")
    rng = np.random.default_rng(n)
    x = rng.integers(0, qs[:, None].astype(np.int64),
                     (2, len(qs), n)).astype(np.uint32)
    ref = np.asarray(jntt.ntt_pow2_fwd(jnp.asarray(x), jt))
    got = tntt.ntt_pow2_fwd(to_device(x, "cpu"), tt)
    np.testing.assert_array_equal(to_host(got), ref)
    back = np.asarray(jntt.ntt_pow2_inv(jnp.asarray(ref), jt))
    np.testing.assert_array_equal(to_host(tntt.ntt_pow2_inv(got, tt)), back)
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("m", [31, 127])
def test_bluestein_tables_and_apply(m):
    qs = np.array(gen_primes(m, 4), dtype=np.uint32)
    rng = np.random.default_rng(m)
    x = rng.integers(0, qs[:, None].astype(np.int64),
                     (2, len(qs), m)).astype(np.uint32)
    rows = (0, 2, 3)
    for inverse in (False, True):
        jt = jntt.BluesteinTables(qs, m, inverse)
        tt = tntt.BluesteinTables(qs, m, inverse)
        assert tt.B == jt.B
        for k, v in tt.host.items():
            np.testing.assert_array_equal(v, jt.dev[k], err_msg=k)
        aux = tntt.aux_tree(tt.B, "cpu")
        tree = tt.tree("cpu", rows, aux)
        jdev = {k: (v[np.array(rows)] if k in tntt.BluesteinTables._ROW_KEYS
                    else v[:, np.array(rows)]
                    if k in tntt.BluesteinTables._AUX_ROW_KEYS else v)
                for k, v in jt.dev.items()}
        xs = x[:, list(rows)]
        ref = np.asarray(jntt.bluestein_apply(jnp.asarray(xs), jdev, m,
                                              jt.B))
        got = tntt.bluestein_apply(to_device(xs, "cpu"), tree, m, tt.B)
        np.testing.assert_array_equal(to_host(got), ref)


def _conv_case(n, P, seed):
    raux = tntt.aux_primes().astype(np.int64)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, raux[:, None, None], (2, 3, P, n)).astype(np.uint32)
    kh = rng.integers(0, raux[:, None, None], (3, P, n)).astype(np.uint32)
    khsh = shoup(kh, raux[:, None, None].astype(np.uint64))
    return x, kh, khsh


def test_conv_plain_matches_pallas_conv_interpret():
    n, P = 512, 2
    x, kh, khsh = _conv_case(n, P, seed=23)
    jaux = jntt._broadcast_tree(jntt.aux_ntt(n).tree(), 1)
    jq = jnp.asarray(jntt.aux_primes()[:, None, None])
    ref = np.asarray(apply_conv(jnp.asarray(x), jaux, jnp.asarray(kh),
                                jnp.asarray(khsh), jq, interpret=True))
    aux = tntt.aux_tree(n, "cpu")["aux"]
    args = (to_device(x, "cpu"), aux, to_device(kh, "cpu"),
            to_device(khsh, "cpu"))
    np.testing.assert_array_equal(to_host(conv_plain(*args)), ref)
    np.testing.assert_array_equal(to_host(conv(*args)), ref)


def test_conv_kernel_wrapper_refuses_cpu_tensors():
    x, kh, khsh = _conv_case(64, 2, seed=1)
    aux = tntt.aux_tree(64, "cpu")["aux"]
    before = conv_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv_cuda(to_device(x, "cpu"), aux, to_device(kh, "cpu"),
                  to_device(khsh, "cpu"))
    assert conv_cuda.launches == before
