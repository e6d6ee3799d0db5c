"""Port vs helib_tpu: number theory, PAlgebra and the modular ops, exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helib_tpu.nt import primegen as j_primegen
from helib_tpu.ops import modops as j_modops
from helib_tpu.ops.ntt import Pow2NTT as JPow2NTT
from helib_tpu.palgebra import PAlgebra as JPAlgebra

from helib_tpu_torch.nt import primegen as t_primegen
from helib_tpu_torch.ops import modops as t_modops
from helib_tpu_torch.ops.modops import to_device, to_host
from helib_tpu_torch.ops.ntt import Pow2NTT as TPow2NTT
from helib_tpu_torch.palgebra import PAlgebra as TPAlgebra

torch.set_num_threads(1)


@pytest.mark.parametrize("m", [31, 257, 1271, 8009])
def test_primes_and_palgebra(m):
    assert (t_primegen.gen_primes(m, 18, exclude=frozenset((2,)))
            == j_primegen.gen_primes(m, 18, exclude=frozenset((2,))))
    assert t_primegen.gen_aux_primes(3) == j_primegen.gen_aux_primes(3)
    jp, tp = JPAlgebra(m, 2), TPAlgebra(m, 2)
    for name in ("gens", "orders", "native", "phi_m", "d", "nslots",
                 "n_eval"):
        assert getattr(tp, name) == getattr(jp, name), name
    np.testing.assert_array_equal(tp.exponents(), jp.exponents())
    for k in jp.gens + [2, m - 1]:
        np.testing.assert_array_equal(tp.automorph_perm(k),
                                      jp.automorph_perm(k))


@pytest.mark.parametrize("n,negacyclic", [(256, True), (1024, False)])
def test_pow2_tables(n, negacyclic):
    qs = np.array(j_primegen.gen_primes(2 * n, 3), dtype=np.uint32)
    jt, tt = JPow2NTT(qs, n, negacyclic), TPow2NTT(qs, n, negacyclic)
    np.testing.assert_array_equal(tt.eval_exponents, jt.eval_exponents)
    for name in ("tw", "tw_sh", "itw", "itw_sh"):
        for a, b in zip(getattr(tt, name), getattr(jt, name)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tt.ninv, jt.ninv)
    np.testing.assert_array_equal(tt.ninv_sh, jt.ninv_sh)


def _operands(seed=3):
    qs = np.array(j_primegen.gen_primes(8009, 4), dtype=np.uint32)[:, None]
    rng = np.random.default_rng(seed)
    a = rng.integers(0, qs.astype(np.int64), (4, 257)).astype(np.uint32)
    b = rng.integers(0, qs.astype(np.int64), (4, 257)).astype(np.uint32)
    # edge values 0 and q - 1 in every combination
    edge = np.concatenate([np.zeros_like(qs), qs - 1], axis=1)
    a[:, :4] = np.tile(edge, 2)
    b[:, :4] = np.repeat(edge, 2, axis=1)
    return qs, a, b


def test_modops_match_reference():
    qs, a, b = _operands()
    mu = j_modops.barrett_mu(qs)
    np.testing.assert_array_equal(t_modops.barrett_mu(qs), mu)
    w_sh = j_modops.shoup(b, qs.astype(np.uint64))
    np.testing.assert_array_equal(t_modops.shoup(b, qs.astype(np.uint64)),
                                  w_sh)
    J = lambda x: jnp.asarray(x)
    T = lambda x: to_device(x, "cpu")
    cases = [
        ("add_mod", (a, b, qs)), ("sub_mod", (a, b, qs)),
        ("neg_mod", (a, qs)), ("mul_mod", (a, b, qs, mu)),
        ("mul_mod_shoup", (a, b, w_sh, qs)),
        ("reduce_u32", (a + (qs - 1) * (a & 1).astype(np.uint32), qs)),
    ]
    for name, args in cases:
        ref = np.asarray(getattr(j_modops, name)(*map(J, args)))
        got = to_host(getattr(t_modops, name)(*map(T, args)))
        np.testing.assert_array_equal(got, ref, err_msg=name)
        assert got.dtype == np.uint32


def test_device_roundtrip_keeps_uint32_bits():
    x = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)
    t = to_device(x, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(to_host(t), x)
