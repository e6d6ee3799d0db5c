"""The port's cost probes (ops/probes.py, P1 and P2) against the TPU probes
they replace, run eagerly on the CPU: P1's plain variants against
benchmarks/kernel_parts.py::kern_mul bit for bit, P2's plain phases against
the JAX phase functions of helib_tpu/ops/pallas_ntt.py composed as
benchmarks/kernel_phases.py composes them, mod q."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helib_tpu.nt.primegen import gen_primes
from helib_tpu.ops import pallas_ntt as PN
from helib_tpu.ops.ntt import Pow2NTT as JPow2NTT

from helib_tpu_torch.ops import probes
from helib_tpu_torch.ops.ntt import Pow2NTT, aux_primes
from helib_tpu_torch.ops.modops import to_device, to_host, shoup

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kernel_parts():
    spec = importlib.util.spec_from_file_location(
        "kernel_parts", os.path.join(REPO, "benchmarks", "kernel_parts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def p1_inputs():
    """Six rows of 512 words on the aux primes (the TPU probe cycles the
    three), random twiddles with their Shoup companions."""
    R, n = 6, 512
    qrow = aux_primes()[np.arange(R) % 3].astype(np.uint32)
    rng = np.random.default_rng(0)
    x = rng.integers(0, qrow[:, None].astype(np.int64), (R, n))
    w = rng.integers(1, qrow[:, None].astype(np.int64), (R, n))
    wsh = shoup(w.astype(np.uint32), qrow[:, None].astype(np.uint64))
    return [a.astype(np.uint32) for a in (x, w, wsh, qrow[:, None])]


@pytest.mark.parametrize("variant", probes.P1_VARIANTS)
def test_p1_plain_equals_kern_mul(p1_inputs, variant):
    kern_mul = _kernel_parts().kern_mul
    x, w, wsh, q = p1_inputs
    ref = np.empty_like(x)
    kern_mul(*map(jnp.asarray, (x, w, wsh, q)), ref, variant=variant)
    got = probes.p1_plain(variant, *[to_device(a, "cpu")
                                     for a in (x, w, wsh, q)])
    assert bool((ref < q).all())
    np.testing.assert_array_equal(to_host(got), ref)


def _jax_phase(phase, x, q, tree, n):
    """The body of kernel_phases.py's kern (lines 35-49) at G = 1, with the
    fine functions' current signature (qg4, R2, n, W, G, ...) and the
    forward output reduced before the inverse butterflies (`red`)."""
    R = x.shape[0]
    stages = n.bit_length() - 1
    A, LANE = n // PN.LANE, PN.LANE
    coarse = stages - 7

    def red(v, qq):
        return PN._csub(PN._csub(v, 2 * qq), qq)
    if phase == "coarse":
        x3 = PN._fwd_coarse3(x.reshape(R, A, LANE), q, R, A, tree["tw_cat3"],
                             tree["tw_cat3_sh"], coarse)
        x3 = PN._inv_coarse3(red(x3, q[:, :, None]), q, R, A,
                             tree["tw_cat3"],
                             tree["tw_cat3_sh"], coarse)
        x = x3.reshape(R, n)
    elif phase == "memory":
        xt = jnp.swapaxes(x.reshape(R, A, LANE), 1, 2) + q[:, :, None]
        x = jnp.swapaxes(xt, 1, 2).reshape(R, n)
    else:
        qg4 = PN.group_q(q, 1, A)
        xt = jnp.swapaxes(x.reshape(R, A, LANE), 1, 2)
        xt = PN._fwd_fine(xt, qg4, R, n, A, 1, tree["tw_fine"],
                          tree["tw_fine_sh"], coarse, stages)
        xt = PN._inv_fine(red(xt, qg4[:, 0]), qg4, R, n, A, 1,
                          tree["tw_fine"],
                          tree["tw_fine_sh"], coarse, stages)
        x = jnp.swapaxes(xt, 1, 2).reshape(R, n)
    return np.asarray(PN._csub(x, q))


@pytest.mark.parametrize("phase", probes.P2_PHASES)
def test_p2_plain_congruent_to_jax_phases(phase):
    """At n = 16384 (G = 1, as kernel_phases.py runs it).  The TPU body
    feeds its forward output (< 4q) into the inverse butterflies, which take
    inputs below 2q: their a + 2q - b wraps below zero for b >= 2q, so the
    probe's output is not congruent to anything (it is a timing probe).
    The test reduces between the two; the lazy output is then congruent to
    the port's mod q."""
    n, R = 16384, 3
    qs = np.array(gen_primes(n, 3), dtype=np.uint32)
    tree = JPow2NTT(qs, n, negacyclic=False).tree()
    rng = np.random.default_rng(1)
    x = rng.integers(0, qs[:, None].astype(np.int64), (R, n)).astype(
        np.uint32)
    ref = _jax_phase(phase, jnp.asarray(x), jnp.asarray(qs[:, None]), tree,
                     n)
    flat = {k: to_device(v, "cpu")
            for k, v in Pow2NTT(qs, n, negacyclic=False).flat().items()}
    got = to_host(probes.p2_plain(phase, to_device(x, "cpu"),
                                  flat["tw_all"], flat["tw_all_sh"],
                                  to_device(qs[:, None], "cpu")))
    assert bool((got < qs[:, None]).all())
    np.testing.assert_array_equal(got, ref % qs[:, None])
    if phase == "memory":
        np.testing.assert_array_equal(got, x)
    else:
        assert not np.array_equal(got, x)
