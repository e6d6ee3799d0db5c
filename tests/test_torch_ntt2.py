"""The v2 (block-list) schedule of the port (ops/ntt2.py, K4 and K5)
against helib_tpu's: the schedule, the plain versions against the staged
transforms and against apply_ntt2 / apply_conv2 in interpret mode, and the
HELIB_NTT_V2 dispatch on CPU contexts.  All comparisons are bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helib_tpu.nt.primegen import gen_primes
from helib_tpu.ops.ntt import Pow2NTT as JPow2NTT
from helib_tpu.ops import modops as jmodops
from helib_tpu.ops.pallas_ntt2 import (apply_ntt2, apply_conv2,
                                       phase_schedule as j_phase_schedule)

from helib_tpu_torch.context import Context
from helib_tpu_torch.ops import conv as convmod, ntt2, ntt_fused
from helib_tpu_torch.ops.ntt import Pow2NTT, aux_tree, aux_primes
from helib_tpu_torch.ops.modops import to_device, to_host, shoup

torch.set_num_threads(1)


def _pow2(n, P, negacyclic, seed):
    """Port tables (stage tree and flat form) and random reduced rows."""
    qs = np.array(gen_primes(2 * n, P), dtype=np.uint32)
    tab = Pow2NTT(qs, n, negacyclic=negacyclic)
    flat = {k: to_device(v, "cpu") for k, v in tab.flat().items()}
    rng = np.random.default_rng(seed)
    x = rng.integers(0, qs[:, None].astype(np.int64), (2, P, n))
    return qs, tab.tree("cpu"), flat, x.astype(np.uint32)


def test_phase_schedule_matches_reference():
    for start in range(0, 4):
        for stop in range(start, 17):
            for max_k in (None, 1, 2, 3, 4, 5, 6, 7):
                assert ntt2.phase_schedule(start, stop, max_k) == \
                    j_phase_schedule(start, stop, max_k)
    # one phase of log2 n stages, composites of at most k, in order
    for log_n in range(3, 16):
        for k in range(1, ntt2.K_MAX + 1):
            sched = ntt2.schedule(log_n, k)
            assert [s0 for s0, _ in sched] == list(
                np.cumsum([0] + [kk for _, kk in sched[:-1]]))
            assert sum(kk for _, kk in sched) == log_n
            assert max(kk for _, kk in sched) == min(k, log_n)


@pytest.mark.parametrize("log_n", range(3, 13))
def test_plain_schedule_equals_staged_at_every_k(log_n):
    """ntt2_plain == ntt_plain and conv2_plain == conv_plain, both
    directions, every composite size."""
    n = 1 << log_n
    _, tree, flat, x = _pow2(n, 3, True, seed=n)
    x = to_device(x, "cpu")
    fwd = ntt_fused.ntt_plain(x, tree, False)
    inv = ntt_fused.ntt_plain(x, tree, True)
    aux = aux_tree(n, "cpu")["aux"]
    raux = aux_primes().astype(np.int64)
    rng = np.random.default_rng(n + 1)
    xa = to_device(rng.integers(0, raux[:, None, None], (2, 3, 2, n))
                   .astype(np.uint32), "cpu")
    kh = rng.integers(0, raux[:, None, None], (3, 2, n)).astype(np.uint32)
    khsh = to_device(shoup(kh, raux[:, None, None].astype(np.uint64)), "cpu")
    kh = to_device(kh, "cpu")
    conv = convmod.conv_plain(xa, aux, kh, khsh)
    for k in range(1, ntt2.K_MAX + 1):
        assert torch.equal(ntt2.ntt2_plain(x, flat, tree["q"], False, k), fwd)
        assert torch.equal(ntt2.ntt2_plain(x, flat, tree["q"], True, k), inv)
        assert torch.equal(ntt2.conv2_plain(xa, aux, kh, khsh, k), conv)


# the sizes of tests/test_pallas_ntt2.py: interpret mode unrolls the
# composites into XLA:CPU graphs, and larger k costs minutes of compile
@pytest.mark.parametrize("n,negacyclic,max_k",
                         [(256, True, 3), (1024, False, 2)])
def test_ntt2_plain_equals_apply_ntt2_interpret(n, negacyclic, max_k):
    qs, _, flat, x = _pow2(n, 3, negacyclic, seed=17)
    x = x[0]
    jtree = JPow2NTT(qs, n, negacyclic=negacyclic).tree()
    q = to_device(qs[:, None], "cpu")
    got_f = ntt2.ntt2_plain(to_device(x, "cpu"), flat, q, False, max_k)
    ref_f = np.asarray(apply_ntt2(jnp.asarray(x), jtree, jtree["q"],
                                  inverse=False, interpret=True,
                                  max_k=max_k))
    np.testing.assert_array_equal(to_host(got_f), ref_f)
    got_i = ntt2.ntt2_plain(got_f, flat, q, True, max_k)
    ref_i = np.asarray(apply_ntt2(jnp.asarray(ref_f), jtree, jtree["q"],
                                  inverse=True, interpret=True,
                                  max_k=max_k))
    np.testing.assert_array_equal(to_host(got_i), ref_i)
    np.testing.assert_array_equal(ref_i, x)


def test_conv2_plain_equals_apply_conv2_interpret():
    """apply_conv2 convolves each row mod its own prime; conv2_plain takes
    those three primes as the aux axis of [3, P=1, n]."""
    n, max_k = 512, 2
    qs, _, flat, x = _pow2(n, 3, False, seed=23)
    x = x[0]
    rng = np.random.default_rng(24)
    kh = rng.integers(0, qs[:, None].astype(np.int64),
                      (3, n)).astype(np.uint32)
    khsh = jmodops.shoup(kh, qs[:, None].astype(np.uint64))
    jtree = JPow2NTT(qs, n, negacyclic=False).tree()
    ref = np.asarray(apply_conv2(jnp.asarray(x), jtree, jnp.asarray(kh),
                                 jnp.asarray(khsh), jtree["q"],
                                 interpret=True, max_k=max_k))
    aux = {**flat, "q": to_device(qs[:, None, None], "cpu")}
    got = ntt2.conv2_plain(to_device(x[:, None], "cpu"), aux,
                           to_device(kh[:, None], "cpu"),
                           to_device(khsh[:, None], "cpu"), max_k)
    np.testing.assert_array_equal(to_host(got)[:, 0], ref)


def _residues(ctx, seed):
    """Forward then inverse transforms of random residues on every row."""
    rows = ctx.rows_of(ctx.L, True)
    qs = ctx.all_q[np.array(rows)].astype(np.int64)[:, None]
    rng = np.random.default_rng(seed)
    x = to_device(rng.integers(0, qs, (2, len(rows), ctx.n_eval))
                  .astype(np.uint32), "cpu")
    fwd = ctx.fwd_ntt(x, rows)
    return fwd, ctx.inv_ntt(fwd, rows)


@pytest.mark.parametrize("params", [
    dict(m=31, p=2, r=1, bits=120, c=3),
    dict(m=256, p=-1, r=30, bits=240, c=3, scheme="ckks")],
    ids=["bgv-m31", "ckks-m256"])
def test_v2_env_leaves_context_residues_unchanged(params, monkeypatch):
    """HELIB_NTT_V2=1 (and a cap of 2) gives the same residues; at m=256
    the transforms go through ntt2_plain, at m=31 (B = 64, aux-major) the
    schedule is not consulted."""
    ctx = Context(**params, device="cpu")
    base = _residues(ctx, seed=3)
    calls = []

    def counted(*a):
        calls.append(a[-1])
        return ntt2.ntt2_plain(*a)
    monkeypatch.setattr(ntt_fused, "ntt2_plain", counted)
    monkeypatch.setenv("HELIB_NTT_V2", "1")
    for k in ("", "2"):
        monkeypatch.setenv("HELIB_NTT_V2_K", k)
        for a, b in zip(_residues(ctx, seed=3), base):
            assert torch.equal(a, b)
    assert calls == ([ntt2.K_MAX, ntt2.K_MAX, 2, 2] if ctx.pal.pow2 else [])


def test_v2_conv_dispatch_and_k_above_max_raises(monkeypatch):
    n = 64
    aux = aux_tree(n, "cpu")["aux"]
    raux = aux_primes().astype(np.int64)
    rng = np.random.default_rng(5)
    xa = to_device(rng.integers(0, raux[:, None, None], (3, 2, n))
                   .astype(np.uint32), "cpu")
    kh = rng.integers(0, raux[:, None, None], (3, 2, n)).astype(np.uint32)
    khsh = to_device(shoup(kh, raux[:, None, None].astype(np.uint64)), "cpu")
    kh = to_device(kh, "cpu")
    ref = convmod.conv(xa, aux, kh, khsh)
    monkeypatch.setenv("HELIB_NTT_V2", "1")
    assert ntt2.ntt_v2() == (True, ntt2.K_MAX)
    monkeypatch.setenv("HELIB_NTT_V2_K", "1")
    assert ntt2.ntt_v2() == (True, 1)
    assert torch.equal(convmod.conv(xa, aux, kh, khsh), ref)
    monkeypatch.setenv("HELIB_NTT_V2_K", str(ntt2.K_MAX + 1))
    with pytest.raises(ValueError, match="HELIB_NTT_V2_K"):
        ntt2.ntt_v2()
    with pytest.raises(ValueError, match="HELIB_NTT_V2_K"):
        convmod.conv(xa, aux, kh, khsh)
    monkeypatch.setenv("HELIB_NTT_V2", "0")
    assert ntt2.ntt_v2() == (False, ntt2.K_MAX)
