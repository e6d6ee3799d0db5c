"""Port vs helib_tpu: the compiled dispatch (helib_tpu_torch.jitutil, the
twin of helib_tpu.jitutil) on the host.  A run on CPU tensors is the
function itself, so the lifted_jit-wrapped pipeline is held to helib_tpu's
lifted_jit-wrapped one bit for bit; disable_jit and the launch-count
bookkeeping a replay relies on are checked as pure Python.  The graphs
themselves run on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helib_tpu.context import Context as JContext
from helib_tpu.keys import SecKey as JSecKey
from helib_tpu import pipeline as jpipe
from helib_tpu.jitutil import lifted_jit as jlifted_jit

from helib_tpu_torch import jitutil
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.keys import SecKey as TSecKey
from helib_tpu_torch import pipeline as tpipe
from helib_tpu_torch.ops.modops import to_device, to_host

torch.set_num_threads(1)

PARAMS = dict(m=31, p=2, r=1, bits=300, c=3)


@pytest.fixture(scope="module")
def port():
    ctx = TContext(**PARAMS, device="cpu")
    sk = TSecKey(ctx, seed=7)
    fn, args = tpipe.make_mult_relin(ctx, sk)
    return ctx, fn, args


def _parts(qs, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, qs[:, None].astype(np.int64), (len(qs), n)
                         ).astype(np.uint32) for _ in range(4)]


def test_two_lifted_jit_wrappers_give_identical_outputs(port):
    # the twin of tests/test_pipeline_retrace.py: a second, distinct wrapper
    # of the same pipeline sees the same cached constants
    ctx, fn, args = port
    j1 = jitutil.lifted_jit(fn, *args)
    j2 = jitutil.lifted_jit(lambda *a: fn(*a), *args)
    o1, o2 = j1(*args), j2(*args)
    assert len(o1) == len(o2) == 2
    for a, b in zip(o1, o2):
        assert a.shape == (ctx.L, ctx.n_eval)
        assert torch.equal(a, b)


def test_run_on_host_tensors_is_the_function(port):
    _, fn, args = port
    assert jitutil.lifted_jit(fn, *args) is fn
    # a site on the host runs its body and caches no run
    cache = {}
    got = jitutil.jit_call(cache, "k", lambda: lambda v: v + 1, args[0])
    assert torch.equal(got, args[0] + 1) and cache == {}


def test_lifted_pipeline_bit_equal_to_helib_tpu():
    jc = JContext(**PARAMS)
    tc = TContext(**PARAMS, device="cpu")
    jfn, jex = jpipe.make_mult_relin(jc, JSecKey(jc, seed=5))
    tfn, tex = tpipe.make_mult_relin(tc, TSecKey(tc, seed=5))
    jrun = jlifted_jit(jfn, *jex)
    trun = jitutil.lifted_jit(tfn, *tex)
    x = _parts(tc.primes_of(tc.L, False), tc.n_eval, seed=11)
    want = jrun(*map(jnp.asarray, x))
    got = trun(*[to_device(a, "cpu") for a in x])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_host(g), np.asarray(w))


def test_disable_jit_nests_and_restores():
    assert jitutil.jit_enabled()
    with jitutil.disable_jit():
        assert not jitutil.jit_enabled()
        with jitutil.disable_jit():
            assert not jitutil.jit_enabled()
        assert not jitutil.jit_enabled()
    assert jitutil.jit_enabled()
    with pytest.raises(KeyError):
        with jitutil.disable_jit():
            raise KeyError("inside")
    assert jitutil.jit_enabled()


class _Kernel:
    launches = 0


def test_counter_replay_adds_the_capture_deltas():
    a, b, c = _Kernel(), _Kernel(), _Kernel()
    counters = [(a, "launches"), (b, "launches"), (c, "launches")]
    jitutil.set_counts(counters, (5, 0, 2))     # the warm-up's real launches
    before = jitutil.read_counts(counters)
    a.launches += 8                              # what the capture recorded
    c.launches += 1
    delta = jitutil.count_delta(before, jitutil.read_counts(counters))
    jitutil.set_counts(counters, before)         # the capture ran nothing
    assert delta == (8, 0, 1)
    assert jitutil.read_counts(counters) == (5, 0, 2)
    for _ in range(3):                           # three replays
        jitutil.add_counts(counters, delta)
    assert jitutil.read_counts(counters) == (5 + 24, 0, 2 + 3)


def test_launch_counters_are_the_ports_counts():
    from helib_tpu_torch.ops import conv, ntt, ntt2, ntt_fused, probes
    from helib_tpu_torch.parallel import sharded_ntt
    held = {(id(h), a) for h, a in jitutil.launch_counters()}
    for h, a in [(conv.conv_cuda, "launches"), (conv.conv_aux_cuda,
                 "launches"), (ntt_fused.ntt_cuda, "launches"),
                 (ntt2.ntt2_cuda, "launches"), (ntt2.conv2_cuda, "launches"),
                 (probes.p1_cuda, "launches"), (probes.p2_cuda, "launches"),
                 (ntt, "staged_transforms"),
                 (sharded_ntt, "sharded_transforms")]:
        assert (id(h), a) in held
    assert len(held) == 9


def test_dispatch_key_follows_a_swapped_kernel_and_v2(monkeypatch):
    from helib_tpu_torch.ops import conv
    k0 = jitutil.dispatch_key()
    monkeypatch.setattr(conv, "conv_aux", conv.conv_aux_plain)
    k1 = jitutil.dispatch_key()
    monkeypatch.setenv("HELIB_NTT_V2", "1")
    k2 = jitutil.dispatch_key()
    assert len({k0, k1, k2}) == 3


def test_outputs_flatten_and_rebuild():
    t = [torch.arange(3), torch.ones(2)]
    out = (t[0], [t[1], None], 2.5)
    leaves = []
    skel = jitutil._flatten(out, leaves)
    assert leaves == t
    back = jitutil._rebuild(skel, iter(leaves))
    assert back[0] is t[0] and back[1][0] is t[1]
    assert back[1][1] is None and back[2] == 2.5
    assert isinstance(back, tuple) and isinstance(back[1], list)


def test_arguments_must_be_tensors_on_one_device(port):
    _, fn, args = port
    with pytest.raises(TypeError):
        jitutil.lifted_jit(fn, args)            # the tuple, not its items
    with pytest.raises(TypeError):
        jitutil.lifted_jit(fn)
    with pytest.raises(TypeError):
        jitutil.jit_call({}, "k", lambda: fn, *args[:3], 1)
