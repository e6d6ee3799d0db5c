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


def test_counter_replay_adds_the_capture_deltas(monkeypatch):
    from collections import Counter
    from helib_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "launch_counts", Counter())
    counts = _build.launch_counts
    counts.update(conv=5, embed_max=2)           # the warm-up's real launches
    with _build.counted_apart() as delta:        # what the capture recorded
        for _ in range(8):
            _build.count("conv")
        _build.count("basis_ext")
    assert delta == Counter(conv=8, basis_ext=1)
    assert counts == Counter(conv=5, embed_max=2)   # the capture ran nothing
    for _ in range(3):                           # three replays
        counts.update(delta)
    assert counts == Counter(conv=5 + 24, embed_max=2, basis_ext=3)
    with pytest.raises(KeyError):                # a failed capture counts
        with _build.counted_apart() as delta:    # nothing either
            _build.count("conv")
            raise KeyError("capture")
    assert counts["conv"] == 29 and delta == Counter(conv=1)


def test_launch_counters_are_the_ports_counts(monkeypatch):
    """One count for the whole port: the staged and the sharded transforms
    add to ops._build.launch_counts, no kernel wrapper keeps a count of its
    own, and jitutil reaches neither the parallel layer nor a kernel module
    to count."""
    import ast
    from collections import Counter
    from helib_tpu_torch.ops import (_build, basis_ext, conv, embed_max,
                                     ntt, ntt2, ntt_fused, probes)
    from helib_tpu_torch.nt.primegen import gen_primes
    from helib_tpu_torch.parallel import sharded_ntt
    monkeypatch.setattr(_build, "launch_counts", Counter())
    x = torch.zeros((1, 16), dtype=torch.int32)
    qs = np.array(gen_primes(32, 1), dtype=np.uint32)
    ntt.staged_pow2(x, ntt.Pow2NTT(qs, 16, negacyclic=True).tree("cpu"),
                    False)
    s = sharded_ntt.ShardedNTT(qs, 16, negacyclic=True, A=2, device="cpu")
    s.inv(s.fwd(x))
    assert _build.launch_counts == Counter(staged=1, sharded=2)
    for fn in (conv.conv_cuda, conv.conv_aux_cuda, ntt_fused.ntt_cuda,
               ntt2.ntt2_cuda, ntt2.conv2_cuda, probes.p1_cuda,
               probes.p2_cuda, embed_max.embed_max_cuda,
               basis_ext.basis_ext_cuda):
        assert not hasattr(fn, "launches")
    for mod in (ntt, sharded_ntt):
        assert not {"staged_transforms", "sharded_transforms"} & set(vars(mod))
    with open(jitutil.__file__) as f:
        tree = ast.parse(f.read())
    top = [n for n in tree.body if isinstance(n, ast.ImportFrom)]
    assert all("parallel" not in (n.module or "") for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom))
    assert [a.name for n in top if n.module == "ops" for a in n.names] == [
        "_build"]


def test_dispatch_key_follows_a_swapped_kernel_and_v2(monkeypatch):
    from helib_tpu_torch.ops import basis_ext, conv
    k0 = jitutil.dispatch_key()
    monkeypatch.setattr(conv, "conv_aux", conv.conv_aux_plain)
    k1 = jitutil.dispatch_key()
    monkeypatch.setenv("HELIB_NTT_V2", "1")
    k2 = jitutil.dispatch_key()
    monkeypatch.setattr(basis_ext, "basis_ext_cuda",
                        basis_ext.basis_ext_plain)
    k3 = jitutil.dispatch_key()
    assert len({k0, k1, k2, k3}) == 4


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
