"""Port vs helib_tpu: K3, the aux-major Bluestein convolution -- its plain
version against `apply_conv_aux(interpret=True)`, a torch emulation of the
CUDA kernel's one-CTA and two-CTA-cluster schedules against the plain
version, the aux-major `bluestein_apply` against the staged JAX transform
(m = 101, 1271 and 32003), the table build, the dispatch by transform size
and the wrapper's refusals (the CUDA kernel itself: test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helib_tpu.nt.primegen import gen_primes
from helib_tpu.ops import ntt as jntt
from helib_tpu.ops.pallas_ntt import apply_conv_aux

from helib_tpu_torch.ops import conv as convmod
from helib_tpu_torch.ops import ntt as tntt
from helib_tpu_torch.ops.conv import conv_aux_cuda, conv_aux_plain
from helib_tpu_torch.ops.modops import (add_mod, sub_mod, mul_mod_shoup,
                                        shoup, to_device, to_host)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _staged_reference(monkeypatch):
    monkeypatch.setattr(jntt, "USE_PALLAS", False)


def _staged_ref(x, jt, m):
    """helib_tpu's staged bluestein_apply, jitted (one compile, not one per
    eager op)."""
    fn = jax.jit(lambda a, t: jntt.bluestein_apply(a, t, m, jt.B))
    return np.asarray(fn(jnp.asarray(x), jt.dev))


def _tables(m, P, inverse=False):
    qs = np.array(gen_primes(m, P), dtype=np.uint32)
    jt = jntt.BluesteinTables(qs, m, inverse)
    tt = tntt.BluesteinTables(qs, m, inverse)
    tree = tt.tree("cpu", tuple(range(P)), tntt.aux_tree(tt.B, "cpu"))
    return qs, jt, tt, tree


@pytest.mark.parametrize("lead", [(), (2,)])
def test_conv_aux_plain_matches_apply_conv_aux_interpret(lead):
    """m = 101 (B = 256), aux-major [3, *lead, P, B]."""
    qs, jt, tt, tree = _tables(101, 2)
    raux = tntt.aux_primes().astype(np.int64)
    rng = np.random.default_rng(31 + len(lead))
    shape = (3,) + lead + (len(qs), tt.B)
    x = rng.integers(0, raux.reshape((3,) + (1,) * (len(shape) - 1)),
                     shape).astype(np.uint32)
    ref = np.asarray(apply_conv_aux(jnp.asarray(x), jt.dev["aux"],
                                    jt.dev["khat_f"], jt.dev["khat_f_sh"],
                                    jt.dev["aux_q"], interpret=True))
    got = conv_aux_plain(to_device(x, "cpu"), tree["aux"], tree["khat"],
                         tree["khat_sh"])
    np.testing.assert_array_equal(to_host(got), ref)
    got = convmod.conv_aux(to_device(x, "cpu"), tree["aux"], tree["khat"],
                           tree["khat_sh"])
    np.testing.assert_array_equal(to_host(got), ref)


def _stages(s, log_n, w, wsh, q, first, boff, inverse):
    """common.cuh ntt_stages on rows s [R, 2^log_n] (w/wsh [R, n] flat
    tables, q [R, 1]), the same index arithmetic, vectorized over each
    stage's butterflies."""
    b = torch.arange(1 << (log_n - 1))
    for k in range(log_n):
        st = log_n - 1 - k if inverse else k
        log_half = log_n - 1 - st
        half = 1 << log_half
        i = b >> log_half
        j0 = (i << (log_half + 1)) | (b & (half - 1))
        j1 = j0 + half
        idx = (1 << (first + st)) + (boff << st) + i
        wi, wshi = w[:, idx], wsh[:, idx]
        u, v = s[:, j0], s[:, j1]
        s = s.clone()
        if inverse:
            s[:, j0] = add_mod(u, v, q)
            s[:, j1] = mul_mod_shoup(sub_mod(u, v, q), wi, wshi, q)
        else:
            wv = mul_mod_shoup(v, wi, wshi, q)
            s[:, j0] = add_mod(u, wv, q)
            s[:, j1] = sub_mod(u, wv, q)
    return s


def _emulate_kernel(x, aux, khat, khat_sh, cluster):
    """conv_aux.cu's schedule on x [3, ..., P, n]: each row split over
    `cluster` (1 or 2) CTAs, stage 0 of each direction across the halves,
    row r on aux prime r / (rows/3) and spectral row t*P + r % P."""
    n, P = x.shape[-1], x.shape[-2]
    log_n = n.bit_length() - 1
    rows = x.reshape(-1, n)
    R = rows.shape[0]
    t = torch.arange(R) // (R // 3)
    krow = t * P + torch.arange(R) % P
    q = aux["q"].reshape(3)[t][:, None]
    w_f, wsh_f = aux["tw_all"][t], aux["tw_all_sh"][t]
    w_i, wsh_i = aux["itw_all"][t], aux["itw_all_sh"][t]
    kh, khsh = khat.reshape(-1, n)[krow], khat_sh.reshape(-1, n)[krow]
    split = cluster.bit_length() - 1
    n_loc = n >> split
    halves = []
    for h in range(cluster):
        own = slice(h * n_loc, (h + 1) * n_loc)
        if cluster == 1:
            s = rows
        else:
            u = rows[:, :n_loc]
            wv = mul_mod_shoup(rows[:, n_loc:], w_f[:, 1:2], wsh_f[:, 1:2], q)
            s = add_mod(u, wv, q) if h == 0 else sub_mod(u, wv, q)
        s = _stages(s, log_n - split, w_f, wsh_f, q, split, h, False)
        s = mul_mod_shoup(s, kh[:, own], khsh[:, own], q)
        halves.append(_stages(s, log_n - split, w_i, wsh_i, q, split, h,
                              True))
    if cluster == 2:
        a, b = halves
        halves = [add_mod(a, b, q),
                  mul_mod_shoup(sub_mod(a, b, q), w_i[:, 1:2], wsh_i[:, 1:2],
                                q)]
    out = torch.cat([mul_mod_shoup(s, w_i[:, :1], wsh_i[:, :1], q)
                     for s in halves], dim=1)
    return out.reshape(x.shape)


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("cluster", [1, 2])
def test_kernel_schedule_emulation_matches_plain(n, cluster):
    """The two-half (cluster) schedule, with its global block offsets, and
    the one-CTA schedule give conv_aux_plain's residues, under a lead dim."""
    raux = tntt.aux_primes().astype(np.int64)
    rng = np.random.default_rng(n + cluster)
    P = 3
    x = rng.integers(0, raux[:, None, None, None], (3, 2, P, n))
    kh = rng.integers(0, raux[:, None, None], (3, P, n)).astype(np.uint32)
    khsh = shoup(kh, raux[:, None, None].astype(np.uint64))
    aux = tntt.aux_tree(n, "cpu")["aux"]
    args = (to_device(x.astype(np.uint32), "cpu"), aux, to_device(kh, "cpu"),
            to_device(khsh, "cpu"))
    want = conv_aux_plain(*args)
    assert torch.equal(_emulate_kernel(*args, cluster=cluster), want)


@pytest.mark.parametrize("m,P,lead", [(101, 3, (2,)), (1271, 2, (2,)),
                                      (32003, 2, ())])
def test_aux_major_bluestein_matches_staged_reference(m, P, lead):
    """Both directions; every host table equal, then the transform (K3's
    plain version inside) equal to helib_tpu's staged row-major path."""
    for inverse in (False, True):
        qs, jt, tt, tree = _tables(m, P, inverse)
        assert tt.B == jt.B and tt.B != tntt.ROW_MAJOR_B
        for k, v in tt.host.items():
            np.testing.assert_array_equal(v, jt.dev[k], err_msg=k)
        rng = np.random.default_rng(m + inverse)
        x = rng.integers(0, qs[:, None].astype(np.int64),
                         lead + (P, m)).astype(np.uint32)
        got = tntt.bluestein_apply(to_device(x, "cpu"), tree, m, tt.B)
        np.testing.assert_array_equal(to_host(got), _staged_ref(x, jt, m))


def test_dispatch_by_transform_size(monkeypatch):
    """B = 16384 (m = 4097 .. 8191, the m=8009 class) goes row-major to K1,
    any other B aux-major to K3."""
    seen = []
    for name in ("conv", "conv_aux"):
        orig = getattr(convmod, name)
        monkeypatch.setattr(convmod, name, lambda x, *a, _n=name, _f=orig:
                            seen.append((_n, tuple(x.shape))) or _f(x, *a))
    for m in (4097, 101):
        qs, jt, tt, tree = _tables(m, 1)
        x = np.arange(m, dtype=np.uint32)[None] % qs[:, None]
        got = tntt.bluestein_apply(to_device(x, "cpu"), tree, m, tt.B)
        np.testing.assert_array_equal(to_host(got), _staged_ref(x, jt, m))
    assert seen == [("conv", (3, 1, 16384)), ("conv_aux", (3, 1, 256))]


def test_conv_aux_wrapper_refuses_cpu_tensors_and_bad_shapes():
    n = 64
    aux = tntt.aux_tree(n, "cpu")["aux"]
    x = torch.zeros((3, 2, n), dtype=torch.int32)
    kh = torch.zeros((3, 2, n), dtype=torch.int32)
    before = conv_aux_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv_aux_cuda(x, aux, kh, kh)
    with pytest.raises(ValueError, match=r"\[3, \.\.\., P, n\]"):
        conv_aux_cuda(torch.zeros((2, 3, 2, n), dtype=torch.int32), aux, kh,
                      kh)
    with pytest.raises(ValueError, match="power of two"):
        conv_aux_cuda(torch.zeros((3, 1, 1 << 17), dtype=torch.int32), aux,
                      kh, kh)
    assert conv_aux_cuda.launches == before
