"""Port vs helib_tpu: K3, the aux-major Bluestein convolution -- its plain
version against `apply_conv_aux(interpret=True)`, a torch emulation of the
CUDA kernels' register-composite schedule (ntt_rows.cuh: one CTA, and
clusters of 2 and 4 CTAs; K3's aux-major and K1's row-major row maps in
the convolution mode, K2's in the forward and inverse modes) against the
plain versions, the aux-major `bluestein_apply` against the staged JAX transform
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
from helib_tpu_torch.ops._build import launch_counts
from helib_tpu_torch.ops import ntt as tntt
from helib_tpu_torch.ops import ntt2
from helib_tpu_torch.ops.conv import conv_aux_cuda, conv_aux_plain
from helib_tpu_torch.ops.ntt_fused import ntt_plain
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


def _levels(r, s0, b, k, w, wsh, q, inverse):
    """composite.cuh levels() on the group list r (r[t]: [R, G] words t of
    G groups; w/wsh [R, n] per-row flat tables, q [R, 1]): level j of
    composite (s0, k) on global block b [G], class cc under the twiddle
    w[2^(s0+j) + b 2^j + cc], fully reduced."""
    for jj in range(k):
        j = k - 1 - jj if inverse else jj
        stride = 1 << (k - 1 - j)
        base = (1 << (s0 + j)) + (b << j)
        for cc in range(1 << j):
            wv, wsv = w[:, base + cc], wsh[:, base + cc]
            for o in range(stride):
                t = (cc << (k - j)) + o
                if inverse:
                    a, d = r[t], r[t + stride]
                    r[t] = add_mod(a, d, q)
                    r[t + stride] = mul_mod_shoup(sub_mod(a, d, q), wv, wsv,
                                                  q)
                else:
                    u = r[t]
                    v = mul_mod_shoup(r[t + stride], wv, wsv, q)
                    r[t] = add_mod(u, v, q)
                    r[t + stride] = sub_mod(u, v, q)


def _composite(s, log_loc, s0, k, c, h, w, wsh, q, inverse):
    """Composite (s0, k) of ntt_rows.cuh on the parts s [R, 2^log_loc]
    of CTA h: the groups of for_each_group (word base + t L of group g,
    block b = g / L), levels at global stage c + s0 and global block
    (h << s0) + b."""
    log_l = log_loc - s0 - k
    g = torch.arange(1 << (log_loc - k))
    b = g >> log_l
    base = (b << (log_loc - s0)) | (g & ((1 << log_l) - 1))
    idx = [base + (t << log_l) for t in range(1 << k)]
    r = [s[:, i] for i in idx]
    _levels(r, c + s0, (h << s0) + b, k, w, wsh, q, inverse)
    out = s.clone()
    for t, i in enumerate(idx):
        out[:, i] = r[t]
    return out


def _cross_forward(rows, cluster, log_loc, w, wsh, q):
    """The cross composite (0, c), forward, of ntt_rows.cuh on the rows
    [R, n]: CTA cta takes the groups j of its share (the words
    j + u n/C), runs levels 0 .. c-1 and writes word u to CTA u's part;
    returns the parts [R, n/C] of the C CTAs."""
    c = cluster.bit_length() - 1
    share = 1 << (log_loc - c)
    parts = [torch.empty(rows.shape[0], 1 << log_loc, dtype=rows.dtype)
             for _ in range(cluster)]
    for cta in range(cluster):      # the CTA that computes these groups
        j = torch.arange(cta * share, (cta + 1) * share)
        r = [rows[:, j + (u << log_loc)] for u in range(cluster)]
        _levels(r, 0, torch.zeros_like(j), c, w, wsh, q, False)
        for u in range(cluster):
            parts[u][:, j] = r[u]
    return parts


def _cross_inverse(parts, log_loc, w, wsh, q):
    """The cross composite (0, c), inverse: each CTA reads its groups back
    from the C parts, runs the levels and writes out times n^-1."""
    cluster = len(parts)
    c = cluster.bit_length() - 1
    share = 1 << (log_loc - c)
    out = torch.empty(parts[0].shape[0], cluster << log_loc,
                      dtype=parts[0].dtype)
    for cta in range(cluster):
        j = torch.arange(cta * share, (cta + 1) * share)
        r = [parts[u][:, j] for u in range(cluster)]
        _levels(r, 0, torch.zeros_like(j), c, w, wsh, q, True)
        for u in range(cluster):
            out[:, j + (u << log_loc)] = mul_mod_shoup(
                r[u], w[:, :1], wsh[:, :1], q)
    return out


def _emulate_kernel(x, aux, khat, khat_sh, cluster, aux_major=True):
    """ntt_rows.cuh's convolution on x (aux-major [3, ..., P, n] as K3, or
    row-major [..., 3, P, n] as K1), each row on a cluster of `cluster`
    CTAs: the cross composite (0, c) over the CTAs, then on each CTA's part
    the composites of ops/ntt2.schedule(log_n - c, 3) at global stage
    c + s0 and global block (h << s0) + b, the last forward one, the khat
    product and the first inverse one on the same groups; then the cross
    composite inverse, read back from the CTAs, times n^-1."""
    n, P = x.shape[-1], x.shape[-2]
    log_n = n.bit_length() - 1
    rows = x.reshape(-1, n)
    R = rows.shape[0]
    r_ = torch.arange(R)
    if aux_major:
        t = r_ // (R // 3)
        krow = t * P + r_ % P
    else:
        krow = r_ % (3 * P)
        t = krow // P
    q = aux["q"].reshape(3)[t][:, None]
    w_f, wsh_f = aux["tw_all"][t], aux["tw_all_sh"][t]
    w_i, wsh_i = aux["itw_all"][t], aux["itw_all_sh"][t]
    kh, khsh = khat.reshape(-1, n)[krow], khat_sh.reshape(-1, n)[krow]
    c = cluster.bit_length() - 1
    log_loc = log_n - c
    sched = ntt2.schedule(log_loc, 3)
    parts = _cross_forward(rows, cluster, log_loc, w_f, wsh_f, q)
    for h in range(cluster):
        s = parts[h]
        own = slice(h << log_loc, (h + 1) << log_loc)
        for s0, k in sched:
            s = _composite(s, log_loc, s0, k, c, h, w_f, wsh_f, q, False)
        s = mul_mod_shoup(s, kh[:, own], khsh[:, own], q)
        for s0, k in reversed(sched):
            s = _composite(s, log_loc, s0, k, c, h, w_i, wsh_i, q, True)
        parts[h] = s
    return _cross_inverse(parts, log_loc, w_i, wsh_i, q).reshape(x.shape)


def _emulate_ntt(x, flat, q, cluster, inverse, max_k=3):
    """ntt_rows.cuh's forward and inverse modes (K2; K4 at max_k) on x
    [..., P, n], row r on prime r mod P, each row on a cluster of `cluster`
    CTAs.  Forward: the cross composite from x, then the local composites
    of schedule(log_n - c, max_k), the last written out.  Inverse: the
    local composites in reverse from the CTA's part of x, then the cross
    composite, times n^-1."""
    n, P = x.shape[-1], x.shape[-2]
    log_n = n.bit_length() - 1
    rows = x.reshape(-1, n)
    t = torch.arange(rows.shape[0]) % P
    qq = q.reshape(P)[t][:, None]
    keys = ("itw_all", "itw_all_sh") if inverse else ("tw_all", "tw_all_sh")
    w, wsh = (flat[k][t] for k in keys)
    c = cluster.bit_length() - 1
    log_loc = log_n - c
    sched = ntt2.schedule(log_loc, max_k)
    if not inverse:
        parts = _cross_forward(rows, cluster, log_loc, w, wsh, qq)
        for h in range(cluster):
            for s0, k in sched:
                parts[h] = _composite(parts[h], log_loc, s0, k, c, h, w, wsh,
                                      qq, False)
        return torch.cat(parts, dim=1).reshape(x.shape)
    parts = list(rows.split(1 << log_loc, dim=1))
    for h in range(cluster):
        for s0, k in reversed(sched):
            parts[h] = _composite(parts[h], log_loc, s0, k, c, h, w, wsh, qq,
                                  True)
    return _cross_inverse(parts, log_loc, w, wsh, qq).reshape(x.shape)


def _emulation_args(n, P, seed, aux_major):
    raux = tntt.aux_primes().astype(np.int64)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, raux[:, None, None, None], (3, 2, P, n))
    if not aux_major:
        x = np.moveaxis(x, 0, 1)
    kh = rng.integers(0, raux[:, None, None], (3, P, n)).astype(np.uint32)
    khsh = shoup(kh, raux[:, None, None].astype(np.uint64))
    aux = tntt.aux_tree(n, "cpu")["aux"]
    return (to_device(np.ascontiguousarray(x).astype(np.uint32), "cpu"), aux,
            to_device(kh, "cpu"), to_device(khsh, "cpu"))


@pytest.mark.parametrize("n", [64, 256, 2048])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_kernel_schedule_emulation_matches_plain(n, cluster):
    """K3's map: the register-composite schedule on one CTA, and on a
    cluster of 2 or 4 with the cross composite and the global stage and
    block offsets, gives conv_aux_plain's residues under a lead dim."""
    args = _emulation_args(n, 3, seed=n + cluster, aux_major=True)
    want = conv_aux_plain(*args)
    assert torch.equal(_emulate_kernel(*args, cluster=cluster), want)


@pytest.mark.parametrize("n", [64, 256, 2048])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_kernel_schedule_emulation_row_major_matches_plain(n, cluster):
    """K1's map (row r on aux prime (r / P) mod 3), the same schedule:
    conv_plain's residues."""
    args = _emulation_args(n, 3, seed=n + cluster + 7, aux_major=False)
    want = convmod.conv_plain(*args)
    assert torch.equal(_emulate_kernel(*args, cluster=cluster,
                                       aux_major=False), want)


@pytest.mark.parametrize("n", [64, 2048])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_kernel_schedule_emulation_ntt_matches_plain(n, cluster):
    """K2's map (row r on prime r mod P) in the forward and inverse modes,
    and K4's schedule at k = 2: ntt_plain's residues under a lead dim."""
    qs = np.array(gen_primes(2 * n, 3), dtype=np.uint32)
    tab = tntt.Pow2NTT(qs, n, negacyclic=True)
    tree = tab.tree("cpu")
    flat = {k: to_device(v, "cpu") for k, v in tab.flat().items()}
    rng = np.random.default_rng(n + cluster + 11)
    x = to_device(rng.integers(0, qs[:, None].astype(np.int64), (2, 3, n))
                  .astype(np.uint32), "cpu")
    for inverse in (False, True):
        want = ntt_plain(x, tree, inverse)
        for max_k in (3, 2):
            assert torch.equal(_emulate_ntt(x, flat, tree["q"], cluster,
                                            inverse, max_k), want)


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
    before = launch_counts.copy()
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv_aux_cuda(x, aux, kh, kh)
    with pytest.raises(ValueError, match=r"\[3, \.\.\., P, n\]"):
        conv_aux_cuda(torch.zeros((2, 3, 2, n), dtype=torch.int32), aux, kh,
                      kh)
    with pytest.raises(ValueError, match="power of two"):
        conv_aux_cuda(torch.zeros((3, 1, 1 << 17), dtype=torch.int32), aux,
                      kh, kh)
    assert launch_counts == before
