"""The port's CUDA kernels (K1 conv, K2 ntt, K3 conv_aux, K4 ntt2, K5
conv2, the probes P1 and P2, embed_max, basis_ext) against their plain
torch versions, and the port on the card against the port on the CPU and
against plaintext images: the batched BGV paths at m=31 (K3) and m=8009
(K1) and CKKS at m=1024, again under HELIB_NTT_V2=1 (K5, K4), CKKS at
m=131072, the launches of the eager ops, the CKKS rotation family, the BGV
measured mod-switch noise at m=31 and m=8009, the BGV slot layer, the thin
and fat bootstraps at m=1271, HElib's circuit library at m=4095,
MatMulCKKS, fhe_stats, the binary export, noise_of and check_noise; the
sizes above the kernels' 2^16 (BGV m=35113, CKKS m=262144) on the staged
transforms, and the command-line utilities on the card.  The twins of
examples/01-10 run on the card, and the parallel layer's m=45 pipelines
run on a one-rank NCCL group and as two gloo ranks sharing the card.
Every jit site (transform, digit decomposition, scaled mod-down, decrypt's
inner product) and a lifted pipeline run as CUDA graphs at m=31, 1271,
8009 and CKKS m=1024, held to the same calls under jitutil.disable_jit().
Launches are read from the port's one count, ops._build.launch_counts.
The thin bootstraps at m=31775 and m=35113, two ranks splitting m=32003's
rows and the whole multi-rank dry run (entry.dryrun_multichip on two
ranks) run for minutes and are marked `cuda_long` as well
(`-m "not cuda_long"` leaves them out).

Every test needs an NVIDIA GPU and skips without one.  The file imports no
JAX, so it also runs where only PyTorch is installed (the conftest, which
imports JAX, is left out):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider \
        tests/test_torch_cuda.py -q
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch

from helib_tpu_torch import ksstrategy
from helib_tpu_torch.context import Context
from helib_tpu_torch.ea import EncryptedArray
from helib_tpu_torch.encoded import FatEncodedPtxt
from helib_tpu_torch.keys import SecKey, PubKey
from helib_tpu_torch.ops import conv as convmod
from helib_tpu_torch.ptxt import PtxtBGV
from helib_tpu_torch.ops import ntt
from helib_tpu_torch.ops._build import launch_counts
from helib_tpu_torch.ops.conv import (conv, conv_cuda, conv_plain, conv_aux,
                                      conv_aux_cuda, conv_aux_plain)
from helib_tpu_torch.ops import ntt_fused, ntt2, probes
from helib_tpu_torch.nt.primegen import gen_primes
from helib_tpu_torch.ops.modops import shoup, to_device
from helib_tpu_torch.pipeline import (make_batched_mult_relin,
                                      make_automorph_relin, make_mult_relin)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launched(fn):
    """(fn(), what it added to the port's launch counts, by key)."""
    before = launch_counts.copy()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts - before


_SETUPS: dict = {}


def _setup(key, build):
    """build(), made once for the module under `key`."""
    if key not in _SETUPS:
        _SETUPS[key] = build()
    return _SETUPS[key]


def _conv_args(n, P, seed, dev, lead=(2,)):
    raux = ntt.aux_primes().astype(np.int64)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, raux[:, None, None], lead + (3, P, n)).astype(
        np.uint32)
    kh = rng.integers(0, raux[:, None, None], (3, P, n)).astype(np.uint32)
    khsh = shoup(kh, raux[:, None, None].astype(np.uint64))
    return (to_device(x, dev), ntt.aux_tree(n, dev)["aux"],
            to_device(kh, dev), to_device(khsh, dev))


# (P, lead): odd P; 273 rows, a multiple of neither the CTAs nor the
# clusters the H100 holds at once (132 SMs)
SHAPES = [(5, (2,)), (7, (13,))]


@pytest.mark.parametrize("P,lead", SHAPES)
@pytest.mark.parametrize("n", [8, 64, 2048, 16384, 32768])
def test_conv_kernel_matches_plain_on_gpu(gpu, n, P, lead):
    args = _conv_args(n, P, seed=n + P, dev=gpu, lead=lead)
    got, launched = _launched(lambda: conv(*args))
    assert launched == Counter(conv=1)
    assert torch.equal(got, conv_plain(*args))


@pytest.mark.parametrize("n", [48, 4, 65536])
def test_conv_kernel_refuses_unsupported_lengths(gpu, n):
    x = torch.zeros((1, 3, 2, n), dtype=torch.int32, device=gpu)
    before = launch_counts.copy()
    with pytest.raises(ValueError, match="power of two"):
        conv_cuda(x, {}, None, None)
    assert launch_counts == before


@pytest.mark.parametrize("n", [8, 64, 2048, 16384, 32768])
def test_conv_kernel_equals_conv2_at_k3(gpu, n):
    """K1 and K5 at k = 3 run the same schedule: equal bit for bit."""
    args = _conv_args(n, 7, seed=n + 11, dev=gpu, lead=(3,))
    got = conv_cuda(*args)
    assert torch.equal(got, ntt2.conv2_cuda(*args, 3))
    assert torch.equal(got, conv_plain(*args))


# every m at which the port runs eager BGV: rows of m coefficients at odd
# m, m/2 at a power of 2
EMBED_MS = [31, 1271, 4095, 8009, 31775, 32003, 35113, 64, 256, 1024, 65536]


@pytest.mark.parametrize("m", EMBED_MS)
def test_embed_max_kernel_matches_plain_on_gpu(gpu, m):
    """The noise measurement's canonical-embedding max: three rows, the
    last zero (reads 0), to 1e-12 relative of the plain version; one
    counted launch a call."""
    from helib_tpu_torch.ops import embed_max as em
    n = m // 2 if m & (m - 1) == 0 else m
    rng = np.random.default_rng(m)
    x = torch.from_numpy((rng.random((3, n)) - 0.5).astype(np.float32))
    x[-1] = 0.0
    tab = em.embed_tables(m, n, gpu)
    got, launched = _launched(lambda: em.embed_max(x.to(gpu), tab))
    assert launched == Counter(embed_max=1)
    want = em.embed_max_plain(x.to(gpu), tab)
    assert got[-1].item() == 0.0
    assert torch.allclose(got, want, rtol=1e-12, atol=0.0)


# the main path's lifts (batch, source rows, target rows, p^r, N): BGV
# m=32003's digit (65 onto all 259 rows) and special mod-down (65 onto 194
# and the p^r row), CKKS m=65536's batched digit (5 onto 20); then m=8009's
# digit and mod-down, one source prime, and a digit of 4 rows onto a p^r
# of 257 at a ragged N
LIFTS = [(1, 65, 259, 0, 32003), (1, 65, 194, 2, 32003),
         (16, 5, 20, 0, 32768), (1, 5, 18, 0, 8009), (2, 5, 13, 2, 8009),
         (3, 1, 13, 0, 1000), (2, 4, 18, 257, 131)]


@pytest.mark.parametrize("batch,kd,T,pr,n", LIFTS)
def test_basis_ext_kernel_matches_plain_on_gpu(gpu, batch, kd, T, pr, n):
    """The RNS basis extension at the main path's shapes: the residues and
    the float64 remainder bit for bit those of the plain version on the
    card; one counted launch a call."""
    from helib_tpu_torch.ops import basis_ext as be
    primes = gen_primes(2, kd + T)
    d, t = primes[:kd], primes[kd:] + ([pr] if pr > 1 else [])
    rng = np.random.default_rng(kd + T)
    x = to_device(rng.integers(0, np.array(d, dtype=np.int64)[:, None],
                               (batch, kd, n)).astype(np.uint32), gpu)
    tab = be.basis_ext_tables(d, t, gpu)
    (got, frac), launched = _launched(
        lambda: be.basis_ext(x, tab, want_frac=True))
    assert launched == Counter(basis_ext=1)
    want, want_frac = be.basis_ext_plain(x, tab, want_frac=True)
    assert torch.equal(got, want) and torch.equal(frac, want_frac)


@pytest.mark.parametrize("params", [dict(m=31, p=2, r=1, bits=300, c=3),
                                    dict(m=8009, p=2, r=1, bits=380, c=3)])
def test_measured_mod_down_on_gpu_equals_cpu_port(gpu, params, monkeypatch):
    """Measurement on: the noise after dropping one ciphertext prime, then
    two more, on the card equals the port's on the host (which
    test_torch_embed_max holds to helib_tpu's) within 1e-9, with the same
    residues, one embed_max launch a mod-down on the card and none on the
    host (keys and encryption are host-seeded, so the same on both)."""
    from helib_tpu_torch.ops import embed_max as em
    monkeypatch.delenv("HELIB_EXACT_MODSWITCH", raising=False)

    def encrypted(ctx):
        pk = PubKey(SecKey(ctx, seed=7))
        pt = np.random.default_rng(2).integers(0, 2, ctx.phi_m)
        return pk.encrypt_bgv(pt, np.random.default_rng(5))

    ct = encrypted(Context(**params))
    host = encrypted(Context(**params, device="cpu"))
    for (_, a), (_, b) in zip(ct.parts, host.parts):
        assert torch.equal(a.cpu(), b)
    for target in (ct.k - 1, ct.k - 3):
        before = launch_counts["embed_max"]
        ct.mod_down_to(target, False)
        assert launch_counts["embed_max"] == before + 1
        host.mod_down_to(target, False)
        assert launch_counts["embed_max"] == before + 1
        assert abs(ct.noise - host.noise) <= 1e-9
        for (_, a), (_, b) in zip(ct.parts, host.parts):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("m,bits,kernel", [(31, 300, "conv_aux"),
                                           (8009, 380, "conv")])
def test_batched_mult_relin_on_gpu_equals_cpu_port(gpu, m, bits, kernel):
    """Batch 2: m=31 (B = 64) goes aux-major through K3, m=8009 (B = 16384,
    the BGV main path) row-major through K1; 8 transforms and 5 lifts a
    call, the same as the port on the host, and the call lifted into one
    graph equals the same call under disable_jit()."""
    from helib_tpu_torch import jitutil
    params = dict(m=m, p=2, r=1, bits=bits, c=3)
    ctx, ctx_cpu = Context(**params), Context(**params, device="cpu")
    assert ctx.device.type == "cuda"
    fn, args = make_batched_mult_relin(ctx, SecKey(ctx, seed=3), 2)
    fn_cpu, _ = make_batched_mult_relin(ctx_cpu, SecKey(ctx_cpu, seed=3), 2)
    got, launched = _launched(lambda: fn(*args))
    assert launched == Counter({kernel: 8, "basis_ext": 5})
    want = fn_cpu(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    lifted = jitutil.lifted_jit(fn, *args)
    lifted(*args)
    replayed, launched = _launched(lambda: lifted(*args))
    assert lifted.captures == 1
    assert launched == Counter({kernel: 8, "basis_ext": 5})
    with jitutil.disable_jit():
        eager = fn(*args)
    for g, e, f in zip(replayed, eager, got):
        assert torch.equal(g, e) and torch.equal(g, f)


def _eager_path(name, gpu):
    """One warm eager op of the m=8009 BGV main path or of CKKS at m=1024,
    as a function of no arguments."""
    from helib_tpu_torch.ckks import EncryptedArrayCKKS
    from helib_tpu_torch.keys import SKHandle
    if name.startswith("bgv"):
        ctx = Context(m=8009, p=2, r=1, bits=380, c=3)
        sk = SecKey(ctx, seed=3)
        pk = PubKey(sk)
        sk.gen_ks_matrix(SKHandle(2, 1, 0))
        sk.gen_ks_matrix(SKHandle(1, 3, 0))
        rng = np.random.default_rng(6)
        a, b = (pk.encrypt_bgv(rng.integers(0, 2, ctx.phi_m), rng)
                for _ in range(2))
        if name == "bgv_mult":
            return lambda: a.multiply(b, pk)
        return lambda: a.copy().smart_automorph(3, pk)
    ctx = Context(m=1024, p=-1, r=30, bits=240, c=3, scheme="ckks")
    sk = SecKey(ctx, seed=3)
    pk = PubKey(sk)
    sk.gen_ks_matrix(SKHandle(2, 1, 0))
    ea = EncryptedArrayCKKS(ctx)
    z = ea.encrypt(np.ones(ea.nslots), pk, np.random.default_rng(3))
    return lambda: ea.rescale(z.multiply(z, pk))


@pytest.mark.parametrize("name,want", [
    ("bgv_mult", Counter(conv=12, basis_ext=7, embed_max=2)),
    ("bgv_rotate", Counter(conv=4, basis_ext=3)),
    ("ckks_mult_rescale", Counter(ntt=12, basis_ext=7))])
def test_eager_ops_launch_one_lift_a_digit_and_a_mod_down(gpu, name, want):
    """An eager op, warm (its sites replaying graphs): one basis_ext a digit
    of each relinearized part and one a scaled mod-down, one embed_max a
    measured BGV mod-down, and no other kernel than its transform's."""
    op = _eager_path(name, gpu)
    op()
    assert _launched(op)[1] == want


@pytest.mark.parametrize("P,lead", SHAPES)
@pytest.mark.parametrize("n", [256, 4096, 32768, 65536])
def test_conv_aux_kernel_matches_plain_on_gpu(gpu, n, P, lead):
    """Aux-major [3, *lead, P, n]; n = 65536 runs a cluster per row."""
    x, aux, kh, khsh = _conv_args(n, P, seed=n + P + 1, dev=gpu, lead=lead)
    x = x.movedim(len(lead), 0).contiguous()
    got, launched = _launched(lambda: conv_aux(x, aux, kh, khsh))
    assert launched == Counter(conv_aux=1)
    assert torch.equal(got, conv_aux_plain(x, aux, kh, khsh))


@pytest.mark.parametrize("n", [48, 4, 131072])
def test_conv_aux_kernel_refuses_unsupported_lengths(gpu, n):
    x = torch.zeros((3, 2, n), dtype=torch.int32, device=gpu)
    before = launch_counts.copy()
    with pytest.raises(ValueError, match="power of two"):
        conv_aux_cuda(x, {}, None, None)
    assert launch_counts == before


def test_rotate_m1271_on_gpu_equals_cpu_port(gpu):
    """The per-op rotate at m=1271 (B = 4096, K3) against the port on the
    host."""
    params = dict(m=1271, p=2, r=1, bits=120, c=3)
    ctx, ctx_cpu = Context(**params), Context(**params, device="cpu")
    fn, args = make_automorph_relin(ctx, SecKey(ctx, seed=4))
    fn_cpu, _ = make_automorph_relin(ctx_cpu, SecKey(ctx_cpu, seed=4))
    got, launched = _launched(lambda: fn(*args))
    assert launched["conv_aux"] == 8 and launched["conv"] == 0
    want = fn_cpu(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


def _ntt_args(n, P, seed, dev, lead=(2,)):
    qs = np.array(gen_primes(2 * n, P), dtype=np.uint32)
    tab = ntt.Pow2NTT(qs, n, negacyclic=True)
    t = {**tab.tree(dev),
         "flat": {k: to_device(v, dev) for k, v in tab.flat().items()}}
    rng = np.random.default_rng(seed)
    x = rng.integers(0, qs[:, None].astype(np.int64), lead + (P, n))
    return to_device(x.astype(np.uint32), dev), t


NTT_SIZES = [8, 64, 2048, 16384, 32768, 65536]


@pytest.mark.parametrize("P,lead", [(5, (2,)), (7, (3, 13))])
@pytest.mark.parametrize("n", NTT_SIZES)
def test_ntt_kernel_matches_plain_on_gpu(gpu, n, P, lead):
    """Both directions, leading batch dims (row r uses prime r mod P), odd
    P; n = 32768 on its shipped configuration, n = 65536 on 4-CTA
    clusters."""
    x, t = _ntt_args(n, P, seed=n + P, dev=gpu, lead=lead)

    def both():
        fwd = ntt_fused.ntt(x, t, inverse=False)
        return fwd, ntt_fused.ntt(fwd, t, inverse=True)
    (fwd, inv), launched = _launched(both)
    assert launched == Counter(ntt=2)
    assert torch.equal(fwd, ntt_fused.ntt_plain(x, t, inverse=False))
    assert torch.equal(inv, ntt_fused.ntt_plain(fwd, t, inverse=True))
    assert torch.equal(inv, x)


@pytest.mark.parametrize("n", [48, 4, 131072])
def test_ntt_kernel_refuses_unsupported_lengths(gpu, n):
    x = torch.zeros((1, 2, n), dtype=torch.int32, device=gpu)
    before = launch_counts.copy()
    with pytest.raises(ValueError, match="power of two"):
        ntt_fused.ntt_cuda(x, {}, None, inverse=False)
    assert launch_counts == before


def test_ckks_batched_mult_relin_on_gpu_equals_cpu_port(gpu):
    params = dict(m=1024, p=-1, r=35, bits=300, c=3, scheme="ckks")
    ctx, ctx_cpu = Context(**params), Context(**params, device="cpu")
    fn, args = make_batched_mult_relin(ctx, SecKey(ctx, seed=2), 2)
    fn_cpu, _ = make_batched_mult_relin(ctx_cpu, SecKey(ctx_cpu, seed=2), 2)
    got, launched = _launched(lambda: fn(*args))
    assert launched["ntt"] == 8 and launched["conv"] == 0
    want = fn_cpu(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


CKKS_ROT = dict(m=1024, p=-1, r=30, bits=240, c=3, scheme="ckks")


def _shifted(v):
    out = np.roll(v, 1)
    out[0] = 0
    return out


# name -> (the op on (ea, ciphertext, key), its effect on the slots)
CKKS_ROTATIONS = {
    "rotate1": (lambda ea, c, k: ea.rotate(c.copy(), 1, k),
                lambda v: np.roll(v, 1)),
    "rotate5": (lambda ea, c, k: ea.rotate(c.copy(), 5, k),
                lambda v: np.roll(v, 5)),
    "conjugate": (lambda ea, c, k: c.copy().conjugate(k), np.conj),
    "shift1": (lambda ea, c, k: ea.shift(c.copy(), 1, k), _shifted),
    "real": (lambda ea, c, k: ea.extract_real_part(c, k),
             lambda v: np.real(v) + 0j),
    "imag": (lambda ea, c, k: ea.extract_imaginary_part(c, k),
             lambda v: np.imag(v) + 0j)}


def _ckks_rot_case(device):
    """(ea, sk, slots, their encryption at scale 2^40), host-seeded."""
    from helib_tpu_torch.ckks import EncryptedArrayCKKS
    ctx = Context(**CKKS_ROT, device=device)
    sk = SecKey(ctx, seed=5)
    PubKey(sk)
    ea = EncryptedArrayCKKS(ctx)
    rng = np.random.default_rng(7)
    z = rng.uniform(-1, 1, ea.nslots) + 1j * rng.uniform(-1, 1, ea.nslots)
    return ea, sk, z, ea.encrypt(z, sk.pubkey, rng, scale=1 << 40)


@pytest.mark.parametrize("op", list(CKKS_ROTATIONS))
def test_ckks_rotation_family_on_gpu_equals_cpu_port(gpu, op):
    """CKKS at m=1024: rotate by 1 and 5, conjugate, shift by 1, the real
    and the imaginary part through K2 alone (bar the lifts), decrypting to
    the slots' image within min(1e-2, 4 x error_bound()), bit-identical to
    the port on the host."""
    f, effect = CKKS_ROTATIONS[op]
    ea, sk, z, ct = _setup("ckks_rot", lambda: _ckks_rot_case("cuda"))
    out, launched = _launched(lambda: f(ea, ct, sk))
    assert launched["ntt"] > 0 and set(launched) <= {"ntt", "basis_ext"}
    err = float(np.max(np.abs(ea.decrypt(out, sk) - effect(z))))
    assert err <= min(1e-2, 4 * out.error_bound())
    ea_h, sk_h, _, ct_h = _setup("ckks_rot_cpu",
                                 lambda: _ckks_rot_case("cpu"))
    host = f(ea_h, ct_h, sk_h)
    assert (out.k, out.ratFactor) == (host.k, host.ratFactor)
    for (_, a), (_, b) in zip(out.parts, host.parts):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n", NTT_SIZES)
def test_ntt_kernel_equals_ntt2_at_k3(gpu, n):
    """K2 and K4 at k = 3 are one instantiation: equal bit for bit."""
    x, t = _ntt_args(n, 7, seed=n + 13, dev=gpu, lead=(3,))
    for inverse in (False, True):
        got = ntt_fused.ntt_cuda(x, t["flat"], t["q"], inverse)
        assert torch.equal(got, ntt2.ntt2_cuda(x, t["flat"], t["q"],
                                               inverse, 3))
        assert torch.equal(got, ntt_fused.ntt_plain(x, t, inverse))


@pytest.mark.parametrize("n", NTT_SIZES)
def test_ntt2_kernel_matches_plain_at_every_k(gpu, n):
    """K4 against ntt2_plain and K2's ntt_plain, both directions, every k."""
    x, t = _ntt_args(n, 5, seed=n + 7, dev=gpu)
    fwd = ntt_fused.ntt_plain(x, t, inverse=False)
    inv = ntt_fused.ntt_plain(x, t, inverse=True)
    for k in range(1, ntt2.K_MAX + 1):
        (got_f, got_i), launched = _launched(lambda: (
            ntt2.ntt2_cuda(x, t["flat"], t["q"], False, k),
            ntt2.ntt2_cuda(x, t["flat"], t["q"], True, k)))
        assert launched == Counter(ntt2=2)
        assert torch.equal(got_f, fwd) and torch.equal(got_i, inv)
        assert torch.equal(got_f, ntt2.ntt2_plain(x, t["flat"], t["q"],
                                                  False, k))


def test_ckks_m131072_mult_relin_on_gpu_equals_cpu_port(gpu):
    """m=131072 (n = 65536): every transform through K2's 4-CTA
    clusters."""
    params = dict(m=131072, p=-1, r=30, bits=440, c=3, scheme="ckks")
    ctx, ctx_cpu = Context(**params), Context(**params, device="cpu")
    fn, args = make_mult_relin(ctx, SecKey(ctx, seed=2))
    fn_cpu, _ = make_mult_relin(ctx_cpu, SecKey(ctx_cpu, seed=2))
    got, launched = _launched(lambda: fn(*args))
    assert launched["ntt"] == 8
    want = fn_cpu(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [8, 64, 2048, 16384, 32768])
def test_conv2_kernel_matches_plain_at_every_k(gpu, n):
    args = _conv_args(n, 5, seed=n + 3, dev=gpu)
    ref = conv_plain(*args)
    for k in range(1, ntt2.K_MAX + 1):
        got, launched = _launched(lambda: ntt2.conv2_cuda(*args, k))
        assert launched == Counter(ntt2_conv=1)
        assert torch.equal(got, ref)
        assert torch.equal(got, ntt2.conv2_plain(*args, k))


def test_v2_dispatch_launches_k4_and_k5(gpu, monkeypatch):
    """HELIB_NTT_V2=1 routes ntt and conv to K4 and K5, leaves K3 alone."""
    monkeypatch.setenv("HELIB_NTT_V2", "1")
    monkeypatch.setenv("HELIB_NTT_V2_K", "3")
    x, t = _ntt_args(2048, 3, seed=5, dev=gpu)
    args = _conv_args(4096, 3, seed=6, dev=gpu)
    xa = args[0].movedim(1, 0).contiguous()
    got, launched = _launched(lambda: (
        ntt_fused.ntt(x, t, inverse=False), conv(*args),
        conv_aux(xa, *args[1:])))
    assert launched == Counter(ntt2=1, ntt2_conv=1, conv_aux=1)
    assert torch.equal(got[0], ntt_fused.ntt_plain(x, t, inverse=False))
    assert torch.equal(got[1], conv_plain(*args))
    assert torch.equal(got[2], conv_aux_plain(xa, *args[1:]))


@pytest.mark.parametrize("params,kernel", [
    (dict(m=8009, p=2, r=1, bits=380, c=3), "ntt2_conv"),
    (dict(m=1024, p=-1, r=35, bits=300, c=3, scheme="ckks"), "ntt2")])
def test_batched_path_under_v2_equals_default(gpu, monkeypatch, params,
                                             kernel):
    """HELIB_NTT_V2=1 at batch 2: the BGV m=8009 path through K5 alone and
    the CKKS path through K4 alone (bar the lifts), bit-identical to the
    default run through K1 and K2."""
    ctx = Context(**params)
    fn, args = make_batched_mult_relin(ctx, SecKey(ctx, seed=3), 2)
    base = fn(*args)
    monkeypatch.setenv("HELIB_NTT_V2", "1")
    got, launched = _launched(lambda: fn(*args))
    assert launched == Counter({kernel: 8, "basis_ext": 5})
    assert all(torch.equal(g, b) for g, b in zip(got, base))


def _probe_args(n, R, seed, dev):
    raux = ntt.aux_primes()
    qrow = raux[np.arange(R) % 3].astype(np.uint32)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, qrow[:, None].astype(np.int64), (R, n))
    w = rng.integers(1, qrow[:, None].astype(np.int64), (R, n))
    wsh = shoup(w.astype(np.uint32), qrow[:, None].astype(np.uint64))
    return [to_device(a.astype(np.uint32), dev)
            for a in (x, w, wsh, qrow[:, None])]


@pytest.mark.parametrize("variant", probes.P1_VARIANTS)
def test_p1_probe_matches_plain(gpu, variant):
    args = _probe_args(16384, 6, seed=1, dev=gpu)
    got, launched = _launched(lambda: probes.p1_cuda(variant, *args))
    assert launched == Counter(probes=1)
    assert torch.equal(got, probes.p1_plain(variant, *args))


@pytest.mark.parametrize("phase", probes.P2_PHASES)
def test_p2_probe_matches_plain(gpu, phase):
    x = _probe_args(16384, 6, seed=2, dev=gpu)[0]
    aux = ntt.aux_tree(16384, gpu)["aux"]
    tabs = (aux["tw_all"], aux["tw_all_sh"], aux["q"].reshape(3, 1))
    got = probes.p2_cuda(phase, x, *tabs)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.p2_plain(phase, x, *tabs))


@pytest.mark.parametrize("phase", probes.P2_PHASES)
def test_p2_probe_at_65536_matches_plain(gpu, phase):
    """n = 65536 on 4-CTA clusters (coarse through distributed shared
    memory), 5 rows on 3 tables, alone and chained twice."""
    x = _probe_args(65536, 5, seed=3, dev=gpu)[0]
    aux = ntt.aux_tree(65536, gpu)["aux"]
    tabs = (aux["tw_all"], aux["tw_all_sh"], aux["q"].reshape(3, 1))
    got, launched = _launched(lambda: probes.p2_cuda(
        phase, probes.p2_cuda(phase, x, *tabs), *tabs))
    assert launched == Counter(probes=2)
    assert torch.equal(got, probes.p2_plain(
        phase, probes.p2_plain(phase, x, *tabs), *tabs))


@pytest.mark.parametrize("variant", probes.P1_VARIANTS)
def test_p1_probe_fills_part_of_the_last_cta(gpu, variant):
    """5 rows of 256 words (512 for stage_c64, its least N): every
    variant's threads end inside the last CTA (8 to 64 threads a row, 128
    a CTA)."""
    args = _probe_args(512 if variant == "stage_c64" else 256, 5, seed=4,
                       dev=gpu)
    got = probes.p1_cuda(variant, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.p1_plain(variant, *args))


SLOTS = dict(m=1271, p=2, r=1, bits=120, c=3, mvec=(31, 41))


def _slot_keys(ctx):
    sk = SecKey(ctx, seed=6)
    PubKey(sk)
    ksstrategy.add_some_1d_matrices(sk)
    return sk


def test_fat_encoded_ptxt_through_k3_equals_plain(gpu, monkeypatch):
    """A FatEncodedPtxt's full-row transform (m=1271, B = 4096) through K3,
    through the plain convolution on the card, and on the host."""
    ctx = Context(**SLOTS)
    ea = EncryptedArray(ctx)
    rng = np.random.default_rng(8)
    poly = ea.encode([rng.integers(0, 2, ea.d) for _ in range(ea.nslots)])
    got, launched = _launched(
        lambda: FatEncodedPtxt(ctx, poly, space=2).rt(ctx.L, True))
    assert launched["conv_aux"] == 1 and launched["conv"] == 0
    assert got.is_cuda and got.shape == (ctx.L + ctx.S, ctx.n_eval)
    cpu = FatEncodedPtxt(Context(**SLOTS, device="cpu"), poly, space=2)
    assert torch.equal(got.cpu(), cpu.rt(ctx.L, True))
    monkeypatch.setattr(convmod, "conv_aux", convmod.conv_aux_plain)
    plain, launched = _launched(
        lambda: FatEncodedPtxt(ctx, poly, space=2).rt(ctx.L, True))
    assert launched["conv_aux"] == 0
    assert torch.equal(got, plain)
    assert torch.equal(FatEncodedPtxt(ctx, poly, space=2).rt(3, True),
                       torch.cat([got[:3], got[ctx.L:]]))


def test_slot_rotate_m1271_through_k3_equals_plain_and_cpu(gpu,
                                                           monkeypatch):
    """ea.rotate by 1 at m=1271, mvec=(31, 41) (orders [30, 2], the last
    dimension bad: two automorphisms blended with masks, and a carry)
    through K3 and no other kernel, against the same chain with the plain
    convolution and against the port on the host (keys and encryption are
    host-seeded, so the same on both); the decrypt equals the PtxtBGV
    oracle."""
    def encrypted(ctx):
        sk = _slot_keys(ctx)
        ea = EncryptedArray(ctx)
        rng = np.random.default_rng(9)
        slots = [rng.integers(0, 2, ea.d) for _ in range(ea.nslots)]
        return sk, ea, slots, ea.encrypt(slots, sk.pubkey, rng)

    ctx = Context(**SLOTS)
    sk, ea, slots, ct = encrypted(ctx)
    assert (ctx.pal.orders, ctx.pal.native) == ([30, 2], [True, False])
    minted = len(sk.matrices)
    got, launched = _launched(lambda: ea.rotate(ct.copy(), 1, sk))
    assert launched["conv_aux"] > 0
    assert launched["conv"] == 0 and len(sk.matrices) == minted
    want = PtxtBGV(ea, slots).rotate(1)
    assert PtxtBGV.decode(ea, sk.decrypt_bgv(got)) == want

    sk_cpu, ea_cpu, _, ct_cpu = encrypted(Context(**SLOTS, device="cpu"))
    host = ea_cpu.rotate(ct_cpu, 1, sk_cpu)

    monkeypatch.setattr(convmod, "conv_aux", convmod.conv_aux_plain)
    plain, launched = _launched(lambda: ea.rotate(ct.copy(), 1, sk))
    assert launched["conv_aux"] == 0
    for ref in (plain, host):
        assert [(h, ref.k, ref.special) for h, _ in ref.parts] == [
            (h, got.k, got.special) for h, _ in got.parts]
        for (_, a), (_, b) in zip(got.parts, ref.parts):
            assert torch.equal(a.cpu(), b.cpu())


def _plus(ct, c):
    out = ct.copy()
    out.add_constant(c)
    return out


def _times(ct, c):
    out = ct.copy()
    out.mul_by_constant(c)
    return out


def _shift_1d(pt, dim: int, amt: int):
    """The PtxtBGV image of EncryptedArray.shift_1d by amt > 0: rotate
    along dim, zero the slots whose coordinate came in from below."""
    pal = pt.ea.ctx.pal
    out = pt.rotate_1d(dim, amt)
    for s in range(pt.ea.nslots):
        if pal.coords(s)[dim] < amt:
            out.slots[s] = np.zeros(pt.ea.d, dtype=np.int64)
    return out


def _replicated(pt, pos: int):
    out = pt.copy()
    out.slots = [pt.slots[pos].copy() for _ in pt.slots]
    return out


def _slot_ops():
    """name -> (the op on (ea, sk, ca, cb, slots b), its PtxtBGV image of
    (a, b)): the slot layer's ops beside the rotate by 1, at m=1271 the
    bad dimension 1."""
    from helib_tpu_torch.algos.replicate import replicate
    from helib_tpu_torch.algos.sums import total_sums
    return {
        "multiply": (lambda ea, sk, ca, cb, b: ca.multiply(cb, sk),
                     lambda pa, pb: pa.multiply(pb)),
        "add_constant": (
            lambda ea, sk, ca, cb, b: _plus(ca, ea.encode_ptxt(b)),
            lambda pa, pb: pa.add(pb)),
        "mul_by_constant": (
            lambda ea, sk, ca, cb, b: _times(ca, FatEncodedPtxt(
                ea.ctx, ea.encode(b), space=ea.pr)),
            lambda pa, pb: pa.multiply(pb)),
        "rotate41": (lambda ea, sk, ca, cb, b: ea.rotate(ca.copy(), 41, sk),
                     lambda pa, pb: pa.rotate(41)),
        "shift_1d": (
            lambda ea, sk, ca, cb, b: ea.shift_1d(ca.copy(), 1, 1, sk),
            lambda pa, pb: _shift_1d(pa, 1, 1)),
        "total_sums": (lambda ea, sk, ca, cb, b: total_sums(ea, ca.copy(),
                                                            sk),
                       lambda pa, pb: pa.total_sums()),
        "replicate": (lambda ea, sk, ca, cb, b: replicate(ea, ca.copy(), 7,
                                                          sk),
                      lambda pa, pb: _replicated(pa, 7))}


def _slot_case(device):
    """(sk, ea, slots a, slots b, their encryptions), host-seeded."""
    ctx = Context(**SLOTS, device=device)
    sk = _slot_keys(ctx)
    ea = EncryptedArray(ctx)
    rng = np.random.default_rng(10)
    a, b = ([rng.integers(0, 2, ea.d) for _ in range(ea.nslots)]
            for _ in range(2))
    return (sk, ea, a, b, ea.encrypt(a, sk.pubkey, rng),
            ea.encrypt(b, sk.pubkey, rng))


@pytest.mark.parametrize("op", ["multiply", "add_constant", "mul_by_constant",
                                "rotate41", "shift_1d", "total_sums",
                                "replicate"])
def test_slot_op_m1271_through_k3_equals_oracle_and_cpu(gpu, op):
    """Each slot op at m=1271 through K3 alone (bar the lifts and the
    measured noise): its decrypt is the PtxtBGV image of the slots, and its
    parts are the port's on the host bit for bit."""
    f, image = _slot_ops()[op]
    sk, ea, a, b, ca, cb = _setup("slots", lambda: _slot_case("cuda"))
    got, launched = _launched(lambda: f(ea, sk, ca, cb, b))
    assert launched["conv_aux"] > 0
    assert set(launched) <= {"conv_aux", "basis_ext", "embed_max"}
    want = image(PtxtBGV(ea, a), PtxtBGV(ea, b))
    assert np.array_equal(sk.decrypt_bgv(got), ea.encode(want.slots))
    sk_h, ea_h, _, _, ca_h, cb_h = _setup("slots_cpu",
                                          lambda: _slot_case("cpu"))
    host = f(ea_h, sk_h, ca_h, cb_h, b)
    assert [(h, host.k, host.special) for h, _ in host.parts] == [
        (h, got.k, got.special) for h, _ in got.parts]
    for (_, x), (_, y) in zip(got.parts, host.parts):
        assert torch.equal(x.cpu(), y)


BOOT = dict(m=1271, p=2, r=1, bits=600, c=3, mvec=(31, 41))


def test_thin_recrypt_m1271_through_k3_equals_plain_and_cpu(gpu,
                                                            monkeypatch):
    """thin_recrypt at m=1271, mvec=(31, 41) (the factor-tree maps, B =
    4096) through K3 and no other kernel, bit-identical to the same
    bootstrap with the plain convolution (its constants built plain too)
    and to the port on the host CPU (keys, the recryption key, ekey and the
    encryption are host-seeded, so the same on all three); it decrypts to
    its input slots, and a warm run with the PubKey alone mints nothing and
    decrypts alike."""
    from helib_tpu_torch.recryption import RecryptData, thin_recrypt

    def boot(ctx):
        sk = SecKey(ctx, seed=131, hwt=64)
        PubKey(sk)
        ea = EncryptedArray(ctx)
        rc = RecryptData(ctx, sk, ea, hwt=64)
        rng = np.random.default_rng(133)
        slots = [int(v) for v in rng.integers(0, 2, ea.nslots)]
        low = ea.encrypt(slots, sk.pubkey, rng)
        low.bring_to_k(3)
        return thin_recrypt(low, rc, sk), sk, ea, slots, low, rc

    (got, sk, ea, slots, low, rc), launched = _launched(
        lambda: boot(Context(**BOOT)))
    assert launched["conv_aux"] > 0 and launched["conv"] == 0
    assert np.array_equal(sk.decrypt_bgv(got), ea.encode(slots))
    assert got.is_correct() and got.capacity() > low.capacity() + 30
    minted = len(sk.matrices)
    warm = thin_recrypt(low, rc, sk.pubkey)
    assert len(sk.matrices) == minted
    assert np.array_equal(sk.decrypt_bgv(warm), ea.encode(slots))
    assert warm.is_correct() and warm.capacity() > low.capacity() + 30
    host = boot(Context(**BOOT, device="cpu"))[0]
    monkeypatch.setattr(convmod, "conv_aux", convmod.conv_aux_plain)
    (plain, *_), launched = _launched(lambda: boot(Context(**BOOT)))
    assert launched["conv_aux"] == 0
    for ref in (plain, host):
        assert [(h, ref.k, ref.special) for h, _ in ref.parts] == [
            (h, got.k, got.special) for h, _ in got.parts]
        for (_, a), (_, b) in zip(got.parts, ref.parts):
            assert torch.equal(a.cpu(), b.cpu())


BOOT_KERNELS = {"conv_aux", "basis_ext", "embed_max"}


def test_fat_recrypt_m1271_through_k3(gpu):
    """fat_recrypt at m=1271 (HElib's bgv_fatboot "tiny" size) through K3
    alone (bar the lifts and the measured noise): cold with the SecKey,
    then warm with the PubKey, which mints nothing; each decrypts to its
    input slots (full slots of GF(2^d)), is correct and gains more than 30
    bits of capacity."""
    from helib_tpu_torch.recryption import FatRecryptData, fat_recrypt
    ctx = Context(**BOOT)
    sk = SecKey(ctx, seed=131, hwt=64)
    pk = PubKey(sk)
    ea = EncryptedArray(ctx)
    rc = FatRecryptData(ctx, sk, ea, hwt=64)
    rng = np.random.default_rng(133)
    slots = [rng.integers(0, ea.pr, ea.d) for _ in range(ea.nslots)]
    low = ea.encrypt(slots, pk, rng)
    low.bring_to_k(3)
    for key in (sk, pk):
        minted = len(sk.matrices)
        out, launched = _launched(lambda: fat_recrypt(low, rc, key))
        assert launched["conv_aux"] > 0 and set(launched) <= BOOT_KERNELS
        assert key is sk or len(sk.matrices) == minted
        assert np.array_equal(sk.decrypt_bgv(out), ea.encode(slots))
        assert out.is_correct() and out.capacity() > low.capacity() + 30


BINARY = dict(m=4095, p=2, r=1, bits=500, c=2, mvec=(7, 5, 9, 13))


def test_add_two_numbers_m4095_through_k3_equals_cpu(gpu):
    """The 8-bit add_two_numbers at HElib's binary-arithmetic size m=4095
    (144 slots of GF(2^12), B = 8192) through K3 and no other kernel:
    decrypt_number gives a + b in every slot, and each bit of the sum is
    bit-identical to the port on the host CPU (keys and encryptions are
    host-seeded, so the same on both)."""
    from helib_tpu_torch.algos.binary import (add_two_numbers,
                                              decrypt_number, encrypt_number)

    def add(ctx):
        sk = SecKey(ctx, seed=151)
        pk = PubKey(sk)
        ksstrategy.add_relin_matrix(sk)
        ea = EncryptedArray(ctx)
        rng = np.random.default_rng(153)
        a, b = (rng.integers(0, 256, ea.nslots) for _ in range(2))
        ca, cb = (encrypt_number(ea, pk, rng, x, 8) for x in (a, b))
        return add_two_numbers(ea, ca, cb, pk), sk, ea, a + b

    (got, sk, ea, want), launched = _launched(lambda: add(Context(**BINARY)))
    assert launched["conv_aux"] > 0 and launched["conv"] == 0
    assert len(got) == 9
    assert np.array_equal(decrypt_number(ea, sk, got), want)
    host = add(Context(**BINARY, device="cpu"))[0]
    for x, y in zip(got, host):
        assert (x.k, x.special) == (y.k, y.special)
        for (_, a), (_, b) in zip(x.parts, y.parts):
            assert torch.equal(a.cpu(), b)


def _circuit_case(device):
    """HElib's circuit library at m=4095 with the relinearization, Frobenius
    and permutation-network matrices minted first, its inputs encrypted
    from default_rng(153); a dict of the context's objects, the plaintexts
    and their encryptions (host-seeded, so the same on every device)."""
    from helib_tpu_torch.algos import binary as B
    from helib_tpu_torch.algos import (intraslot, optimize_perms,
                                       random_matrices, tablelookup)
    from helib_tpu_torch.algos.query import Database
    ctx = Context(**BINARY, device=device)
    sk = SecKey(ctx, seed=151)
    pk = PubKey(sk)
    ea = EncryptedArray(ctx)
    pip = optimize_perms.PermIndepPrecomp(ea, 5)
    perm = np.random.default_rng(1).permutation(ea.nslots)
    pp = optimize_perms.PermPrecomp(pip, perm)
    ksstrategy.add_relin_matrix(sk)
    ksstrategy.add_frb_matrices(sk)
    ksstrategy.add_matrices_4_network(sk, pp)
    rng = np.random.default_rng(153)
    n = ea.nslots
    c = dict(ctx=ctx, sk=sk, pk=pk, ea=ea, pp=pp, perm=perm)
    c["a8"], c["b8"] = rng.integers(0, 256, n), rng.integers(0, 256, n)
    c["b8"][:4] = c["a8"][:4]
    c["a4"], c["b4"] = rng.integers(0, 16, n), rng.integers(0, 16, n)
    c["four"] = [rng.integers(0, 16, n) for _ in range(4)]
    c["idx"] = rng.integers(0, 16, n)
    cols = [rng.integers(0, 2, n) for _ in range(3)]
    qv = [int(x) for x in rng.integers(0, 2, 3)]
    c["bits"] = rng.integers(0, 2, n)
    c["full"] = [rng.integers(0, 2, ea.d) for _ in range(n)]
    for k in ("a8", "b8"):
        c["c" + k] = B.encrypt_number(ea, pk, rng, c[k], 8)
    for k in ("a4", "b4", "idx"):
        c["c" + k] = B.encrypt_number(ea, pk, rng, c[k], 4)
    c["cfour"] = [B.encrypt_number(ea, pk, rng, x, 4) for x in c["four"]]
    c["db"] = Database(ea, pk, [ea.encrypt(list(x), pk, rng) for x in cols])
    c["qc"] = {i: ea.encrypt([qv[i]] * n, pk, rng) for i in range(3)}
    c["match"] = [(x == q).astype(np.int64) for x, q in zip(cols, qv)]
    c["cbits"] = ea.encrypt(list(c["bits"]), pk, rng)
    c["cfull"] = ea.encrypt(c["full"], pk, rng)
    c["table"] = tablelookup.build_lookup_table(
        lambda i: bin(i).count("1"), 4, ea.pr)
    c["mat"], c["M"] = random_matrices.random_matmul1d(ea, 0, rng)
    c["unpack_enc"] = intraslot.build_unpack_slot_encoding(ea)
    return c


def _matmul1d_image(pal, dim: int, M, v, p: int) -> np.ndarray:
    """y[s] = sum_j M[e, j] v[s with coordinate j along dim], e the
    coordinate of s along dim (MatMul1D's get(i, j) convention)."""
    out = np.zeros(len(v), dtype=np.int64)
    for s in range(len(v)):
        cs = list(pal.coords(s))
        e = cs[dim]
        for j in range(pal.orders[dim]):
            cs[dim] = j
            out[s] += int(M[e, j]) * int(v[pal.slot_index(tuple(cs))])
    return out % p


def _circuits():
    """name -> (the circuit on a _circuit_case, its decrypt, its image in
    the plaintexts)."""
    from helib_tpu_torch.algos import binary as B
    from helib_tpu_torch.algos import intraslot, tablelookup

    def ints(c, out):
        cts = out if isinstance(out, list) else [out]
        return np.stack([c["ea"].decrypt_ints(x, c["sk"]) for x in cts])

    def number(c, out):
        return B.decrypt_number(c["ea"], c["sk"], out)

    def repacked(c, out):
        unpacked = np.stack([c["ea"].decrypt_ints(x, c["sk"]) for x in out],
                            1)
        back = c["sk"].decrypt_bgv(intraslot.repack(c["ea"], out))
        return np.concatenate([unpacked.ravel(), back.ravel()])
    return {
        "compare": (lambda c: list(B.compare_two_numbers(
            c["ea"], c["ca8"], c["cb8"], c["pk"])), ints,
            lambda c: np.stack([c["a8"] > c["b8"], c["a8"] == c["b8"]])),
        "table_lookup": (lambda c: tablelookup.table_lookup(
            c["ea"], c["cidx"], c["table"], c["pk"]), ints,
            lambda c: np.array(c["table"])[c["idx"]][None]),
        "permutation": (lambda c: c["pp"].apply(c["cbits"], c["pk"]), ints,
                        lambda c: c["bits"][c["perm"]][None]),
        "mult_two_numbers": (lambda c: B.mult_two_numbers(
            c["ea"], c["ca4"], c["cb4"], c["pk"]), number,
            lambda c: c["a4"] * c["b4"]),
        "add_many_numbers": (lambda c: B.add_many_numbers(
            c["ea"], c["cfour"], c["pk"]), number, lambda c: sum(c["four"])),
        "contains 0 AND 1": (lambda c: c["db"].contains("0 AND 1", c["qc"]),
                             ints,
                             lambda c: (c["match"][0] & c["match"][1])[None]),
        "contains 0 OR NOT 1": (
            lambda c: c["db"].contains("0 OR NOT 1", c["qc"]), ints,
            lambda c: (c["match"][0] | (1 - c["match"][1]))[None]),
        "contains (0 AND 1) OR 2": (
            lambda c: c["db"].contains("(0 AND 1) OR 2", c["qc"]), ints,
            lambda c: ((c["match"][0] & c["match"][1]) | c["match"][2])[None]),
        "unpack_repack": (lambda c: intraslot.unpack(
            c["ea"], c["cfull"], c["pk"], c["unpack_enc"]), repacked,
            lambda c: np.concatenate([np.array(c["full"]).ravel(),
                                      c["ea"].encode(c["full"]).ravel()])),
        "random_matmul1d": (lambda c: c["mat"].apply(c["cbits"], c["pk"]),
                            ints, lambda c: _matmul1d_image(
                                c["ctx"].pal, 0, c["M"], c["bits"],
                                c["ea"].pr)[None])}


def _same_ctxts(got, host):
    for x, y in zip(got if isinstance(got, list) else [got],
                    host if isinstance(host, list) else [host]):
        assert (x.k, x.special) == (y.k, y.special)
        for (_, a), (_, b) in zip(x.parts, y.parts):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("name", list(_circuits()))
def test_circuit_m4095_through_k3_decrypts_to_numpy(gpu, name):
    """HElib's circuit library at m=4095 with the PubKey, every matrix
    minted first: each circuit through K3 alone (bar the lifts and the
    measured noise) decrypts to numpy in all 144 slots and mints nothing;
    the compare, the table lookup and the optimized permutation network
    (depth 5) are bit-identical to the port on the host."""
    f, dec, image = _circuits()[name]
    c = _setup("circuits", lambda: _circuit_case("cuda"))
    minted = len(c["sk"].matrices)
    out, launched = _launched(lambda: f(c))
    assert launched["conv_aux"] > 0 and set(launched) <= BOOT_KERNELS
    assert len(c["sk"].matrices) == minted
    assert np.array_equal(dec(c, out), image(c))
    if name in ("compare", "table_lookup", "permutation"):
        saved = torch.get_num_threads()
        torch.set_num_threads(os.cpu_count() or 1)   # minutes on one thread
        try:
            host = f(_setup("circuits_cpu", lambda: _circuit_case("cpu")))
        finally:
            torch.set_num_threads(saved)
        _same_ctxts(out, host)


BIG_BOOT = dict(m=35113, p=2, r=1, bits=600, c=3, mvec=(37, 949))


def _only_staged(launched) -> bool:
    """Transforms ran staged and no transform kernel launched."""
    return launched["staged"] > 0 and not any(
        launched[k] for k in ("conv_aux", "conv", "ntt"))


@pytest.mark.parametrize("which", ["mult", "automorph"])
def test_m35113_on_staged_transforms_equals_cpu_port(gpu, which):
    """HElib's big bootstrapping size at small bits (B = 131072, above the
    kernels): mult+relin and an automorphism with its key switch run the
    staged transforms and launch no kernel, bit-identical to the port on
    the CPU."""
    params = {**BIG_BOOT, "bits": 120}
    make = make_mult_relin if which == "mult" else make_automorph_relin
    ctx, ctx_cpu = Context(**params), Context(**params, device="cpu")
    fn, args = make(ctx, SecKey(ctx, seed=141, hwt=64))
    fn_cpu, _ = make(ctx_cpu, SecKey(ctx_cpu, seed=141, hwt=64))
    got, launched = _launched(lambda: fn(*args))
    assert _only_staged(launched)
    want = fn_cpu(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


def test_ckks_m262144_mult_relin_on_staged_transforms_equals_cpu_port(gpu):
    """m=262144 (n = 131072, above K2's 4-CTA clusters): every transform
    staged, no kernel launched, bit-identical to the port on the CPU."""
    params = dict(m=262144, p=-1, r=30, bits=240, c=3, scheme="ckks")
    ctx, ctx_cpu = Context(**params), Context(**params, device="cpu")
    fn, args = make_mult_relin(ctx, SecKey(ctx, seed=2))
    fn_cpu, _ = make_mult_relin(ctx_cpu, SecKey(ctx_cpu, seed=2))
    got, launched = _launched(lambda: fn(*args))
    assert _only_staged(launched) and launched["staged"] == 8
    want = fn_cpu(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


def test_cli_round_trip_m4095_on_gpu(gpu, tmp_path, capsys):
    """create-context / key-gen / encrypt / decrypt on the card (the
    default device) at m=4095, bits=500, c=2: 144 values back unchanged."""
    from helib_tpu_torch import cli
    d = tmp_path
    cli.main(["create-context", "m=4095", "p=2", "r=1", "bits=500", "c=2",
              f"out={d / 'ctx.bin'}"])
    cli.main(["key-gen", f"ctx={d / 'ctx.bin'}", f"out={d / 'key'}"])
    vals = np.random.default_rng(171).integers(0, 2, 144)
    np.savetxt(d / "data.txt", vals, fmt="%d")
    _, launched = _launched(lambda: (
        cli.main(["encrypt", f"ctx={d / 'ctx.bin'}", f"key={d / 'key.pk'}",
                  f"in={d / 'data.txt'}", f"out={d / 'ct.bin'}"]),
        cli.main(["decrypt", f"ctx={d / 'ctx.bin'}", f"key={d / 'key.sk'}",
                  f"in={d / 'ct.bin'}", f"out={d / 'out.txt'}"])))
    assert launched["conv_aux"] > 0
    got = np.loadtxt(d / "out.txt", dtype=np.int64, ndmin=1)
    np.testing.assert_array_equal(got, vals)
    assert "encrypted 144 values" in capsys.readouterr().out


MATMUL = dict(m=1024, p=-1, r=30, bits=360, c=3, scheme="ckks")


def _matmul_case(device):
    """MatMulCKKS of a dense M in [-1, 1] on 256 slots (BSGS, g = 16), its
    rotation matrices minted first, and z in [-1, 1] encrypted, from
    default_rng(163)."""
    import math
    from helib_tpu_torch.algos.matmul_ckks import MatMulCKKS
    from helib_tpu_torch.ckks import EncryptedArrayCKKS
    from helib_tpu_torch.keys import SKHandle
    from helib_tpu_torch.nt.numbth import inv_mod
    ctx = Context(**MATMUL, device=device)
    sk = SecKey(ctx, seed=161)
    pk = PubKey(sk)
    ea = EncryptedArrayCKKS(ctx)
    n = ea.nslots
    g = math.isqrt(n)
    inv5 = inv_mod(5, ctx.m)
    for amt in list(range(1, g)) + list(range(g, n, g)):
        sk.gen_ks_matrix(SKHandle(1, pow(inv5, amt, ctx.m), 0))
    rng = np.random.default_rng(163)
    M = rng.uniform(-1, 1, (n, n))
    z = rng.uniform(-1, 1, n)
    ct = ea.encrypt(z, pk, rng)
    mm = MatMulCKKS(ea, lambda i, j: M[i, j])
    return sk, ea, M @ z, lambda: mm.apply(ct, pk, bsgs=True)


def test_matmul_ckks_bsgs_on_gpu_equals_cpu_port(gpu):
    """MatMulCKKS with baby-step/giant-step at m=1024 through K2 alone (bar
    the lifts), minting nothing: within 4 x error_bound() of M z (and
    within 1e-2 without the decrypt's mitigation noise), bit-identical to
    the port on the host."""
    sk, ea, want, apply = _matmul_case("cuda")
    minted = len(sk.matrices)
    out, launched = _launched(apply)
    assert launched["ntt"] > 0 and set(launched) <= {"ntt", "basis_ext"}
    assert len(sk.matrices) == minted
    assert np.max(np.abs(ea.decrypt(out, sk) - want)) <= 4 * out.error_bound()
    assert np.max(np.abs(ea.raw_decrypt(out, sk) - want)) <= 1e-2
    host = _matmul_case("cpu")[-1]()
    assert (out.k, out.ratFactor) == (host.k, host.ratFactor)
    for (_, a), (_, b) in zip(out.parts, host.parts):
        assert torch.equal(a.cpu(), b)


def test_fhe_stats_on_gpu(gpu):
    """fhe_stats on the card: a BGV mult+relin at m=4095 updates the
    break-into-digits and KS-noise ratios, four CKKS encodes the encode
    ratio; each is counted and at most 1 (at m=31 the KS-noise ratio, a
    ratio of two estimates, is 1.6 in both packages)."""
    from helib_tpu_torch import timing
    from helib_tpu_torch.ckks import EncryptedArrayCKKS
    ctx = Context(**BINARY)
    sk = SecKey(ctx, seed=151)
    pk = PubKey(sk)
    ksstrategy.add_relin_matrix(sk)
    ea = EncryptedArray(ctx)
    rng = np.random.default_rng(153)
    a, b = (ea.encrypt(list(rng.integers(0, 2, ea.nslots)), pk, rng)
            for _ in range(2))
    eac = EncryptedArrayCKKS(Context(**CKKS_ROT))
    timing.reset_stats()
    timing.fhe_stats = True
    try:
        a.multiply(b, pk)
        for _ in range(4):
            eac.encode(rng.normal(size=eac.nslots)
                       + 1j * rng.normal(size=eac.nslots))
        stats = {k: timing._stats.get(k) for k in (
            "break-into-digits-ratio", "KS-noise-ratio", "CKKS_encode_ratio")}
    finally:
        timing.fhe_stats = False
        timing.reset_stats()
    for name, st in stats.items():
        assert st is not None and st.count and st.max <= 1.0, (name, st)


def test_export_helib_binary_on_gpu_equals_host(gpu, tmp_path):
    """export_helib_binary of a context, SecKey, PubKey (with its
    relinearization matrix) and a ciphertext made on the card gives the
    bytes of the same export made on the host (keys and encryption are
    host-seeded, so the same on both), and reads back."""
    from helib_tpu_torch import io_helib_bin
    from helib_tpu_torch.keys import SKHandle

    def export(device):
        ctx = Context(m=31, p=2, r=1, bits=120, c=2, device=device)
        sk = SecKey(ctx, seed=17)
        pk = PubKey(sk)
        sk.gen_ks_matrix(SKHandle(2, 1, 0))
        ea = EncryptedArray(ctx)
        rng = np.random.default_rng(19)
        ct = ea.encrypt(list(rng.integers(0, 2, ea.nslots)), pk, rng)
        path = tmp_path / f"{device}.bin"
        io_helib_bin.export_helib_binary(str(path), ctx, sk=sk, pk=pk,
                                         ctxts=[ct])
        return ctx, path
    ctx, card = export("cuda")
    assert card.read_bytes() == export("cpu")[1].read_bytes()
    d = io_helib_bin.read_binary_dump(str(card))
    assert (d.m, d.p, d.r) == (ctx.m, ctx.p, ctx.r)
    assert [k.handle for k in d.ks_matrices] == [(2, 1, 0)]
    assert d.primes == [int(q) for q in ctx.all_q]


def test_noise_of_and_check_noise_on_gpu(gpu):
    """SecKey.noise_of and debugging.check_noise on the card, on a fresh
    encryption and on a mult+relin: the measured noise is the port's on
    the host, check_noise holds and the estimate is within 40 bits."""
    from helib_tpu_torch import debugging

    def measured(device):
        ctx = Context(m=31, p=2, r=1, bits=500, c=3, device=device)
        sk = SecKey(ctx, seed=7)
        pk = PubKey(sk)
        rng = np.random.default_rng(2)
        ct = pk.encrypt_bgv(rng.integers(0, 2, ctx.phi_m), rng)
        return sk, [ct, ct.multiply(ct, sk)]
    sk, cts = measured("cuda")
    sk_h, cts_h = measured("cpu")
    debugging.setup_debug_globals(sk)
    try:
        for ct, host in zip(cts, cts_h):
            actual = sk.noise_of(ct)
            assert abs(actual - sk_h.noise_of(host)) <= 1e-9
            assert debugging.check_noise(ct, "on the card")
            assert ct.noise - actual < 40
    finally:
        debugging.setup_debug_globals(None)


@pytest.mark.cuda_long
def test_thin_recrypt_m35113_on_staged_transforms(gpu):
    """thin_recrypt at HElib's big bootstrapping size (m=35113, mvec=(37,
    949), bits=600, hwt=64: 864 slots of GF(2^36), B = 131072) on the
    card: every transform staged, no kernel launched, the result correct
    and decrypting to its input slots.  Setup and the bootstrap take
    minutes (PERF.md)."""
    import time
    from helib_tpu_torch.recryption import RecryptData, thin_recrypt

    t0 = time.time()
    ctx = Context(**BIG_BOOT)
    sk = SecKey(ctx, seed=141, hwt=64)
    PubKey(sk)
    ea = EncryptedArray(ctx)
    rc = RecryptData(ctx, sk, ea, hwt=64)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    rng = np.random.default_rng(143)
    slots = [int(v) for v in rng.integers(0, 2, ea.nslots)]
    low = ea.encrypt(slots, sk.pubkey, rng)
    low.bring_to_k(3)
    t0 = time.time()
    out, launched = _launched(lambda: thin_recrypt(low, rc, sk))
    boot_s = time.time() - t0
    print(f"thin bootstrap m=35113: setup {setup_s:.1f} s, cold "
          f"{boot_s:.1f} s, {launched['staged']} staged transforms, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GB")
    assert _only_staged(launched)
    assert out.is_correct() and out.capacity() > low.capacity() + 30
    assert np.array_equal(sk.decrypt_bgv(out), ea.encode(slots))


@pytest.mark.cuda_long
def test_thin_recrypt_m31775_through_k3(gpu):
    """thin_recrypt at HElib's small thin-bootstrapping size (m=31775,
    mvec=(31, 25, 41), bits=600, hwt=64: 1200 slots, B = 65536, K3 on its
    4-CTA clusters) through K3 alone (bar the lifts and the measured
    noise): correct, decrypting to its input slots, more than 30 bits of
    capacity gained, and a multiply after it decrypts to the slots'
    squares; then warm with the PubKey alone, minting nothing."""
    from helib_tpu_torch.recryption import RecryptData, thin_recrypt
    ctx = Context(m=31775, p=2, r=1, bits=600, c=3, mvec=(31, 25, 41))
    sk = SecKey(ctx, seed=141, hwt=64)
    pk = PubKey(sk)
    ea = EncryptedArray(ctx)
    rc = RecryptData(ctx, sk, ea, hwt=64)
    rng = np.random.default_rng(143)
    slots = [int(v) for v in rng.integers(0, ea.pr, ea.nslots)]
    low = ea.encrypt(slots, pk, rng)
    low.bring_to_k(3)
    out, launched = _launched(lambda: thin_recrypt(low, rc, sk))
    assert launched["conv_aux"] > 0 and set(launched) <= BOOT_KERNELS
    assert np.array_equal(sk.decrypt_bgv(out), ea.encode(slots))
    assert out.is_correct() and out.capacity() > low.capacity() + 30
    sq = out.multiply(out, sk)
    assert np.array_equal(sk.decrypt_bgv(sq),
                          ea.encode([v * v % ea.pr for v in slots]))
    minted = len(sk.matrices)
    warm, launched = _launched(lambda: thin_recrypt(low, rc, pk))
    assert set(launched) <= BOOT_KERNELS and len(sk.matrices) == minted
    assert np.array_equal(sk.decrypt_bgv(warm), ea.encode(slots))
    assert warm.is_correct() and warm.capacity() > low.capacity() + 30


# ---------------------------------------------------------------------------
# the example twins and the parallel layer
# ---------------------------------------------------------------------------

TWINS = sorted(p for p in (__import__("pathlib").Path(__file__).resolve()
                           .parents[1] / "helib_tpu_torch" / "examples")
               .glob("*.py"))


@pytest.mark.parametrize("path", TWINS, ids=lambda p: p.stem)
def test_example_twin_on_gpu(gpu, path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"twin_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(device="cuda")


def _m45_two_ranks():
    """Each gloo rank on the card: the m=45 sharded mult+relin on (1, 2)
    and (2, 1) meshes and the sharded rotate, gathered."""
    from helib_tpu_torch.parallel import mesh as pmesh
    from helib_tpu_torch.parallel.distributed import rank_device
    dev = rank_device("cuda")
    ctx = Context(m=45, p=2, r=1, bits=118, c=3, device=dev)
    sk = SecKey(ctx, seed=1)
    out = {}
    for batch_axis in (1, 2):
        m = pmesh.make_mesh(2, batch_axis)
        fn, ex = pmesh.sharded_mult_relin(ctx, sk, m, 2)
        out[batch_axis] = [m.gather(o).cpu() for o in fn(*ex)]
    m = pmesh.make_mesh(2, 1)
    rfn, rex = pmesh.sharded_automorph_relin(ctx, sk, m, 2)
    out["rotate"] = [m.gather(o).cpu() for o in rfn(*rex)]
    return out


def test_two_rank_sharded_m45_on_gpu(gpu):
    """Two gloo ranks sharing the card: gathered results equal the
    unsharded port on the card."""
    from helib_tpu_torch.parallel.distributed import launch
    ranks = launch(_m45_two_ranks, 2, backend="gloo", timeout=600)
    ctx = Context(m=45, p=2, r=1, bits=118, c=3)
    sk = SecKey(ctx, seed=1)
    fn, ex = make_batched_mult_relin(ctx, sk, 2)
    want = [w.cpu() for w in fn(*ex)]
    rfn, rex = make_automorph_relin(ctx, sk)
    rwant = [w.cpu() for w in rfn(*rex)]
    for res in ranks:
        for b in (1, 2):
            assert all(torch.equal(g, w) for g, w in zip(res[b], want))
        for g, w in zip(res["rotate"], rwant):
            assert torch.equal(g, w.expand_as(g))


def _m45_one_nccl_rank():
    """One NCCL rank on the card: the m=45 sharded mult+relin on a (1, 1)
    mesh, gathered by one NCCL all_gather."""
    import torch.distributed as dist
    from helib_tpu_torch.parallel import mesh as pmesh
    from helib_tpu_torch.parallel.distributed import rank_device
    ctx = Context(m=45, p=2, r=1, bits=118, c=3, device=rank_device("cuda"))
    m = pmesh.make_mesh(1)
    fn, ex = pmesh.sharded_mult_relin(ctx, SecKey(ctx, seed=1), m, 2)
    return dist.get_backend(), [m.gather(o).cpu() for o in fn(*ex)]


def test_one_nccl_rank_sharded_m45_on_gpu(gpu):
    """A one-rank NCCL group: the gathered result equals the unsharded port
    on the card."""
    from helib_tpu_torch.parallel.distributed import launch
    ((backend, got),) = launch(_m45_one_nccl_rank, 1, backend="nccl",
                               timeout=600)
    assert backend == "nccl"
    ctx = Context(m=45, p=2, r=1, bits=118, c=3)
    fn, ex = make_batched_mult_relin(ctx, SecKey(ctx, seed=1), 2)
    assert all(torch.equal(g, w.cpu()) for g, w in zip(got, fn(*ex)))


BIG = dict(m=32003, p=2, r=1, bits=5800, c=3)


def _m32003_limb_ranks():
    """Each gloo rank on the card: HElib's bgv_basic "big" size on a
    (batch=1, limb=2) mesh (97 of the 194 ciphertext rows a rank), the
    sharded mult+relin and rotate at batch 2, gathered, with the launches
    each counted on its rank."""
    from helib_tpu_torch.parallel import mesh as pmesh
    from helib_tpu_torch.parallel.distributed import rank_device
    ctx = Context(**BIG, device=rank_device("cuda"))
    sk = SecKey(ctx, seed=2)
    m = pmesh.make_mesh(2, 1)
    out = {}
    for name, make in (("mult", pmesh.sharded_mult_relin),
                       ("rotate", pmesh.sharded_automorph_relin)):
        fn, ex = make(ctx, sk, m, 2)
        got, launched = _launched(lambda: fn(*ex))
        out[name] = ([m.gather(o).cpu() for o in got], launched)
    return out


@pytest.mark.cuda_long
def test_two_rank_limb_sharded_m32003_through_k3(gpu):
    """Two gloo ranks sharing the card split m=32003's rows: each launches
    K3 on its 4-CTA clusters and no other transform kernel, and the
    gathered mult+relin and rotate equal the unsharded port on the card."""
    from helib_tpu_torch.parallel.distributed import launch
    ranks = launch(_m32003_limb_ranks, 2, backend="gloo", timeout=1800)
    ctx = Context(**BIG)
    sk = SecKey(ctx, seed=2)
    fn, ex = make_batched_mult_relin(ctx, sk, 2)
    want = {"mult": [w.cpu() for w in fn(*ex)]}
    rfn, rex = make_automorph_relin(ctx, sk)
    want["rotate"] = [w.cpu() for w in rfn(*rex)]
    for res in ranks:
        for name, (got, launched) in res.items():
            assert launched["conv_aux"] > 0
            assert set(launched) <= {"conv_aux", "basis_ext"}
            for g, w in zip(got, want[name]):
                assert torch.equal(g, w.expand_as(g))


@pytest.mark.cuda_long
def test_dryrun_multichip_two_ranks_on_gpu(gpu):
    """entry.dryrun_multichip in full on two gloo ranks sharing the card."""
    from helib_tpu_torch.entry import dryrun_multichip
    from helib_tpu_torch.parallel.distributed import launch
    launch(dryrun_multichip, 2, 2, "cuda", backend="gloo", timeout=3000)


# ---------------------------------------------------------------------------
# compiled dispatch: the jit sites as CUDA graphs (jitutil)
# ---------------------------------------------------------------------------

GRAPH_SIZES = {
    "m31": dict(m=31, p=2, r=1, bits=300, c=3),
    "m1271": dict(m=1271, p=2, r=1, bits=120, c=3),
    "m8009": dict(m=8009, p=2, r=1, bits=380, c=3),
    "ckks1024": dict(m=1024, p=-1, r=35, bits=300, c=3, scheme="ckks"),
}
SITES = ["fwd", "inv", "digits", "scale_down", "decrypt", "pipeline"]
_GRAPH_SETUPS: dict = {}


def _graph_setup(size):
    """(ctx, sk) of a size on the card, built once for the module."""
    if size not in _GRAPH_SETUPS:
        ctx = Context(**GRAPH_SIZES[size])
        sk = SecKey(ctx, seed=3)
        PubKey(sk)
        _GRAPH_SETUPS[size] = (ctx, sk)
    return _GRAPH_SETUPS[size]


def _site(size, name):
    """(call, inputs): a call of the named jit site and `inputs(seed)`, the
    tensors it takes, uniform residues from default_rng(seed)."""
    from helib_tpu_torch.ctxt import Ctxt
    from helib_tpu_torch.dcrt import rt_break_into_digits, rt_scale_down
    from helib_tpu_torch.jitutil import lifted_jit
    from helib_tpu_torch.keys import SKHandle
    ctx, sk = _graph_setup(size)
    L, S = ctx.L, ctx.S
    pr = ctx.ptxt_space if ctx.scheme == "bgv" else 1

    def parts(k, special, count):
        qs = ctx.primes_of(k, special).astype(np.int64)

        def make(seed):
            rng = np.random.default_rng(seed)
            return tuple(to_device(rng.integers(0, qs[:, None], (
                len(qs), ctx.n_eval)).astype(np.uint32), ctx.device)
                for _ in range(count))
        return make
    rows = ctx.rows_of(L, False)
    if name in ("fwd", "inv"):
        f = ctx.fwd_ntt if name == "fwd" else ctx.inv_ntt
        return (lambda x: f(x, rows)), parts(L, False, 1)
    if name == "digits":
        return (lambda x: rt_break_into_digits(ctx, x, L)[0]), \
            parts(L, False, 1)
    if name == "scale_down":
        return (lambda x: rt_scale_down(ctx, x, L, True, L, False, pr,
                                        want_frac=True)), parts(L, True, 1)
    if name == "decrypt":
        def dec(a, b):
            ct = Ctxt(ctx, sk.pubkey, [(SKHandle(0, 1, 0), a),
                                       (SKHandle(1, 1, 0), b)],
                      L, False, pr, 0.0, 1)
            return sk._inner_product_residues(ct)[0]
        return dec, parts(L, False, 2)
    fn, args = make_mult_relin(ctx, sk)
    return lifted_jit(fn, *args), parts(L, False, 4)


def _host(out):
    """The outputs as host numpy arrays, in order."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _host(o)]
    return [out.cpu().numpy() if isinstance(out, torch.Tensor) else out]


def _same(a, b):
    a, b = _host(a), _host(b)
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _tensors(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return [out] if isinstance(out, torch.Tensor) else []


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("size", list(GRAPH_SIZES))
def test_graphed_site_equals_eager(gpu, size, site):
    """Each jit site on the card: its first call (warm-up and capture) and
    its replays equal the same call under disable_jit(), also after the
    inputs change; successive calls return fresh tensors; N replays add
    the launch counts of N eager calls."""
    from helib_tpu_torch import jitutil
    call, inputs = _site(size, site)
    x1, x2 = inputs(1), inputs(2)
    with jitutil.disable_jit():
        e1, e2 = call(*x1), call(*x2)
    caps = jitutil.captures
    first = call(*x1)
    assert jitutil.captures > caps
    replays = jitutil.replays
    g1, g2, g1b = call(*x1), call(*x2), call(*x1)
    assert jitutil.replays > replays
    assert _same(first, e1) and _same(g1, e1) and _same(g2, e2)
    assert _same(g1b, e1) and not _same(e1, e2)
    ptrs = {t.data_ptr() for t in _tensors(g1)}
    assert ptrs.isdisjoint(t.data_ptr() for t in _tensors(g1b))
    c0 = launch_counts.copy()
    with jitutil.disable_jit():
        for _ in range(3):
            call(*x1)
    c1 = launch_counts.copy()
    for _ in range(3):
        call(*x1)
    torch.cuda.synchronize()
    assert c1 - c0 == launch_counts - c1 and c1 - c0


@pytest.mark.parametrize("size", list(GRAPH_SIZES))
def test_site_nested_in_a_capture_runs_its_body(gpu, size):
    """Inside another run's capture, and inside a capture of the caller's
    own, a site runs its body: the outer graph holds its kernels."""
    from helib_tpu_torch import jitutil
    call, inputs = _site(size, "digits")
    x = inputs(5)
    with jitutil.disable_jit():
        want = call(*x)
    call(*x)
    replays, caps = jitutil.replays, jitutil.captures
    outer = jitutil.lifted_jit(lambda v: call(v), *x)
    got = outer(*x)
    assert (jitutil.replays, jitutil.captures) == (replays, caps + 1)
    assert _same(got, want) and _same(outer(*x), want)
    assert jitutil.replays == replays + 1
    static = x[0].clone()
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    # cyclic garbage collection held off, as jitutil's own captures do: a
    # graph collected from an earlier test would end this capture
    with torch.cuda.stream(side), jitutil._no_gc():
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            held = call(static)
    torch.cuda.current_stream().wait_stream(side)
    static.copy_(x[0])
    g.replay()
    assert _same(held, want)


@pytest.mark.parametrize("size", list(GRAPH_SIZES))
def test_capture_error_raises(gpu, size):
    """A function that reads the device from the host cannot be captured:
    the run raises, on every call, and leaves the counts as they were; a
    capture after it works."""
    from helib_tpu_torch import jitutil
    call, inputs = _site(size, "fwd")
    x = inputs(7)

    def host_read(v):
        out = call(v)
        return out + int(out[0, 0])
    run = jitutil.lifted_jit(host_read, *x)
    for _ in range(2):
        before = launch_counts.copy()
        with pytest.raises(RuntimeError):
            run(*x)
        after = launch_counts.copy()
        # the warm-up ran (and is counted); the capture added nothing
        with jitutil.disable_jit():
            host_read(*x)
        assert after - before == launch_counts - after
    assert run.captures == 0
    assert _same(call(*x), call(*x))
    # and the next capture works
    ok = jitutil.lifted_jit(lambda v: call(v), *x)
    assert _same(ok(*x), ok(*x)) and ok.captures == 1


def test_capture_after_every_graph_is_gone(gpu):
    """The shared pool outlives the graphs in it: a context captured,
    dropped with all its graphs, and a new one captured again."""
    import gc
    from helib_tpu_torch import jitutil
    for seed in (11, 12):
        ctx = Context(**GRAPH_SIZES["m31"])
        qs = ctx.primes_of(ctx.L, False).astype(np.int64)
        x = to_device(np.random.default_rng(seed).integers(
            0, qs[:, None], (ctx.L, ctx.n_eval)).astype(np.uint32), gpu)
        rows = ctx.rows_of(ctx.L, False)
        caps = jitutil.captures
        first, again = ctx.fwd_ntt(x, rows), ctx.fwd_ntt(x, rows)
        assert jitutil.captures == caps + 1 and torch.equal(first, again)
        del ctx, first, again
        gc.collect()
