"""The port's CUDA kernels (K1 conv, K2 ntt, K3 conv_aux, K4 ntt2, K5
conv2, the probes P1 and P2) and its BGV and CKKS paths (CKKS at m=1024
and m=131072), the BGV slot layer and the thin bootstrap at m=1271 on the
card, against the plain torch versions and the port on the CPU.

Every test needs an NVIDIA GPU and skips without one.  The file imports no
JAX, so it also runs where only PyTorch is installed (the conftest, which
imports JAX, is left out):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider \
        tests/test_torch_cuda.py -q
"""

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
from helib_tpu_torch.ops.conv import (AUX_MAX_LOG_N, conv, conv_cuda,
                                      conv_plain, conv_aux, conv_aux_cuda,
                                      conv_aux_plain, launch_rows)
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
    before = conv_cuda.launches
    got = conv(*args)
    torch.cuda.synchronize()
    assert conv_cuda.launches == before + 1
    assert torch.equal(got, conv_plain(*args))


@pytest.mark.parametrize("n", [48, 4, 65536])
def test_conv_kernel_refuses_unsupported_lengths(gpu, n):
    x = torch.zeros((1, 3, 2, n), dtype=torch.int32, device=gpu)
    before = conv_cuda.launches
    with pytest.raises(ValueError, match="power of two"):
        conv_cuda(x, {}, None, None)
    assert conv_cuda.launches == before


@pytest.mark.parametrize("n", [8, 64, 2048, 16384, 32768])
def test_conv_kernel_equals_conv2_at_k3(gpu, n):
    """K1 and K5 at k = 3 run the same schedule: equal bit for bit."""
    args = _conv_args(n, 7, seed=n + 11, dev=gpu, lead=(3,))
    got = conv_cuda(*args)
    assert torch.equal(got, ntt2.conv2_cuda(*args, 3))
    assert torch.equal(got, conv_plain(*args))


def test_batched_mult_relin_on_gpu_equals_cpu_port(gpu):
    """m=31 (B = 64): its transforms go aux-major through K3, not K1."""
    params = dict(m=31, p=2, r=1, bits=300, c=3)
    ctx, ctx_cpu = Context(**params), Context(**params, device="cpu")
    assert ctx.device.type == "cuda"
    fn, args = make_batched_mult_relin(ctx, SecKey(ctx, seed=3), 2)
    fn_cpu, _ = make_batched_mult_relin(ctx_cpu, SecKey(ctx_cpu, seed=3), 2)
    before = (conv_aux_cuda.launches, conv_cuda.launches)
    got = fn(*args)
    torch.cuda.synchronize()
    assert conv_aux_cuda.launches - before[0] == 8
    assert conv_cuda.launches == before[1]
    want = fn_cpu(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("P,lead", SHAPES)
@pytest.mark.parametrize("n", [256, 4096, 32768, 65536])
def test_conv_aux_kernel_matches_plain_on_gpu(gpu, n, P, lead):
    """Aux-major [3, *lead, P, n]; n = 65536 runs a cluster per row."""
    x, aux, kh, khsh = _conv_args(n, P, seed=n + P + 1, dev=gpu, lead=lead)
    x = x.movedim(len(lead), 0).contiguous()
    before = conv_aux_cuda.launches
    got = conv_aux(x, aux, kh, khsh)
    torch.cuda.synchronize()
    assert conv_aux_cuda.launches == before + 1
    assert torch.equal(got, conv_aux_plain(x, aux, kh, khsh))


@pytest.mark.parametrize("P,lead", SHAPES)
def test_conv_aux_c2_entry_matches_plain_on_gpu(gpu, P, lead):
    """conv_aux.cu's second entry: n = 65536 on 2-CTA clusters; any other
    n is an invalid value."""
    x, aux, kh, khsh = _conv_args(65536, P, seed=P + 3, dev=gpu, lead=lead)
    x = x.movedim(len(lead), 0).contiguous()
    got = launch_rows("conv_aux", x, aux, kh, khsh, AUX_MAX_LOG_N,
                      entry="launch_c2")
    assert torch.equal(got, conv_aux_plain(x, aux, kh, khsh))
    args = _conv_args(32768, P, seed=P, dev=gpu)
    with pytest.raises(RuntimeError, match="invalid"):
        launch_rows("conv_aux", args[0].movedim(1, 0).contiguous(),
                    *args[1:], AUX_MAX_LOG_N, entry="launch_c2")


@pytest.mark.parametrize("n", [48, 4, 131072])
def test_conv_aux_kernel_refuses_unsupported_lengths(gpu, n):
    x = torch.zeros((3, 2, n), dtype=torch.int32, device=gpu)
    before = conv_aux_cuda.launches
    with pytest.raises(ValueError, match="power of two"):
        conv_aux_cuda(x, {}, None, None)
    assert conv_aux_cuda.launches == before


def test_rotate_m1271_on_gpu_equals_cpu_port(gpu):
    """The per-op rotate at m=1271 (B = 4096, K3) against the port on the
    host."""
    params = dict(m=1271, p=2, r=1, bits=120, c=3)
    ctx, ctx_cpu = Context(**params), Context(**params, device="cpu")
    fn, args = make_automorph_relin(ctx, SecKey(ctx, seed=4))
    fn_cpu, _ = make_automorph_relin(ctx_cpu, SecKey(ctx_cpu, seed=4))
    before = (conv_aux_cuda.launches, conv_cuda.launches)
    got = fn(*args)
    torch.cuda.synchronize()
    assert conv_aux_cuda.launches - before[0] == 8
    assert conv_cuda.launches == before[1]
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
    before = ntt_fused.ntt_cuda.launches
    fwd = ntt_fused.ntt(x, t, inverse=False)
    inv = ntt_fused.ntt(fwd, t, inverse=True)
    torch.cuda.synchronize()
    assert ntt_fused.ntt_cuda.launches == before + 2
    assert torch.equal(fwd, ntt_fused.ntt_plain(x, t, inverse=False))
    assert torch.equal(inv, ntt_fused.ntt_plain(fwd, t, inverse=True))
    assert torch.equal(inv, x)


@pytest.mark.parametrize("n", [48, 4, 131072])
def test_ntt_kernel_refuses_unsupported_lengths(gpu, n):
    x = torch.zeros((1, 2, n), dtype=torch.int32, device=gpu)
    before = ntt_fused.ntt_cuda.launches
    with pytest.raises(ValueError, match="power of two"):
        ntt_fused.ntt_cuda(x, {}, None, inverse=False)
    assert ntt_fused.ntt_cuda.launches == before


def test_ckks_batched_mult_relin_on_gpu_equals_cpu_port(gpu):
    params = dict(m=1024, p=-1, r=35, bits=300, c=3, scheme="ckks")
    ctx, ctx_cpu = Context(**params), Context(**params, device="cpu")
    fn, args = make_batched_mult_relin(ctx, SecKey(ctx, seed=2), 2)
    fn_cpu, _ = make_batched_mult_relin(ctx_cpu, SecKey(ctx_cpu, seed=2), 2)
    before = (ntt_fused.ntt_cuda.launches, conv_cuda.launches)
    got = fn(*args)
    torch.cuda.synchronize()
    assert ntt_fused.ntt_cuda.launches - before[0] == 8
    assert conv_cuda.launches == before[1]
    want = fn_cpu(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


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
        before = ntt2.ntt2_cuda.launches
        got_f = ntt2.ntt2_cuda(x, t["flat"], t["q"], False, k)
        got_i = ntt2.ntt2_cuda(x, t["flat"], t["q"], True, k)
        torch.cuda.synchronize()
        assert ntt2.ntt2_cuda.launches == before + 2
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
    before = ntt_fused.ntt_cuda.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert ntt_fused.ntt_cuda.launches - before == 8
    want = fn_cpu(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [8, 64, 2048, 16384, 32768])
def test_conv2_kernel_matches_plain_at_every_k(gpu, n):
    args = _conv_args(n, 5, seed=n + 3, dev=gpu)
    ref = conv_plain(*args)
    for k in range(1, ntt2.K_MAX + 1):
        before = ntt2.conv2_cuda.launches
        got = ntt2.conv2_cuda(*args, k)
        torch.cuda.synchronize()
        assert ntt2.conv2_cuda.launches == before + 1
        assert torch.equal(got, ref)
        assert torch.equal(got, ntt2.conv2_plain(*args, k))


def test_v2_dispatch_launches_k4_and_k5(gpu, monkeypatch):
    """HELIB_NTT_V2=1 routes ntt and conv to K4 and K5, leaves K3 alone."""
    monkeypatch.setenv("HELIB_NTT_V2", "1")
    monkeypatch.setenv("HELIB_NTT_V2_K", "3")
    x, t = _ntt_args(2048, 3, seed=5, dev=gpu)
    args = _conv_args(4096, 3, seed=6, dev=gpu)
    xa = args[0].movedim(1, 0).contiguous()
    before = (ntt2.ntt2_cuda.launches, ntt2.conv2_cuda.launches,
              ntt_fused.ntt_cuda.launches, conv_cuda.launches,
              conv_aux_cuda.launches)
    got = (ntt_fused.ntt(x, t, inverse=False), conv(*args),
           conv_aux(xa, *args[1:]))
    torch.cuda.synchronize()
    after = (ntt2.ntt2_cuda.launches, ntt2.conv2_cuda.launches,
             ntt_fused.ntt_cuda.launches, conv_cuda.launches,
             conv_aux_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0, 1]
    assert torch.equal(got[0], ntt_fused.ntt_plain(x, t, inverse=False))
    assert torch.equal(got[1], conv_plain(*args))
    assert torch.equal(got[2], conv_aux_plain(xa, *args[1:]))


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
    before = probes.p1_cuda.launches
    got = probes.p1_cuda(variant, *args)
    torch.cuda.synchronize()
    assert probes.p1_cuda.launches == before + 1
    assert torch.equal(got, probes.p1_plain(variant, *args))


@pytest.mark.parametrize("phase", probes.P2_PHASES)
def test_p2_probe_matches_plain(gpu, phase):
    x = _probe_args(16384, 6, seed=2, dev=gpu)[0]
    aux = ntt.aux_tree(16384, gpu)["aux"]
    tabs = (aux["tw_all"], aux["tw_all_sh"], aux["q"].reshape(3, 1))
    got = probes.p2_cuda(phase, x, *tabs)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.p2_plain(phase, x, *tabs))


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
    before = (conv_aux_cuda.launches, conv_cuda.launches)
    got = FatEncodedPtxt(ctx, poly, space=2).rt(ctx.L, True)
    torch.cuda.synchronize()
    assert conv_aux_cuda.launches - before[0] == 1
    assert conv_cuda.launches == before[1]
    assert got.is_cuda and got.shape == (ctx.L + ctx.S, ctx.n_eval)
    cpu = FatEncodedPtxt(Context(**SLOTS, device="cpu"), poly, space=2)
    assert torch.equal(got.cpu(), cpu.rt(ctx.L, True))
    monkeypatch.setattr(convmod, "conv_aux", convmod.conv_aux_plain)
    plain = FatEncodedPtxt(ctx, poly, space=2).rt(ctx.L, True)
    assert conv_aux_cuda.launches - before[0] == 1
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
    before = (conv_aux_cuda.launches, conv_cuda.launches)
    got = ea.rotate(ct.copy(), 1, sk)
    torch.cuda.synchronize()
    assert conv_aux_cuda.launches > before[0]
    assert conv_cuda.launches == before[1] and len(sk.matrices) == minted
    want = PtxtBGV(ea, slots).rotate(1)
    assert PtxtBGV.decode(ea, sk.decrypt_bgv(got)) == want

    sk_cpu, ea_cpu, _, ct_cpu = encrypted(Context(**SLOTS, device="cpu"))
    host = ea_cpu.rotate(ct_cpu, 1, sk_cpu)

    monkeypatch.setattr(convmod, "conv_aux", convmod.conv_aux_plain)
    launched = conv_aux_cuda.launches
    plain = ea.rotate(ct.copy(), 1, sk)
    assert conv_aux_cuda.launches == launched
    for ref in (plain, host):
        assert [(h, ref.k, ref.special) for h, _ in ref.parts] == [
            (h, got.k, got.special) for h, _ in got.parts]
        for (_, a), (_, b) in zip(got.parts, ref.parts):
            assert torch.equal(a.cpu(), b.cpu())


BOOT = dict(m=1271, p=2, r=1, bits=600, c=3, mvec=(31, 41))


def test_thin_recrypt_m1271_through_k3_equals_plain_and_cpu(gpu,
                                                            monkeypatch):
    """thin_recrypt at m=1271, mvec=(31, 41) (the factor-tree maps, B =
    4096) through K3 and no other kernel, bit-identical to the same
    bootstrap with the plain convolution (its constants built plain too)
    and to the port on the host CPU (keys, the recryption key, ekey and the
    encryption are host-seeded, so the same on all three); it decrypts to
    its input slots."""
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
        return thin_recrypt(low, rc, sk), sk, ea, slots, low

    before = (conv_aux_cuda.launches, conv_cuda.launches)
    got, sk, ea, slots, low = boot(Context(**BOOT))
    torch.cuda.synchronize()
    assert conv_aux_cuda.launches > before[0]
    assert conv_cuda.launches == before[1]
    assert np.array_equal(sk.decrypt_bgv(got), ea.encode(slots))
    assert got.is_correct() and got.capacity() > low.capacity() + 30
    host = boot(Context(**BOOT, device="cpu"))[0]
    monkeypatch.setattr(convmod, "conv_aux", convmod.conv_aux_plain)
    launched = conv_aux_cuda.launches
    plain = boot(Context(**BOOT))[0]
    assert conv_aux_cuda.launches == launched
    for ref in (plain, host):
        assert [(h, ref.k, ref.special) for h, _ in ref.parts] == [
            (h, got.k, got.special) for h, _ in got.parts]
        for (_, a), (_, b) in zip(got.parts, ref.parts):
            assert torch.equal(a.cpu(), b.cpu())


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

    before = (conv_aux_cuda.launches, conv_cuda.launches)
    got, sk, ea, want = add(Context(**BINARY))
    torch.cuda.synchronize()
    assert conv_aux_cuda.launches > before[0]
    assert conv_cuda.launches == before[1]
    assert len(got) == 9
    assert np.array_equal(decrypt_number(ea, sk, got), want)
    host = add(Context(**BINARY, device="cpu"))[0]
    for x, y in zip(got, host):
        assert (x.k, x.special) == (y.k, y.special)
        for (_, a), (_, b) in zip(x.parts, y.parts):
            assert torch.equal(a.cpu(), b)
