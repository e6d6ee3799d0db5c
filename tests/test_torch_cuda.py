"""The port's CUDA kernels (K1 conv, K2 ntt, K3 conv_aux, K4 ntt2, K5
conv2, the probes P1 and P2) and its BGV and CKKS paths (CKKS at m=1024
and m=131072), the BGV slot layer and the thin bootstrap at m=1271 on the
card, against the plain torch versions and the port on the CPU; the sizes
above the kernels' 2^16 (BGV m=35113, CKKS m=262144) on the staged
transforms, and the command-line utilities on the card.  The twins of
examples/01-10 run on the card, and the parallel layer's two-rank m=45
pipelines run as two gloo ranks sharing it.  Every jit site (transform,
digit decomposition, scaled mod-down, decrypt's inner product) and a
lifted pipeline run as CUDA graphs at m=31, 1271, 8009 and CKKS m=1024,
held to the same calls under jitutil.disable_jit().  The thin bootstrap at
m=35113 and the whole multi-rank dry run (entry.dryrun_multichip on two
ranks) run for minutes and are marked `cuda_long` as well
(`-m "not cuda_long"` leaves them out).

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


@pytest.mark.parametrize("phase", probes.P2_PHASES)
def test_p2_probe_at_65536_matches_plain(gpu, phase):
    """n = 65536 on 4-CTA clusters (coarse through distributed shared
    memory), 5 rows on 3 tables, alone and chained twice."""
    x = _probe_args(65536, 5, seed=3, dev=gpu)[0]
    aux = ntt.aux_tree(65536, gpu)["aux"]
    tabs = (aux["tw_all"], aux["tw_all_sh"], aux["q"].reshape(3, 1))
    before = probes.p2_cuda.launches
    got = probes.p2_cuda(phase, probes.p2_cuda(phase, x, *tabs), *tabs)
    torch.cuda.synchronize()
    assert probes.p2_cuda.launches == before + 2
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


BIG_BOOT = dict(m=35113, p=2, r=1, bits=600, c=3, mvec=(37, 949))


def _staged_counts():
    return (ntt.staged_transforms, conv_aux_cuda.launches,
            conv_cuda.launches, ntt_fused.ntt_cuda.launches)


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
    before = _staged_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    after = _staged_counts()
    assert after[0] > before[0] and after[1:] == before[1:]
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
    before = _staged_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    after = _staged_counts()
    assert after[0] - before[0] == 8 and after[1:] == before[1:]
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
    before = conv_aux_cuda.launches
    cli.main(["encrypt", f"ctx={d / 'ctx.bin'}", f"key={d / 'key.pk'}",
              f"in={d / 'data.txt'}", f"out={d / 'ct.bin'}"])
    cli.main(["decrypt", f"ctx={d / 'ctx.bin'}", f"key={d / 'key.sk'}",
              f"in={d / 'ct.bin'}", f"out={d / 'out.txt'}"])
    assert conv_aux_cuda.launches > before
    got = np.loadtxt(d / "out.txt", dtype=np.int64, ndmin=1)
    np.testing.assert_array_equal(got, vals)
    assert "encrypted 144 values" in capsys.readouterr().out


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
    before = _staged_counts()
    t0 = time.time()
    out = thin_recrypt(low, rc, sk)
    torch.cuda.synchronize()
    boot_s = time.time() - t0
    after = _staged_counts()
    print(f"thin bootstrap m=35113: setup {setup_s:.1f} s, cold "
          f"{boot_s:.1f} s, {after[0] - before[0]} staged transforms, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GB")
    assert after[0] > before[0] and after[1:] == before[1:]
    assert out.is_correct() and out.capacity() > low.capacity() + 30
    assert np.array_equal(sk.decrypt_bgv(out), ea.encode(slots))


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
    counters = jitutil.launch_counters()
    c0 = jitutil.read_counts(counters)
    with jitutil.disable_jit():
        for _ in range(3):
            call(*x1)
    c1 = jitutil.read_counts(counters)
    for _ in range(3):
        call(*x1)
    torch.cuda.synchronize()
    c2 = jitutil.read_counts(counters)
    assert jitutil.count_delta(c0, c1) == jitutil.count_delta(c1, c2)
    assert any(jitutil.count_delta(c0, c1))


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
    with torch.cuda.stream(side):
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
    counters = jitutil.launch_counters()
    for _ in range(2):
        before = jitutil.read_counts(counters)
        with pytest.raises(RuntimeError):
            run(*x)
        after = jitutil.read_counts(counters)
        # the warm-up ran (and is counted); the capture added nothing
        with jitutil.disable_jit():
            host_read(*x)
        assert jitutil.count_delta(before, after) == jitutil.count_delta(
            after, jitutil.read_counts(counters))
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
