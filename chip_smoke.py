"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels from ops/csrc (one nvcc per source,
     started together, sm_90a), timed, with each kernel's registers and
     spills;
  3. each kernel against its plain torch version on the card, bit for bit:
     K1 conv and K2 ntt (both directions), n = 8 .. 32768, and K3 conv_aux
     (aux-major), n = 8 .. 65536, the last on 2-CTA clusters;
  4. the BGV path -- batched mult+relin at m=8009, p=2, bits=380, c=3,
     batch 16 -- through K1 (and no K2), held against the same chain with
     the plain convolution and against the port on the host CPU, and an
     encrypt -> multiply -> decrypt oracle;
  5. the CKKS path -- batched mult+relin at m=65536, bits=440, c=3, r=30,
     batch 16 -- through K2 (and no K1), held against the same chain with
     the plain NTT and against the port on the host CPU, and an
     encrypt -> multiply -> rescale -> decrypt oracle within
     4 x error_bound() at the default scale 2^30 and within 1e-2 and
     4 x error_bound() at scale 2^40;
  6. timing: ops/s of each path, a profile of one call, and each kernel's
     time per launch on the inputs its path gave it, beside its bound and
     its plain version; on each of those inputs the kernel must equal its
     plain version bit for bit;
  7. the per-op BGV family at HElib's bgv_basic "big" size -- m=32003, p=2,
     bits=5800, c=3, unbatched, as benchmarks/bench_suite.py times it:
     mult+relin, rotate, encrypt (device sampling), decrypt, add and the
     ciphertext I/O round trip -- through K3 (and neither K1 nor K2), each
     with a decrypt oracle; the rotate held against the same op with the
     plain K3 and, at m=32003 with 1500 bits, against the port on the host
     CPU; ms per op, setup time, peak memory, a profile of one mult+relin
     and K3's row.
Each path and each op is driven with the launch counts set to 0 just before
it and read just after.  The last three lines are the card's name and power
limit as nvidia-smi prints them, the kernel table as JSON, and
{"ok": true, "device": {...}}.  Imports nothing of JAX or helib_tpu.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W):
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiplies: Hopper issues 64 INT32 lanes per SM per clock,
# half the 128 FP32 lanes behind the 67 TFLOP/s FP32 figure (2 flops/FMA):
# 67e12 / 2 / 2.
INT32_MUL_PER_S = 67e12 / 4

M, P_PLAIN, BITS, C, BATCH, SEED = 8009, 2, 380, 3, 16, 3
# HElib's largest ckks_basic size, as benchmarks/bench_suite.py times it
CKKS = dict(m=65536, p=-1, r=30, bits=440, c=3, scheme="ckks")
CKKS_SEED = 2
CKKS_TOL = 1e-2          # decrypted product vs numpy (test_ckks_large.py)
# HElib's bgv_basic "big" size (benchmarks/bench_suite.py:42-45), unbatched
BIG = dict(m=32003, p=2, r=1, bits=5800, c=3)
BIG_SEED = 2
# the host-CPU rotate check runs at m=32003 with fewer primes: at 5800 bits
# it took 141 s on the 8 host threads of the H100 machine
HOST_BITS = 1500


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back runs."""
    for _ in range(warm):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# K1: the Bluestein convolution
# ---------------------------------------------------------------------------

def conv_inputs(n: int, P: int, lead: tuple, seed: int, dev):
    """Real aux tables of size n and random rows / spectral kernels."""
    from helib_tpu_torch.ops.ntt import aux_tree, aux_primes
    from helib_tpu_torch.ops.modops import shoup, to_device
    rng = np.random.default_rng(seed)
    raux = aux_primes().astype(np.int64)
    t = aux_tree(n, dev)
    x = rng.integers(0, raux[:, None, None], lead + (3, P, n))
    kh = rng.integers(0, raux[:, None, None], (3, P, n)).astype(np.uint32)
    khsh = shoup(kh, raux[:, None, None].astype(np.uint64))
    return (to_device(x.astype(np.uint32), dev), t["aux"],
            to_device(kh, dev), to_device(khsh, dev))


def check_conv(dev) -> tuple[int, int]:
    """Kernel vs conv_plain, bit for bit; returns (rows compared, max err)."""
    from helib_tpu_torch.ops.conv import conv_cuda, conv_plain
    rows, err = 0, 0
    for n in (8, 64, 2048, 4096, 8192, 16384, 32768):
        for P in (5, 13):
            args = conv_inputs(n, P, (2,), seed=n + P, dev=dev)
            got = conv_cuda(*args)
            ref = conv_plain(*args)
            torch.cuda.synchronize()
            e = int((got.long() - ref.long()).abs().max())
            err = max(err, e)
            if e != 0 or not torch.equal(got, ref):
                raise AssertionError(f"conv kernel != plain at n={n} P={P}")
            rows += got.numel() // n
    return rows, err


def check_conv_aux(dev) -> tuple[int, int]:
    """K3 vs conv_aux_plain on aux-major [3, 2, P, n], bit for bit; returns
    (rows compared, max err)."""
    from helib_tpu_torch.ops.conv import conv_aux_cuda, conv_aux_plain
    rows, err = 0, 0
    for n in (8, 64, 2048, 4096, 16384, 32768, 65536):
        for P in (5, 20):
            x, aux, kh, khsh = conv_inputs(n, P, (2,), seed=n + P + 1, dev=dev)
            x = x.movedim(1, 0).contiguous()
            got = conv_aux_cuda(x, aux, kh, khsh)
            ref = conv_aux_plain(x, aux, kh, khsh)
            torch.cuda.synchronize()
            e = int((got.long() - ref.long()).abs().max())
            err = max(err, e)
            if e != 0 or not torch.equal(got, ref):
                raise AssertionError(f"conv_aux kernel != plain at n={n} "
                                     f"P={P}")
            rows += got.numel() // n
    return rows, err


def conv_bound_ms(x, khat) -> tuple[float, float]:
    """(bytes bound, multiplies bound) in ms for one launch: x read and out
    written once, khat/khat_sh and the four [3, n] tables read once; 3
    32-bit multiplies per Shoup product, (n/2) log2 n butterflies each way
    plus the khat and n^-1 products per row."""
    n = x.shape[-1]
    rows = x.numel() // n
    nbytes = 4 * (2 * x.numel() + 2 * khat.numel() + 4 * 3 * n + 3)
    muls = rows * 3 * n * (int(math.log2(n)) + 2)
    return nbytes / HBM_BYTES_PER_S * 1e3, muls / INT32_MUL_PER_S * 1e3


# ---------------------------------------------------------------------------
# K2: the fused power-of-2 NTT
# ---------------------------------------------------------------------------

def ntt_inputs(n: int, P: int, lead: tuple, seed: int, dev):
    """Real negacyclic tables for P primes of size n and random rows."""
    from helib_tpu_torch.nt.primegen import gen_primes
    from helib_tpu_torch.ops.ntt import Pow2NTT
    from helib_tpu_torch.ops.modops import to_device
    qs = np.array(gen_primes(2 * n, P), dtype=np.uint32)
    tab = Pow2NTT(qs, n, negacyclic=True)
    t = {**tab.tree(dev),
         "flat": {k: to_device(v, dev) for k, v in tab.flat().items()}}
    rng = np.random.default_rng(seed)
    x = rng.integers(0, qs[:, None].astype(np.int64), lead + (P, n))
    return to_device(x.astype(np.uint32), dev), t


def check_ntt(dev) -> tuple[int, int]:
    """Kernel vs ntt_plain, both directions, bit for bit; returns (rows
    compared, max err)."""
    from helib_tpu_torch.ops.ntt_fused import ntt_cuda, ntt_plain
    rows, err = 0, 0
    for n in (8, 64, 2048, 4096, 8192, 16384, 32768):
        for P in (5, 20):
            x, t = ntt_inputs(n, P, (2,), seed=n + P, dev=dev)
            for inverse in (False, True):
                got = ntt_cuda(x, t["flat"], t["q"], inverse)
                ref = ntt_plain(x, t, inverse)
                torch.cuda.synchronize()
                e = int((got.long() - ref.long()).abs().max())
                err = max(err, e)
                if e != 0 or not torch.equal(got, ref):
                    raise AssertionError(f"ntt kernel != plain at n={n} "
                                         f"P={P} inverse={inverse}")
                rows += got.numel() // n
    return rows, err


def ntt_bound_ms(x, inverse: bool) -> tuple[float, float]:
    """(bytes bound, multiplies bound) in ms for one launch: x read and out
    written once, the direction's two flat [P, n] tables and q read once;
    3 32-bit multiplies per Shoup product, (n/2) log2 n butterflies per row
    plus the n^-1 product of the inverse."""
    n, P = x.shape[-1], x.shape[-2]
    rows = x.numel() // n
    nbytes = 4 * (2 * x.numel() + 2 * P * n + P)
    muls = rows * 3 * ((n // 2) * int(math.log2(n)) + (n if inverse else 0))
    return nbytes / HBM_BYTES_PER_S * 1e3, muls / INT32_MUL_PER_S * 1e3


# ---------------------------------------------------------------------------
# the BGV path (K1)
# ---------------------------------------------------------------------------

class swap:
    """Context manager replacing module.name for its duration: routes a
    path to a kernel's plain version (`swap(mod, "ntt", mod.ntt_plain)`),
    or records every call's arguments (`capture`)."""

    def __init__(self, mod, name: str, repl):
        self.mod, self.name, self.repl = mod, name, repl

    def __enter__(self):
        self.saved = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.repl)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.saved)


def capture(mod, name: str) -> swap:
    """swap() that passes every call through and keeps its arguments in
    `.calls`."""
    orig = getattr(mod, name)
    calls = []

    def rec(*args):
        calls.append(args)
        return orig(*args)
    cm = swap(mod, name, rec)
    cm.calls = calls
    return cm


def reset_launches():
    from helib_tpu_torch.ops.conv import conv_cuda, conv_aux_cuda
    from helib_tpu_torch.ops.ntt_fused import ntt_cuda
    conv_cuda.launches = ntt_cuda.launches = conv_aux_cuda.launches = 0


def read_launches() -> dict:
    from helib_tpu_torch.ops.conv import conv_cuda, conv_aux_cuda
    from helib_tpu_torch.ops.ntt_fused import ntt_cuda
    return {"conv": conv_cuda.launches, "ntt": ntt_cuda.launches,
            "conv_aux": conv_aux_cuda.launches}


def check_outputs(out, ctx, batch: int, dev):
    """int32 residues of shape [batch, L, N], each below its prime."""
    q = torch.from_numpy(ctx.qs.astype(np.int64)).to(dev)[:, None]
    for o in out:
        if o.shape != (batch, ctx.L, ctx.n_eval) or o.dtype != torch.int32:
            raise AssertionError(f"bad output {o.shape} {o.dtype}")
        if bool(((o < 0) | (o.long() >= q)).any()):
            raise AssertionError("output residues out of range")


def main_path(dev):
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey, SKHandle, reduce_mod_phim
    from helib_tpu_torch.ctxt import Ctxt
    from helib_tpu_torch.pipeline import (make_batched_mult_relin,
                                          make_mult_relin, mult_relin,
                                          fresh_noise)
    from helib_tpu_torch.ops import conv as convmod

    t0 = time.time()
    ctx = Context(m=M, p=P_PLAIN, r=1, bits=BITS, c=C, device=dev)
    sk = SecKey(ctx, seed=SEED)
    fn, args = make_batched_mult_relin(ctx, sk, BATCH)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    print(f"main path: {ctx!r}; setup {setup_s:.1f} s")

    reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"main path: one batched call launched {launches}")
    if launches["conv"] == 0 or launches["ntt"] or launches["conv_aux"]:
        raise AssertionError("BGV path must launch the conv kernel and no "
                             "other")
    check_outputs(out, ctx, BATCH, dev)

    # the same chain on batch element 0 with the plain convolution
    pk = sk.pubkey
    with swap(convmod, "conv", convmod.conv_plain):
        before = read_launches()
        ref = mult_relin(ctx, pk, sk, fresh_noise(ctx, pk), ctx.L,
                         *[a[0] for a in args])
        torch.cuda.synchronize()
        if read_launches() != before:
            raise AssertionError("reference run launched a kernel")
    ref = dict((h.powS, d) for h, d in ref.parts)
    for i in (0, 1):
        if not torch.equal(out[i][0], ref[i]):
            raise AssertionError(f"part {i}: kernel path != plain path")
    print("main path: batch element 0 bit-identical to the plain-conv chain")

    # the same element through the port on the host CPU (keys regenerated
    # from the same seed); the CPU path is the one held against helib_tpu
    t0 = time.time()
    ctx_cpu = Context(m=M, p=P_PLAIN, r=1, bits=BITS, c=C, device="cpu")
    fn_cpu, _ = make_mult_relin(ctx_cpu, SecKey(ctx_cpu, seed=SEED))
    host = fn_cpu(*[a[0].cpu() for a in args])
    for i in (0, 1):
        if not torch.equal(out[i][0].cpu(), host[i]):
            raise AssertionError(f"part {i}: GPU != CPU port")
    print(f"main path: batch element 0 bit-identical to the port on the "
          f"host CPU ({time.time() - t0:.1f} s)")

    # decrypt oracle
    rng = np.random.default_rng(SEED + 1)
    pts = [rng.integers(0, 2, ctx.phi_m) for _ in range(2)]
    cts = [pk.encrypt_bgv(pt, rng) for pt in pts]
    o0, o1 = fn(cts[0].parts[0][1], cts[0].parts[1][1],
                cts[1].parts[0][1], cts[1].parts[1][1])
    prod = Ctxt(ctx, pk, [(SKHandle(0, 1, 0), o0), (SKHandle(1, 1, 0), o1)],
                ctx.L, False, 2, 0.0, 1)
    got = sk.decrypt_bgv(prod)
    want = reduce_mod_phim(np.convolve(pts[0], pts[1]) % 2, ctx, 2)
    if not np.array_equal(got, want):
        raise AssertionError("decrypt oracle: product mismatch")
    print(f"main path: decrypt oracle passed ({ctx.phi_m} coefficients)")
    return fn, args, launches


# ---------------------------------------------------------------------------
# the CKKS path (K2)
# ---------------------------------------------------------------------------

def ckks_path(dev):
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey, SKHandle
    from helib_tpu_torch.ctxt import Ctxt
    from helib_tpu_torch.ckks import EncryptedArrayCKKS
    from helib_tpu_torch.pipeline import (make_batched_mult_relin,
                                          make_mult_relin, mult_relin,
                                          fresh_noise)
    from helib_tpu_torch.ops import ntt_fused

    t0 = time.time()
    ctx = Context(**CKKS, device=dev)
    sk = SecKey(ctx, seed=CKKS_SEED)
    fn, args = make_batched_mult_relin(ctx, sk, BATCH)
    torch.cuda.synchronize()
    print(f"ckks path: {ctx!r}; setup {time.time() - t0:.1f} s")

    reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"ckks path: one batched call launched {launches}")
    if launches["ntt"] == 0 or launches["conv"] or launches["conv_aux"]:
        raise AssertionError("CKKS path must launch the ntt kernel and no "
                             "other")
    check_outputs(out, ctx, BATCH, dev)

    # the same chain on batch element 0 with the plain NTT
    pk = sk.pubkey
    with swap(ntt_fused, "ntt", ntt_fused.ntt_plain):
        before = read_launches()
        ref = mult_relin(ctx, pk, sk, fresh_noise(ctx, pk), ctx.L,
                         *[a[0] for a in args])
        torch.cuda.synchronize()
        if read_launches() != before:
            raise AssertionError("reference run launched a kernel")
    ref = dict((h.powS, d) for h, d in ref.parts)
    for i in (0, 1):
        if not torch.equal(out[i][0], ref[i]):
            raise AssertionError(f"part {i}: kernel path != plain path")
    print("ckks path: batch element 0 bit-identical to the plain-NTT chain")

    # the same element through the port on the host CPU
    t0 = time.time()
    ctx_cpu = Context(**CKKS, device="cpu")
    fn_cpu, _ = make_mult_relin(ctx_cpu, SecKey(ctx_cpu, seed=CKKS_SEED))
    host = fn_cpu(*[a[0].cpu() for a in args])
    for i in (0, 1):
        if not torch.equal(out[i][0].cpu(), host[i]):
            raise AssertionError(f"part {i}: GPU != CPU port")
    print(f"ckks path: batch element 0 bit-identical to the port on the "
          f"host CPU at m={CKKS['m']} ({time.time() - t0:.1f} s)")

    # decrypt oracle on the timed function: encrypt two slot vectors, run
    # them through fn, wrap as a Ctxt with scale f1*f2, rescale, decrypt.
    # The mitigated decrypt releases an error of about error_bound(), which
    # at the default scale 2^r = 2^30 is ~0.04 here: that run is held to
    # 4 x error_bound; a run at scale 2^40 is also held to CKKS_TOL.
    ea = EncryptedArrayCKKS(ctx)
    rng = np.random.default_rng(CKKS_SEED + 1)
    for scale_bits in (CKKS["r"], 40):
        zs = [rng.uniform(-1, 1, ea.nslots)
              + 1j * rng.uniform(-1, 1, ea.nslots) for _ in range(2)]
        cts = [ea.encrypt(z, pk, rng, scale=1 << scale_bits) for z in zs]
        o0, o1 = fn(cts[0].parts[0][1], cts[0].parts[1][1],
                    cts[1].parts[0][1], cts[1].parts[1][1])
        # the eager multiply gives the product's level, noise, magnitude
        eager = cts[0].multiply(cts[1], sk)
        eager.drop_special_primes()
        scale = cts[0].ratFactor * cts[1].ratFactor
        if eager.k != ctx.L or eager.ratFactor != scale:
            raise AssertionError(f"eager product at k={eager.k}, scale "
                                 f"{eager.ratFactor} != {scale}")
        parts = dict((h.powS, d) for h, d in eager.parts)
        if not (torch.equal(o0, parts[0]) and torch.equal(o1, parts[1])):
            raise AssertionError("fn != eager multiply")
        prod = Ctxt(ctx, pk, [(SKHandle(0, 1, 0), o0),
                              (SKHandle(1, 1, 0), o1)],
                    ctx.L, False, 1, eager.noise, 1, scale, eager.ptxtMag)
        ea.rescale(prod)
        got = ea.decrypt(prod, sk)
        err = float(np.max(np.abs(got - zs[0] * zs[1])))
        bound = prod.error_bound()
        tol = min(4 * bound, CKKS_TOL) if scale_bits == 40 else 4 * bound
        print(f"ckks path: decrypt oracle at scale 2^{scale_bits}: max "
              f"|err| = {err:.3e}, error_bound = {bound:.3e}, limit "
              f"{tol:.3e} ({ea.nslots} slots, rescaled to k={prod.k})")
        if not err <= tol:
            raise AssertionError("decrypt oracle: product outside tolerance")
    return fn, args, launches


# ---------------------------------------------------------------------------
# the per-op BGV family at m=32003 (K3)
# ---------------------------------------------------------------------------

def host_ms(fn, reps: int) -> float:
    """Mean host-clock ms of fn() (which ends in a synchronize or on the
    host) over `reps` runs after one warm-up run."""
    fn()
    t0 = time.time()
    for _ in range(reps):
        fn()
    return (time.time() - t0) / reps * 1e3


def rotate_on_host(dev):
    """The rotate at m=32003 and HOST_BITS on the card and through the port
    on the host CPU, with the card's keys carried over by convert.py (the
    matrix of X -> X^3 included): bit-identical."""
    from helib_tpu_torch import convert
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey, PubKey
    from helib_tpu_torch.ops.modops import to_host
    from helib_tpu_torch.pipeline import make_automorph_relin

    params = {**BIG, "bits": HOST_BITS}
    ctx = Context(**params, device=dev)
    sk = SecKey(ctx, seed=BIG_SEED)
    pk = PubKey(sk)
    fn, args = make_automorph_relin(ctx, sk)
    out = fn(*args)
    t0 = time.time()
    ctx_cpu = Context(**params, device="cpu")
    sk_cpu = convert.seckey_from_arrays(
        ctx_cpu, [{"coeffs": s["coeffs"], "bound": s["bound"],
                   "full": to_host(s["full"])} for s in sk.skeys],
        {key: convert.ksmatrix_arrays(W) for key, W in sk.matrices.items()})
    sk_cpu.pubkey = convert.pubkey_from_arrays(
        ctx_cpu, [((h.powS, h.powX, h.keyID), to_host(d))
                  for h, d in pk.enc_key], pk.enc_noise, pk.sk_bound,
        sk_cpu.matrices)
    fn_cpu, _ = make_automorph_relin(ctx_cpu, sk_cpu)
    t1 = time.time()
    host = fn_cpu(*[a.cpu() for a in args])
    if not all(torch.equal(a.cpu(), b) for a, b in zip(out, host)):
        raise AssertionError("perop rotate: GPU != CPU port")
    print(f"perop: rotate bit-identical to the port on the host CPU at "
          f"m={ctx.m}, bits={ctx.bits}, L={ctx.L}, S={ctx.S} (setup "
          f"{t1 - t0:.1f} s, rotate {time.time() - t1:.1f} s on "
          f"{torch.get_num_threads()} threads)")


def perop_path(dev, card: str) -> dict:
    """Drives each op once with the counts reset before it and read after,
    checks it by decryption, holds the rotate against the plain K3 and the
    host CPU, then times every op and K3."""
    from helib_tpu_torch import io as tio
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.ctxt import Ctxt
    from helib_tpu_torch.dcrt import rt_add, small_coeffs_to_rt
    from helib_tpu_torch.keys import SecKey, PubKey, SKHandle, reduce_mod_phim
    from helib_tpu_torch.ops import conv as convmod
    from helib_tpu_torch.nt import native
    from helib_tpu_torch.pipeline import (make_mult_relin,
                                          make_automorph_relin, make_encrypt)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ctx = Context(**BIG, device=dev)
    sk = SecKey(ctx, seed=BIG_SEED)
    pk = PubKey(sk)
    mfn, margs = make_mult_relin(ctx, sk)
    rfn, _ = make_automorph_relin(ctx, sk)
    efn = make_encrypt(ctx, pk)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    # make_automorph_relin's exponent: the first hypercube generator, or 3
    # where there is none (p = 2 generates (Z/32003Z)*: one slot, no gens)
    L, kexp = ctx.L, (ctx.pal.gens[0] if ctx.pal.gens else 3)
    print(f"perop: {ctx!r}; setup {setup_s:.1f} s; rotate by {kexp}")

    counts = {}

    def run(name, f, k3: bool):
        reset_launches()
        out = f()
        torch.cuda.synchronize()
        counts[name] = c = read_launches()
        if c["conv"] or c["ntt"] or (c["conv_aux"] > 0) != k3:
            raise AssertionError(f"perop {name}: launched {c}")
        return out

    def ctxt(parts, k, special):
        return Ctxt(ctx, pk, [(SKHandle(0, 1, 0), parts[0]),
                              (SKHandle(1, 1, 0), parts[1])],
                    k, special, 2, 0.0, 1)

    def check(name, got, want):
        if not np.array_equal(got, reduce_mod_phim(want % 2, ctx, 2)):
            raise AssertionError(f"perop {name}: decrypt oracle failed")
        print(f"perop: {name} decrypt oracle passed")

    rng = np.random.default_rng(BIG_SEED + 1)
    pts = [rng.integers(0, 2, ctx.phi_m) for _ in range(2)]
    cts = [pk.encrypt_bgv(pt, rng) for pt in pts]
    parts = [[d for _, d in ct.parts] for ct in cts]

    out = run("mult", lambda: mfn(*parts[0], *parts[1]), True)
    check("mult", sk.decrypt_bgv(ctxt(out, L, False)),
          np.convolve(pts[0], pts[1]))

    rot = run("rotate", lambda: rfn(*parts[0]), True)
    moved = np.zeros(ctx.m, dtype=np.int64)
    np.add.at(moved, (np.arange(ctx.phi_m) * kexp) % ctx.m, pts[0])
    check("rotate", sk.decrypt_bgv(ctxt(rot, L, False)), moved)
    eager = cts[0].copy().smart_automorph(kexp, sk)
    check("rotate (smart_automorph)", sk.decrypt_bgv(eager), moved)
    eager.drop_special_primes()
    eparts = dict((h.powS, d) for h, d in eager.parts)
    if not all(torch.equal(rot[i], eparts[i]) for i in (0, 1)):
        raise AssertionError("perop rotate: fn != smart_automorph")

    pt_eval = small_coeffs_to_rt(ctx, pts[0], L, False)
    gen = torch.Generator(device=dev)
    enc = run("encrypt", lambda: efn(gen.manual_seed(BIG_SEED), pt_eval),
              True)
    check("encrypt", sk.decrypt_bgv(ctxt(enc, L, False)), pts[0])

    dec = run("decrypt", lambda: sk.decrypt_bgv(cts[1]), True)
    check("decrypt", dec, pts[1])

    total = run("add", lambda: cts[0].copy().add(cts[1]), False)
    check("add", sk.decrypt_bgv(total), pts[0] + pts[1])

    def roundtrip():
        blob = tio.to_bytes(tio.write_ctxt, cts[0])
        return blob, tio.from_bytes(tio.read_ctxt, blob, ctx, pk)
    blob, back = run("io", roundtrip, False)
    if not all(torch.equal(a, b) for (_, a), (_, b) in
               zip(back.parts, cts[0].parts)):
        raise AssertionError("perop io: residues changed in the round trip")
    check("io", sk.decrypt_bgv(back), pts[0])
    print(f"perop: launches per op {json.dumps(counts)}")

    # the rotate with the plain K3, and on the host CPU (keys carried over)
    with swap(convmod, "conv_aux", convmod.conv_aux_plain):
        reset_launches()
        ref = rfn(*parts[0])
        torch.cuda.synchronize()
        if any(read_launches().values()):
            raise AssertionError("reference run launched a kernel")
    if not all(torch.equal(a, b) for a, b in zip(rot, ref)):
        raise AssertionError("perop rotate: kernel path != plain path")
    print("perop: rotate bit-identical to the plain-K3 chain")
    rotate_on_host(dev)

    # timings: chained on the device, host clock, ended by a synchronize
    def chained(f, n):
        def go():
            o = f(None)
            for _ in range(n - 1):
                o = f(o)
            torch.cuda.synchronize()
        return go

    ms = {}
    ms["mult"] = host_ms(chained(lambda o: mfn(*(o or parts[0]), *parts[1]),
                                 10), 1) / 10
    ms["rotate"] = host_ms(chained(lambda o: rfn(*(o or parts[0])), 10),
                           1) / 10
    seeds = iter(range(10 ** 6))
    ms["encrypt"] = host_ms(chained(
        lambda o: efn(gen.manual_seed(next(seeds)), pt_eval), 10), 1) / 10
    ms["decrypt"] = host_ms(lambda: sk.decrypt_bgv(cts[1]), 5)
    # its device part: inner product, inverse transform, copy to the host
    ms["decrypt_device"] = host_ms(
        lambda: sk._inner_product_residues(cts[1]), 5)
    ms["add"] = host_ms(chained(
        lambda o: rt_add(ctx, parts[0][0] if o is None else o,
                         parts[1][0], L, False), 200), 1) / 200
    ms["io"] = host_ms(roundtrip, 5)
    for name, v in ms.items():
        print(f"perop: {name} {v:.3f} ms")
    print(f"perop: host CRT through the native combiner: "
          f"{native.available()}")
    profile(mfn, (*parts[0], *parts[1]), "bgv m=32003 mult+relin")
    row = kernel_row(mfn, (*parts[0], *parts[1]), counts["mult"], "conv_aux")
    from helib_tpu_torch.ops.conv import conv_aux_max_clusters
    print(json.dumps({
        "metric": "torch_cuda_bgv_perop_ms_m32003_b5800",
        "ms_per_op": ms, "setup_s": setup_s, "io_bytes": len(blob),
        "launches_per_op": counts,
        "conv_aux_ms_per_launch": row["ms"],
        "conv_aux_clusters_resident": conv_aux_max_clusters(dev),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "card": card}))
    return row


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def chain(fn, args, n: int):
    """n calls, each taking the previous call's outputs as its first
    operand, ending in a synchronize."""
    o0, o1 = fn(*args)
    for _ in range(n - 1):
        o0, o1 = fn(o0, o1, args[2], args[3])
    torch.cuda.synchronize()


def timing(fn, args, iters: int = 10) -> dict:
    """ops/s at the batch of `args` (3 warm-up calls, `iters` timed), and
    the time of one unbatched call (batch element 0)."""
    batch = args[0].shape[0]
    one = [a[0] for a in args]
    out = {}
    for name, a, per in (("batched", args, batch), ("unbatched", one, 1)):
        chain(fn, a, 3)
        t0 = time.time()
        chain(fn, a, iters)
        dt = time.time() - t0
        out[name] = (per * iters / dt, dt / iters * 1e3)
    return {"ops_per_s": out["batched"][0],
            "ms_per_op": 1e3 / out["batched"][0],
            "ms_per_batched_call": out["batched"][1],
            "ms_per_unbatched_call": out["unbatched"][1]}


def profile(fn, args, label: str, top: int = 10):
    """Device time of one call by kernel name (torch.profiler), and the
    call's wall time: the share of the call the device is busy."""
    from torch.profiler import profile as prof, ProfilerActivity
    fn(*args)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.time()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.time() - t0
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in p.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    print(f"profile ({label}): one call {wall * 1e3:.3f} ms wall, device "
          f"busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f} %), "
          f"{sum(r[1] for r in rows)} kernel launches")
    for key, count, ms in rows[:top]:
        print(f"  {ms:9.3f} ms {count:5d}x  {key[:90]}")


def kernel_table() -> dict:
    """name -> (module, attribute the path calls, source, the TPU kernel it
    replaces, kernel, plain version, bound)."""
    from helib_tpu_torch.ops import conv as convmod, ntt_fused
    conv_bound = lambda x, aux, kh, khsh: conv_bound_ms(x, kh)  # noqa: E731
    return {
        "conv": (convmod, "conv", "helib_tpu_torch/ops/csrc/conv.cu",
                 "helib_tpu/ops/pallas_ntt.py:452", convmod.conv_cuda,
                 convmod.conv_plain, conv_bound),
        "ntt": (ntt_fused, "ntt", "helib_tpu_torch/ops/csrc/ntt.cu",
                "helib_tpu/ops/pallas_ntt.py:396",
                lambda x, t, inv: ntt_fused.ntt_cuda(x.contiguous(),
                                                     t["flat"], t["q"], inv),
                ntt_fused.ntt_plain, lambda x, t, inv: ntt_bound_ms(x, inv)),
        "conv_aux": (convmod, "conv_aux",
                     "helib_tpu_torch/ops/csrc/conv_aux.cu",
                     "helib_tpu/ops/pallas_ntt.py:527", convmod.conv_aux_cuda,
                     convmod.conv_aux_plain, conv_bound),
    }


def kernel_row(fn, args, launches: dict, name: str) -> dict:
    """Times one kernel on the inputs its path gave it: the kernel, its
    plain version and the bound, averaged over the path's launches.  Each
    of those launches is also held to the plain version bit for bit."""
    mod, attr, src, replaces, kernel, plain, bound = kernel_table()[name]
    with capture(mod, attr) as cap:
        fn(*args)
    torch.cuda.synchronize()
    if len(cap.calls) != launches[name]:
        raise AssertionError(f"capture run made another number of {name}s")
    ms = plain_ms = bb = bo = 0.0
    err = 0
    for a in cap.calls:
        ms += event_ms(lambda: kernel(*a))
        plain_ms += event_ms(lambda: plain(*a), reps=3)
        got, ref = kernel(*a), plain(*a)
        e = int((got.long() - ref.long()).abs().max())
        err = max(err, e)
        if e != 0 or not torch.equal(got, ref):
            raise AssertionError(f"{name} kernel != plain on the path's "
                                 f"input {tuple(a[0].shape)}")
        b, o = bound(*a)
        bb, bo = bb + b, bo + o
    n = len(cap.calls)
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms / n, "plain_ms": plain_ms / n,
            "bound_ms": max(bb, bo) / n,
            "bound_by": "bytes" if bb >= bo else "operations",
            "library_ms": None}


def measure(fn, args, launches, name: str, metric: str, label: str,
            card: str) -> dict:
    """Timing, profile and kernel row of one path; prints its metric
    line."""
    t = timing(fn, args)
    profile(fn, args, label)
    row = kernel_row(fn, args, launches, name)
    print(json.dumps({"metric": metric, **t,
                      "kernel": name, "kernel_ms_per_launch": row["ms"],
                      "kernel_launches_per_call": row["launches"],
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "card": card}))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from helib_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")

    start = time.time()
    _build.build("conv", "ntt", "conv_aux")
    print(f"build: conv.cu, ntt.cu and conv_aux.cu in "
          f"{time.time() - start:.1f} s")
    for name in ("conv", "ntt", "conv_aux"):
        for line in _build.ptxas_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rows, err = check_conv(dev)
    print(f"kernels: conv == conv_plain bit for bit on {rows} rows "
          f"(n = 8 .. 32768, max |err| = {err})")
    rows, err = check_ntt(dev)
    print(f"kernels: ntt == ntt_plain bit for bit on {rows} rows "
          f"(n = 8 .. 32768, P = 5 and 20, both directions, "
          f"max |err| = {err})")
    rows, err = check_conv_aux(dev)
    print(f"kernels: conv_aux == conv_aux_plain bit for bit on {rows} rows "
          f"(n = 8 .. 65536, P = 5 and 20, aux-major with a lead dim, "
          f"max |err| = {err})")

    fn, args, launches = main_path(dev)
    kernels = [measure(fn, args, launches, "conv",
                       "torch_cuda_mult_relin_ops_per_s_m8009_b380_batch16",
                       "bgv", card)]
    del fn, args
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    fn, args, launches = ckks_path(dev)
    kernels.append(measure(
        fn, args, launches, "ntt",
        "torch_cuda_ckks_mult_relin_ops_per_s_m65536_b440_batch16", "ckks",
        card))
    del fn, args
    torch.cuda.empty_cache()

    kernels.append(perop_path(dev, card))
    print(f"chip_smoke: {time.time() - start:.1f} s of command time after "
          f"start-up")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
