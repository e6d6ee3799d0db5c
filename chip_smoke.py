"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the five CUDA sources from ops/csrc (one nvcc per source,
     started together, sm_90a), timed, with every kernel's registers and
     spills (each an instantiation of ntt_rows.cuh, printed as
     ntt_rows_kernel<row map, mode, largest composite K, CTAs a row,
     threads a CTA, minimum CTAs an SM>; K4 and K5 at K = 1, 2, 3);
  3. each kernel against its plain torch version on the card, bit for bit:
     K1 conv (and K5 at k = 3, the same code), n = 8 .. 32768; K2 ntt,
     both directions, n = 8 .. 65536, so on every shipped configuration
     (one CTA of 512 threads a row, one of 1024 at n = 32768, 4-CTA
     clusters at n = 65536); K3 conv_aux (aux-major), n = 8 .. 65536, the
     last on 4-CTA clusters and on 2-CTA ones (conv_aux.cu's
     helib_conv_aux_launch_c2); K4 ntt2 at every k, n = 8 .. 65536, and K5
     conv2 at every k, n = 8 .. 32768, against their own plain versions and
     K2's and K1's, K4 at k = 3 also against K2; P = 5 and 20;
  4. the BGV path -- batched mult+relin at m=8009, p=2, bits=380, c=3,
     batch 16 -- through K1 (and no other kernel), held against the same
     chain with the plain convolution and against the port on the host CPU,
     and an encrypt -> multiply -> decrypt oracle;
  5. the CKKS path -- batched mult+relin at m=65536, bits=440, c=3, r=30,
     batch 16 -- through K2 (and no other kernel), held against the same
     chain with the plain NTT and against the port on the host CPU, and an
     encrypt -> multiply -> rescale -> decrypt oracle within
     4 x error_bound() at the default scale 2^30 and within 1e-2 and
     4 x error_bound() at scale 2^40;
  6. timing of each path: ops/s, a profile of one call, and each kernel's
     time per launch on the inputs its path gave it (CUDA events over
     launches queued behind a sleep kernel), beside its bound and its plain
     version; on each of those inputs the kernel must equal its plain
     version bit for bit; K5 at k = 3 timed in turns with K1 on K1's
     inputs, K4 at k = 3 in turns with K2 on K2's, and the CTAs of K2's
     n = 32768 kernel the card holds at once;
  7. the v2 schedule (HELIB_NTT_V2=1) on the same two paths and inputs:
     the BGV path through K5 alone and the CKKS path through K4 alone, each
     bit-identical to the default run; ops/s, a profile, K5's and K4's rows
     and each one's time at every k on the path's own inputs, then the
     default path timed again (default, v2, default in one call);
  8. the CKKS rotation family at m=65536, bits=440, c=3, r=30, unbatched,
     encoded at scale 2^40: rotate by 1 and by 5, conjugate, shift by 1, the
     real and the imaginary part, once through K2 and once through K4,
     bit-identical, each with a decrypt oracle against numpy within
     min(1e-2, 4 x error_bound()); ms and launches per op, peak memory;
  9. CKKS at m=131072 (n = 65536), bits=440, c=3, r=30, unbatched: one
     mult+relin through K2 alone (4-CTA clusters), held against the same
     chain with the plain NTT and against the port on the host CPU, an
     encrypt -> multiply -> rescale -> decrypt oracle within
     min(1e-2, 4 x error_bound()) at scale 2^40; ms per call, K2's row at
     n = 65536 and the clusters the card holds at once;
 10. the per-op BGV family at HElib's bgv_basic "big" size -- m=32003, p=2,
     bits=5800, c=3, unbatched, as benchmarks/bench_suite.py times it:
     mult+relin, rotate, encrypt (device sampling), decrypt, add and the
     ciphertext I/O round trip -- through K3 (and no other kernel), each
     with a decrypt oracle; the rotate held against the same op with the
     plain K3 and, at m=32003 with 1500 bits, against the port on the host
     CPU; ms per op, setup time, peak memory, a profile of one mult+relin,
     K3's row and the clusters the card holds at once;
 11. the cost probes at the TPU probes' shapes: P1's seven variants on 160
     rows of 16384 words, 50 chained applications, and P2's three phases on
     160 rows of n = 16384, 100 chained, each held to its plain version bit
     for bit; us per application and per row beside each bound, and K1's
     time per row at n = 16384;
 12. the BGV slot layer at m=31775, p=2, bits=600, c=3, mvec=(31, 25, 41)
     (HElib's small thin-bootstrapping size: 1200 slots of GF(2^20),
     hypercube [30, 20, 2], the last dimension bad; B = 65536), with
     SecKey(seed=141, hwt=64) and every rotation matrix minted before the
     ops: encrypt, multiply, add_constant(encode_ptxt), a FatEncodedPtxt's
     build and mul_by_constant, rotate by 1 and by 41, shift_1d on the bad
     dimension, total_sums and replicate, each through K3 and no other
     kernel and decrypted exactly to the PtxtBGV oracle; the rotate by 1
     held against the plain K3 and, with mul_by_constant, against the port
     on the host CPU; setup s, host encode/decode ms, cold and warm ms and
     K3 launches per op, the device masks cached, peak memory and K3's row
     on the rotate's inputs;
 13. BGV thin bootstrapping at m=31775 on phase 12's context, keys and
     EncryptedArray (HElib's bgv_thinboot "small" size): RecryptData(hwt=64)
     (e, ePrime, setup s split into the big-space EncryptedArray, the two
     EvalMaps and ekey), slots from default_rng(143) brought to k=3, one cold
     thin_recrypt with the SecKey (matrices minted, their bytes) and warm
     ones with the PubKey alone (nothing minted); each decrypts to the input
     slots, is correct, gains more than 30 bits of capacity and multiplies
     correctly after; K3 alone launched, its count; a warm run bit-identical
     to the plain-K3 chain (the cached diagonals rebuilt plain); host ms per
     stage, a profile of a warm run, K3's row on a sample of the
     bootstrap's inputs, peak memory;
 14. m=1271 (HElib's bgv_thinboot/bgv_fatboot "tiny" size), thin and fat
     with SecKey(seed=131, hwt=64): cold and warm ms through K3 alone, each
     decrypting exactly to its input; the warm thin bootstrap
     bit-identical to the port on the host CPU at the full 600 bits (slot
     tables shared, keys and recryption state carried by convert.py); K3's
     row on the thin bootstrap's inputs.
Each path, each op and the probe run is driven with the launch counts set to
0 just before it and read just after.  The last three lines are the card's
name and power limit as nvidia-smi prints them, the kernel table as JSON, and
{"ok": true, "device": {...}}.  Imports nothing of JAX or helib_tpu.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import re
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
# the same parameters at m=131072 (N = 65536): K2 at n = 65536
CKKS_BIG = {**CKKS, "m": 131072}
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


# ~50 ms of the card's clock: while a sleep kernel holds the device, the host
# queues the timed launches, so back-to-back launches shorter than their
# Python launch cost are timed on the device, not at the host's launch rate
HOLD_CYCLES = 100_000_000


def event_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back runs, queued
    behind a sleep kernel."""
    for _ in range(warm):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
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


CONV_SIZES = (8, 64, 2048, 4096, 8192, 16384, 32768)


def check_conv(dev) -> tuple[int, int]:
    """K1 vs conv_plain and vs K5 at k = 3 (the same schedule), bit for
    bit; returns (rows compared, max err)."""
    from helib_tpu_torch.ops.conv import conv_cuda, conv_plain
    from helib_tpu_torch.ops.ntt2 import conv2_cuda
    rows, err = 0, 0
    for n in CONV_SIZES:
        for P in (5, 13):
            args = conv_inputs(n, P, (2,), seed=n + P, dev=dev)
            got = conv_cuda(*args)
            ref = conv_plain(*args)
            k5 = conv2_cuda(*args, 3)
            torch.cuda.synchronize()
            e = int((got.long() - ref.long()).abs().max())
            err = max(err, e)
            if e != 0 or not torch.equal(got, ref):
                raise AssertionError(f"conv kernel != plain at n={n} P={P}")
            if not torch.equal(got, k5):
                raise AssertionError(f"conv kernel != conv2 (k=3) at n={n} "
                                     f"P={P}")
            rows += got.numel() // n
    return rows, err


def check_conv_aux(dev) -> tuple[int, int]:
    """K3 vs conv_aux_plain on aux-major [3, 2, P, n], bit for bit, and at
    n = 65536 its 2-CTA-cluster entry too; returns (rows compared, max
    err)."""
    from helib_tpu_torch.ops.conv import (AUX_MAX_LOG_N, conv_aux_cuda,
                                          conv_aux_plain, launch_rows)
    rows, err = 0, 0
    for n in (8, 64, 2048, 4096, 16384, 32768, 65536):
        for P in (5, 20):
            x, aux, kh, khsh = conv_inputs(n, P, (2,), seed=n + P + 1, dev=dev)
            x = x.movedim(1, 0).contiguous()
            ref = conv_aux_plain(x, aux, kh, khsh)
            runs = [conv_aux_cuda] + ([lambda *a: launch_rows(
                "conv_aux", *a, AUX_MAX_LOG_N, entry="launch_c2")]
                if n == 65536 else [])
            for run in runs:
                got = run(x, aux, kh, khsh)
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


NTT_SIZES = (8, 64, 2048, 4096, 8192, 16384, 32768, 65536)


def check_ntt(dev) -> tuple[int, int]:
    """K2 vs ntt_plain, both directions, bit for bit, at every size (so on
    every shipped configuration: one CTA a row, n = 32768's, the 4-CTA
    cluster at n = 65536); returns (rows compared, max err)."""
    from helib_tpu_torch.ops.ntt_fused import ntt_cuda, ntt_plain
    rows, err = 0, 0
    for n in NTT_SIZES:
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


def check_ntt2(dev) -> tuple[int, int]:
    """K4 vs ntt2_plain and K2's ntt_plain at every k, both directions, bit
    for bit, and equal to K2 at k = 3; returns (rows compared, max err)."""
    from helib_tpu_torch.ops.ntt2 import K_MAX, ntt2_cuda, ntt2_plain
    from helib_tpu_torch.ops.ntt_fused import ntt_cuda, ntt_plain
    rows, err = 0, 0
    for n in NTT_SIZES:
        for P in (5, 20):
            x, t = ntt_inputs(n, P, (2,), seed=n + P + 2, dev=dev)
            for inverse in (False, True):
                ref = ntt_plain(x, t, inverse)
                k2 = ntt_cuda(x, t["flat"], t["q"], inverse)
                for k in range(1, K_MAX + 1):
                    got = ntt2_cuda(x, t["flat"], t["q"], inverse, k)
                    own = ntt2_plain(x, t["flat"], t["q"], inverse, k)
                    torch.cuda.synchronize()
                    e = int((got.long() - ref.long()).abs().max())
                    err = max(err, e)
                    if e or not (torch.equal(got, ref)
                                 and torch.equal(got, own)
                                 and (k < K_MAX or torch.equal(got, k2))):
                        raise AssertionError(f"ntt2 kernel != plain at n={n}"
                                             f" P={P} k={k} "
                                             f"inverse={inverse}")
                    rows += got.numel() // n
    return rows, err


def check_conv2(dev) -> tuple[int, int]:
    """K5 vs conv2_plain and K1's conv_plain at every k, bit for bit;
    returns (rows compared, max err)."""
    from helib_tpu_torch.ops.conv import conv_plain
    from helib_tpu_torch.ops.ntt2 import K_MAX, conv2_cuda, conv2_plain
    rows, err = 0, 0
    for n in CONV_SIZES:
        for P in (5, 20):
            args = conv_inputs(n, P, (2,), seed=n + P + 3, dev=dev)
            ref = conv_plain(*args)
            for k in range(1, K_MAX + 1):
                got = conv2_cuda(*args, k)
                own = conv2_plain(*args, k)
                torch.cuda.synchronize()
                e = int((got.long() - ref.long()).abs().max())
                err = max(err, e)
                if e or not (torch.equal(got, ref) and torch.equal(got, own)):
                    raise AssertionError(f"conv2 kernel != plain at n={n} "
                                         f"P={P} k={k}")
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


def _launch_counters() -> dict:
    """name -> the wrapper whose `.launches` counts that kernel."""
    from helib_tpu_torch.ops import conv, ntt2, ntt_fused, probes
    return {"conv": conv.conv_cuda, "ntt": ntt_fused.ntt_cuda,
            "conv_aux": conv.conv_aux_cuda, "ntt2": ntt2.ntt2_cuda,
            "conv2": ntt2.conv2_cuda, "p1": probes.p1_cuda,
            "p2": probes.p2_cuda}


def reset_launches():
    for fn in _launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _launch_counters().items()}


def expect_only(launches: dict, name: str, what: str):
    """Fails unless `name` launched and no other kernel did."""
    if launches[name] == 0 or any(v for k, v in launches.items()
                                  if k != name):
        raise AssertionError(f"{what} must launch {name} and no other "
                             f"kernel: {launches}")


def check_outputs(out, ctx, batch: int | None, dev):
    """int32 residues of shape [batch, L, N] ([L, N] for batch None), each
    below its prime."""
    q = torch.from_numpy(ctx.qs.astype(np.int64)).to(dev)[:, None]
    shape = (ctx.L, ctx.n_eval) if batch is None else (batch, ctx.L,
                                                       ctx.n_eval)
    for o in out:
        if o.shape != shape or o.dtype != torch.int32:
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
    expect_only(launches, "conv", "BGV path")
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

def ckks_path(dev, params: dict = CKKS, batch: int | None = BATCH,
              scales: tuple = (CKKS["r"], 40), label: str = "ckks path"):
    """The CKKS mult+relin at `params` (batched, or unbatched for batch
    None) through K2 alone; element 0 held to the plain-NTT chain and to the
    port on the host CPU; the decrypt oracle at each scale 2^b of
    `scales`."""
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey, SKHandle
    from helib_tpu_torch.ctxt import Ctxt
    from helib_tpu_torch.ckks import EncryptedArrayCKKS
    from helib_tpu_torch.pipeline import (make_batched_mult_relin,
                                          make_mult_relin, mult_relin,
                                          fresh_noise)
    from helib_tpu_torch.ops import ntt_fused

    t0 = time.time()
    ctx = Context(**params, device=dev)
    sk = SecKey(ctx, seed=CKKS_SEED)
    fn, args = (make_mult_relin(ctx, sk) if batch is None
                else make_batched_mult_relin(ctx, sk, batch))
    torch.cuda.synchronize()
    print(f"{label}: {ctx!r}; setup {time.time() - t0:.1f} s")

    reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"{label}: one {'un' if batch is None else ''}batched call "
          f"launched {launches}")
    expect_only(launches, "ntt", label)
    check_outputs(out, ctx, batch, dev)
    one = list(args) if batch is None else [a[0] for a in args]
    first = list(out) if batch is None else [o[0] for o in out]

    # the same chain on batch element 0 with the plain NTT
    pk = sk.pubkey
    with swap(ntt_fused, "ntt", ntt_fused.ntt_plain):
        before = read_launches()
        ref = mult_relin(ctx, pk, sk, fresh_noise(ctx, pk), ctx.L, *one)
        torch.cuda.synchronize()
        if read_launches() != before:
            raise AssertionError("reference run launched a kernel")
    ref = dict((h.powS, d) for h, d in ref.parts)
    for i in (0, 1):
        if not torch.equal(first[i], ref[i]):
            raise AssertionError(f"part {i}: kernel path != plain path")
    print(f"{label}: batch element 0 bit-identical to the plain-NTT chain")

    # the same element through the port on the host CPU
    t0 = time.time()
    ctx_cpu = Context(**params, device="cpu")
    fn_cpu, _ = make_mult_relin(ctx_cpu, SecKey(ctx_cpu, seed=CKKS_SEED))
    host = fn_cpu(*[a.cpu() for a in one])
    for i in (0, 1):
        if not torch.equal(first[i].cpu(), host[i]):
            raise AssertionError(f"part {i}: GPU != CPU port")
    print(f"{label}: batch element 0 bit-identical to the port on the "
          f"host CPU at m={params['m']} ({time.time() - t0:.1f} s)")
    del ctx_cpu, fn_cpu, host

    # decrypt oracle on the timed function: encrypt two slot vectors, run
    # them through fn, wrap as a Ctxt with scale f1*f2, rescale, decrypt.
    # The mitigated decrypt releases an error of about error_bound(), which
    # at the default scale 2^r = 2^30 is ~0.04 at m=65536: that run is held
    # to 4 x error_bound; a run at scale 2^40 is also held to CKKS_TOL.
    ea = EncryptedArrayCKKS(ctx)
    rng = np.random.default_rng(CKKS_SEED + 1)
    for scale_bits in scales:
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
        print(f"{label}: decrypt oracle at scale 2^{scale_bits}: max "
              f"|err| = {err:.3e}, error_bound = {bound:.3e}, limit "
              f"{tol:.3e} ({ea.nslots} slots, rescaled to k={prod.k})")
        if not err <= tol:
            raise AssertionError("decrypt oracle: product outside tolerance")
    return fn, args, launches, ctx, sk


def ckks_big_path(dev, card: str) -> dict:
    """CKKS at m=131072 (n = 65536, K2 on 4-CTA clusters), unbatched: the
    checks of ckks_path with the decrypt oracle at scale 2^40, then ms per
    call, K2's row on the path's inputs and the clusters resident."""
    from helib_tpu_torch.ops.ntt_fused import ntt_max_clusters
    torch.cuda.reset_peak_memory_stats()
    fn, args, launches, ctx, sk = ckks_path(
        dev, CKKS_BIG, batch=None, scales=(40,), label="ckks m=131072")
    ms = host_ms(lambda: chain(fn, args, 5), 2) / 5
    row = kernel_row(fn, args, launches, "ntt")
    clusters = ntt_max_clusters(dev, 16)
    print(json.dumps({
        "metric": "torch_cuda_ckks_mult_relin_ms_m131072_b440",
        "ms_per_unbatched_call": ms, "kernel": "ntt",
        "kernel_ms_per_launch": row["ms"], "kernel_bound_ms": row["bound_ms"],
        "kernel_plain_ms": row["plain_ms"],
        "kernel_launches_per_call": row["launches"],
        "ntt_clusters_resident_n65536": clusters,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "card": card}))
    return row


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


def keys_on_host(ctx_cpu, sk):
    """The card's secret key, its matrices and its public key carried over
    to a host-CPU context by convert.py."""
    from helib_tpu_torch import convert
    from helib_tpu_torch.ops.modops import to_host

    pk = sk.pubkey
    sk_cpu = convert.seckey_from_arrays(
        ctx_cpu, [{"coeffs": s["coeffs"], "bound": s["bound"],
                   "full": to_host(s["full"])} for s in sk.skeys],
        {key: convert.ksmatrix_arrays(W) for key, W in sk.matrices.items()})
    sk_cpu.pubkey = convert.pubkey_from_arrays(
        ctx_cpu, [((h.powS, h.powX, h.keyID), to_host(d))
                  for h, d in pk.enc_key], pk.enc_noise, pk.sk_bound,
        sk_cpu.matrices)
    return sk_cpu


def rotate_on_host(dev):
    """The rotate at m=32003 and HOST_BITS on the card and through the port
    on the host CPU, with the card's keys carried over by convert.py (the
    matrix of X -> X^3 included): bit-identical."""
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey, PubKey
    from helib_tpu_torch.pipeline import make_automorph_relin

    params = {**BIG, "bits": HOST_BITS}
    ctx = Context(**params, device=dev)
    sk = SecKey(ctx, seed=BIG_SEED)
    PubKey(sk)
    fn, args = make_automorph_relin(ctx, sk)
    out = fn(*args)
    t0 = time.time()
    ctx_cpu = Context(**params, device="cpu")
    sk_cpu = keys_on_host(ctx_cpu, sk)
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
        if any(v for key, v in c.items() if key != "conv_aux") or (
                c["conv_aux"] > 0) != k3:
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
    print(f"perop: K3's n = 65536 kernel: {conv_aux_max_clusters(dev)} "
          f"clusters resident at once")
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
# the BGV slot layer at m=31775 (K3)
# ---------------------------------------------------------------------------

# HElib's small thin-bootstrapping parameters (benchmarks/bgv_thinboot.cpp,
# as tests/test_bootstrap.py cites them): 1200 slots of GF(2^20), hypercube
# [30, 20, 2] with the last dimension bad, B = 65536
SLOTS = dict(m=31775, p=2, r=1, bits=600, c=3, mvec=(31, 25, 41))
SLOTS_SEED, SLOTS_HWT, SLOTS_DATA_SEED = 141, 64, 143
SLOTS_HYPERCUBE = ([30, 20, 2], [True, True, False])
WARM_REPS = 1


def timed(f, reps: int = 1):
    """(f(), host ms, CUDA-event ms): the mean of `reps` runs of f, ended
    by a synchronize."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.time()
    a.record()
    for _ in range(reps):
        out = f()
    b.record()
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3 / reps, a.elapsed_time(b) / reps


def ea_on_host(ea, ctx_cpu):
    """The same EncryptedArray over a host-CPU context: the slot tables
    depend on (m, p, r, mvec) only, so they are shared; of the mask cache
    only the host encodings are kept (the device masks are rebuilt on the
    host when first used)."""
    out = copy.copy(ea)
    out.ctx = ctx_cpu
    out._mask_cache = {k: v for k, v in ea._mask_cache.items()
                       if isinstance(v, np.ndarray)}
    return out


def fat_masks(ea) -> tuple[int, int]:
    """(device masks built, their bytes) in the EA's cache."""
    from helib_tpu_torch.encoded import FatEncodedPtxt
    fats = [v._full for v in ea._mask_cache.values()
            if isinstance(v, FatEncodedPtxt) and v._full is not None]
    return len(fats), sum(t.numel() * t.element_size() for t in fats)


def slot_path(dev, card: str) -> dict:
    """The slot layer at m=31775 through K3 alone: each op driven with the
    counts reset before it and read after, its decrypt held to the PtxtBGV
    oracle exactly; the rotate by 1 held against the plain K3 and, with
    mul_by_constant(fat), against the port on the host CPU; then timed
    warm, and K3's row on the rotate's own inputs."""
    from helib_tpu_torch import convert, ksstrategy
    from helib_tpu_torch.algos.replicate import replicate
    from helib_tpu_torch.algos.sums import total_sums
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.ea import EncryptedArray
    from helib_tpu_torch.encoded import FatEncodedPtxt
    from helib_tpu_torch.keys import SecKey, PubKey
    from helib_tpu_torch.ops import conv as convmod
    from helib_tpu_torch.ptxt import PtxtBGV

    torch.cuda.reset_peak_memory_stats()
    setup = {}
    t0 = time.time()
    ctx = Context(**SLOTS, scheme="bgv", device=dev)
    setup["context_s"] = time.time() - t0
    t0 = time.time()
    sk = SecKey(ctx, seed=SLOTS_SEED, hwt=SLOTS_HWT)
    pk = PubKey(sk)
    ksstrategy.add_relin_matrix(sk)
    ksstrategy.add_some_1d_matrices(sk)
    torch.cuda.synchronize()
    setup["keys_s"] = time.time() - t0
    t0 = time.time()
    ea = EncryptedArray(ctx)
    setup["ea_s"] = time.time() - t0
    pal = ctx.pal
    print(f"slots: {ctx!r}; d={ea.d}, {ea.nslots} slots, fast tables "
          f"{bool(ea._fast)}; {len(sk.matrices)} key-switching matrices; "
          f"setup {json.dumps(setup)}")
    if (pal.orders, pal.native) != SLOTS_HYPERCUBE:
        raise AssertionError(f"slots: hypercube {pal.orders} {pal.native}")

    rng = np.random.default_rng(SLOTS_DATA_SEED)
    a = [int(v) for v in rng.integers(0, ea.pr, ea.nslots)]
    b = [rng.integers(0, ea.pr, ea.d) for _ in range(ea.nslots)]
    pa, pb = PtxtBGV(ea, a), PtxtBGV(ea, b)
    host = {}
    poly_b, host["encode_ms"], _ = timed(lambda: ea.encode(b))
    dec, host["decode_ms"], _ = timed(lambda: ea.decode(poly_b))
    if PtxtBGV(ea, dec) != pb:
        raise AssertionError("slots: decode(encode(b)) != b")

    counts, ms, total = {}, {}, {}
    minted = len(sk.matrices)

    def check(name, ct, want):
        """The decrypt against the oracle: equal coefficient vectors are
        equal slots (encode is a bijection onto the polys mod Phi_m)."""
        if not np.array_equal(sk.decrypt_bgv(ct), ea.encode(want.slots)):
            raise AssertionError(f"slots {name}: decrypt oracle failed")

    def run(name, f, want=None, warm: bool = True):
        """f() once with the counts reset (K3 alone, or nothing), its
        decrypt checked against the oracle; then WARM_REPS times more,
        warm (the counts are of one run)."""
        reset_launches()
        out, cold_h, cold_e = timed(f)
        c = read_launches()
        if any(v for key, v in c.items() if key != "conv_aux"):
            raise AssertionError(f"slots {name}: launched {c}")
        for key, v in c.items():
            total[key] = total.get(key, 0) + v
        if want is not None:
            check(name, out, want)
        ms[name] = {"cold_host": cold_h, "cold_event": cold_e}
        counts[name] = {"cold": c["conv_aux"]}
        if warm:
            reset_launches()
            _, ms[name]["host"], ms[name]["event"] = timed(f, WARM_REPS)
            counts[name]["warm"] = read_launches()["conv_aux"] // WARM_REPS
        return out

    prod = pa.multiply(pb)
    ca = run("encrypt", lambda: ea.encrypt(a, pk, rng), pa)
    # one decrypt decoded in full, against the oracle slot by slot
    if PtxtBGV.decode(ea, sk.decrypt_bgv(ca)) != pa:
        raise AssertionError("slots: decode(decrypt(encrypt(a))) != a")
    cb = ea.encrypt(b, pk, rng)
    c = run("multiply", lambda: ca.multiply(cb, sk), prod)
    enc_b = ea.encode_ptxt(b)
    want = prod.add(pb)
    c2 = run("add_constant", lambda: _plus(c, enc_b), want)
    fat = FatEncodedPtxt(ctx, ea.encode(a), space=ea.pr)
    run("fat_build", lambda: fat.rt(ctx.L, True), warm=False)
    want = want.multiply(pa)
    c3 = run("mul_by_constant", lambda: _times(c2, fat), want)
    mask_cold = fat_masks(ea)
    r1 = run("rotate1", lambda: ea.rotate(c3.copy(), 1, sk), want.rotate(1))
    run("rotate41", lambda: ea.rotate(c3.copy(), 41, sk), want.rotate(41))
    run("shift_1d", lambda: ea.shift_1d(c3.copy(), 2, 1, sk),
        _shift_1d(want, 2, 1))
    masks_before = fat_masks(ea)
    run("total_sums", lambda: total_sums(ea, c3.copy(), sk),
        want.total_sums())
    masks = {"before_rotations": mask_cold, "before_total_sums":
             masks_before, "after_total_sums": fat_masks(ea)}
    rep = want.copy()
    rep.slots = [want.slots[7].copy() for _ in want.slots]
    run("replicate", lambda: replicate(ea, c3.copy(), 7, sk), rep)
    expect_only(total, "conv_aux", "slot phase")
    if len(sk.matrices) != minted:
        raise AssertionError(f"slots: {len(sk.matrices) - minted} matrices "
                             f"minted during the ops")
    print(f"slots: K3 launches per op {json.dumps(counts)}; matrices "
          f"minted during the ops: {len(sk.matrices) - minted}")
    for name, v in ms.items():
        print(f"slots: {name} " + ", ".join(f"{k} {x:.3f} ms"
                                            for k, x in v.items()))

    # the rotate by 1 with the plain K3 (its masks rebuilt plain too)
    saved = ea._mask_cache
    ea._mask_cache = {k: v for k, v in saved.items()
                      if isinstance(v, np.ndarray)}
    with swap(convmod, "conv_aux", convmod.conv_aux_plain):
        reset_launches()
        ref = ea.rotate(c3.copy(), 1, sk)
        torch.cuda.synchronize()
        if any(read_launches().values()):
            raise AssertionError("reference run launched a kernel")
    ea._mask_cache = saved
    same_parts(r1, ref, "rotate by 1: kernel path != plain path")
    print("slots: rotate by 1 bit-identical to the plain-K3 chain")

    # the rotate by 1 and mul_by_constant(fat) on the host CPU
    t0 = time.time()
    ctx_cpu = Context(**SLOTS, scheme="bgv", device="cpu")
    sk_cpu = keys_on_host(ctx_cpu, sk)
    ea_cpu = ea_on_host(ea, ctx_cpu)
    c2_cpu = convert.ctxt_from_arrays(ctx_cpu, sk_cpu.pubkey,
                                      **convert.ctxt_arrays(c2))
    c3_cpu = convert.ctxt_from_arrays(ctx_cpu, sk_cpu.pubkey,
                                      **convert.ctxt_arrays(c3))
    t1 = time.time()
    same_parts(c3, _times(c2_cpu, FatEncodedPtxt(ctx_cpu, ea.encode(a),
                                                 space=ea.pr)),
               "mul_by_constant(fat): GPU != CPU port")
    t2 = time.time()
    same_parts(r1, ea_cpu.rotate(c3_cpu, 1, sk_cpu),
               "rotate by 1: GPU != CPU port")
    print(f"slots: rotate by 1 and mul_by_constant(fat) bit-identical to "
          f"the port on the host CPU at bits={ctx.bits} (setup "
          f"{t1 - t0:.1f} s, mul {t2 - t1:.1f} s, rotate "
          f"{time.time() - t2:.1f} s on {torch.get_num_threads()} threads)")

    profile(lambda: ea.rotate(c3.copy(), 1, sk), (),
            "bgv slots m=31775 rotate by 1, warm")
    row = kernel_row(lambda: ea.rotate(c3.copy(), 1, sk), (),
                     {"conv_aux": counts["rotate1"]["warm"]},
                     "conv_aux")
    print(json.dumps({"metric": "torch_cuda_bgv_slots_m31775_b600",
                      "setup_s": setup, "host_ms": host, "ms_per_op": ms,
                      "conv_aux_launches_per_op": counts,
                      "fat_masks_count_bytes": masks,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "conv_aux_row_rotate1": row, "card": card}))
    return row, (ctx, sk, pk, ea)


def _plus(ct, c):
    out = ct.copy()
    out.add_constant(c)
    return out


def _times(ct, c):
    out = ct.copy()
    out.mul_by_constant(c)
    return out


def _shift_1d(pt, dim: int, amt: int):
    """PtxtBGV oracle of EncryptedArray.shift_1d by amt > 0: rotate along
    dim, zero the slots whose coordinate came in from below."""
    pal = pt.ea.ctx.pal
    out = pt.rotate_1d(dim, amt)
    for s in range(pt.ea.nslots):
        if pal.coords(s)[dim] < amt:
            out.slots[s] = np.zeros(pt.ea.d, dtype=np.int64)
    return out


def same_parts(a, b, what: str):
    """Equal prime sets and residues, part by part, on any devices."""
    if (a.k, a.special, [h for h, _ in a.parts]) != (
            b.k, b.special, [h for h, _ in b.parts]) or not all(
            torch.equal(x.cpu(), y.cpu())
            for (_, x), (_, y) in zip(a.parts, b.parts)):
        raise AssertionError(f"slots {what}")


# ---------------------------------------------------------------------------
# BGV bootstrapping at m=31775 and m=1271 (K3)
# ---------------------------------------------------------------------------

# HElib's bgv_thinboot / bgv_fatboot "tiny" size (benchmarks/thinboot_bench.py)
BOOT_TINY = dict(m=1271, p=2, r=1, bits=600, c=3, mvec=(31, 41))
BOOT_HWT, BOOT_TINY_SEED, BOOT_TINY_DATA_SEED = 64, 131, 133
BOOT_WARM_REPS = 2
# ms of the kernel row: at most this many of the path's K3 inputs are kept
ROW_SAMPLES = 24
# the thin bootstrap's stages, in the order thin_recrypt runs them
BOOT_STAGES = ("slotToCoeff", "relinearize to the recryption key",
               "raw mod switch and make-divisible", "re-encrypt",
               "coeffToSlot and trace", "extract_digits_thin")


class timers:
    """Context manager wrapping module or class attributes so each call's
    host time (ended by a synchronize) adds to `.s[name]`."""

    def __init__(self, *targets):
        self.targets, self.s, self.saved = targets, {}, []

    def __enter__(self):
        for obj, attr, name in self.targets:
            orig = getattr(obj, attr)

            def wrapped(*a, _orig=orig, _name=name, **kw):
                t0 = time.time()
                out = _orig(*a, **kw)
                torch.cuda.synchronize()
                self.s[_name] = self.s.get(_name, 0.0) + time.time() - t0
                return out
            self.saved.append((obj, attr, orig))
            setattr(obj, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for obj, attr, orig in reversed(self.saved):
            setattr(obj, attr, orig)


class stage_marks:
    """Host-clock marks at the start of each stage of thin_recrypt (a
    synchronize first), from wrappers around the calls that begin them;
    `.ms()` gives each stage's ms (the re-encrypt begins where the last
    Phi_m projection ends)."""

    def __init__(self, rec, rc):
        from helib_tpu_torch.ctxt import Ctxt
        self.t = {}

        def mark(name):
            torch.cuda.synchronize()
            self.t[name] = time.time()

        def at_start(fn, name, when=lambda *a, **kw: True):
            def wrapped(*a, **kw):
                if when(*a, **kw):
                    mark(name)
                return fn(*a, **kw)
            return wrapped

        def at_end(fn, name):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                mark(name)
                return out
            return wrapped
        names = BOOT_STAGES
        self.swaps = [
            swap(rc.slot_to_coeff, "apply",
                 at_start(rc.slot_to_coeff.apply, names[0])),
            swap(Ctxt, "relinearize", at_start(
                Ctxt.relinearize, names[1],
                lambda self, key, to_key=0: to_key != 0)),
            swap(rec, "raw_mod_switch", at_start(rec.raw_mod_switch,
                                                 names[2])),
            swap(rec, "_phim_project", at_end(rec._phim_project, names[3])),
            swap(rc.coeff_to_slot, "apply",
                 at_start(rc.coeff_to_slot.apply, names[4])),
            swap(rec, "extract_digits_thin",
                 at_start(rec.extract_digits_thin, names[5]))]
        self.mark = mark

    def __enter__(self):
        for sw in self.swaps:
            sw.__enter__()
        return self

    def __exit__(self, *exc):
        self.mark("end")
        for sw in reversed(self.swaps):
            sw.__exit__(*exc)

    def ms(self) -> dict:
        order = list(BOOT_STAGES) + ["end"]
        return {a: (self.t[b] - self.t[a]) * 1e3
                for a, b in zip(order, order[1:])}


def all_fats(*objs) -> list:
    """Every FatEncodedPtxt held by the EncryptedArrays' mask caches and by
    the maps' stage executors (their cached diagonals)."""
    from helib_tpu_torch.encoded import FatEncodedPtxt
    out, seen = [], set()

    def add(v):
        if isinstance(v, FatEncodedPtxt) and id(v) not in seen:
            seen.add(id(v))
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                add(x)
        elif isinstance(v, dict):
            for x in v.values():
                add(x)
    for o in objs:
        if hasattr(o, "_mask_cache"):
            add(o._mask_cache)
        for ex in getattr(o, "_execs", []):
            add(getattr(ex, "_fat_cache", ex))
        add(getattr(o, "terms", []))
    return out


class plain_fats:
    """The FatEncodedPtxts' device tensors dropped for the duration, so a
    run rebuilds them (under the plain K3 when that is swapped in), then
    restored."""

    def __init__(self, fats):
        self.fats = fats

    def __enter__(self):
        self.saved = [f._full for f in self.fats]
        for f in self.fats:
            f._full = None

    def __exit__(self, *exc):
        for f, full in zip(self.fats, self.saved):
            f._full = full


def sampled_kernel_row(fn, launches: int, name: str = "conv_aux") -> dict:
    """kernel_row on a sample of at most ROW_SAMPLES of the inputs a run of
    fn() gives the kernel (every launches // ROW_SAMPLES-th call; keeping
    all of a bootstrap's inputs would hold gigabytes)."""
    mod, attr = kernel_table()[name][:2]
    orig, kept, count = getattr(mod, attr), [], [0]
    step = max(1, launches // ROW_SAMPLES)

    def rec(*args):
        if count[0] % step == 0 and len(kept) < ROW_SAMPLES:
            kept.append(args)
        count[0] += 1
        return orig(*args)
    with swap(mod, attr, rec):
        fn()
    torch.cuda.synchronize()
    if count[0] != launches:
        raise AssertionError(f"sample run made {count[0]} {name}s, not "
                             f"{launches}")
    return {**row_on(kept, launches, name), "sampled_inputs": len(kept),
            "shapes": sorted({str(tuple(a[0].shape)) for a in kept})}


def boot_setup(ctx, sk, ea, fat: bool = False):
    """RecryptData (or FatRecryptData) with its setup split by host timers
    around the calls it makes: the big-space EncryptedArray, the maps and
    ekey."""
    from helib_tpu_torch import recryption as rec
    cls = rec.FatRecryptData if fat else rec.RecryptData
    with timers((rec, "EncryptedArray", "ea_big_s"),
                (cls, "_build_maps", "maps_s"),
                (rec, "_encrypt_with_space", "ekey_s")) as tm:
        t0 = time.time()
        rc = cls(ctx, sk, ea, hwt=BOOT_HWT)
        torch.cuda.synchronize()
    return rc, {"total_s": time.time() - t0, **tm.s}


def boot_check(name, ea, sk, low, out, slots, key, fat: bool = False):
    """The bootstrap's output: decrypts to the input slots (equal
    coefficient vectors are equal slots), is correct, gained more than 30
    bits of capacity, and a multiply after it decrypts to the slot-wise
    product."""
    want = ea.encode(slots)
    if not np.array_equal(sk.decrypt_bgv(out), want):
        raise AssertionError(f"boot {name}: decrypt != input slots")
    if not out.is_correct() or out.capacity() <= low.capacity() + 30:
        raise AssertionError(f"boot {name}: capacity {low.capacity():.1f} "
                             f"-> {out.capacity():.1f}")
    if fat:
        return out.capacity()
    sq = out.multiply(out, key)
    prod = [int(a) * int(a) % ea.pr for a in slots]
    if not np.array_equal(sk.decrypt_bgv(sq), ea.encode(prod)):
        raise AssertionError(f"boot {name}: multiply after the bootstrap")
    return out.capacity()


def boot_path(ctx, sk, pk, ea, card: str) -> dict:
    """Phase 13: the thin bootstrap at m=31775 on phase 12's context and
    keys, through K3 alone."""
    from helib_tpu_torch import recryption as rec
    from helib_tpu_torch.ops import conv as convmod

    torch.cuda.reset_peak_memory_stats()
    rc, setup = boot_setup(ctx, sk, ea)
    fft = ctx.m * (rc.big_space / 2.0) ** 2 < 2.0 ** 44
    print(f"boot: {rc!r} at m={ctx.m}; big-space EA mod 2^"
          f"{rc.ea_big.r}; the Phi_m projection takes the "
          f"{'float64 FFT' if fft else 'exact int64'} branch; setup "
          f"{json.dumps(setup)}")
    rng = np.random.default_rng(SLOTS_DATA_SEED)
    slots = [int(v) for v in rng.integers(0, ctx.ptxt_space, ea.nslots)]
    low = ea.encrypt(slots, pk, rng)
    low.bring_to_k(3)

    def run(name, key, reps=1):
        reset_launches()
        out, h, e = timed(lambda: rec.thin_recrypt(low, rc, key), reps)
        c = read_launches()
        expect_only(c, "conv_aux", f"boot {name}")
        cap = boot_check(name, ea, sk, low, out, slots, key)
        return out, {"host_ms": h, "event_ms": e,
                     "conv_aux": c["conv_aux"] // reps, "capacity": cap}

    _, cold = run("cold", sk)
    minted = len(sk.matrices)
    # the device constants the bootstrap reads (with phase 12's masks)
    fats = all_fats(ea, rc.ea_big, rc.slot_to_coeff, rc.coeff_to_slot)
    info = {"capacity_in": low.capacity(), "matrices_minted": minted,
            "matrix_bytes": sum(t.numel() * t.element_size()
                                for W in sk.matrices.values()
                                for t in W.b + W.a),
            "device_constants_count_bytes": (
                len(fats), sum(f._full.numel() * 4 for f in fats
                               if f._full is not None))}
    out_warm, warm = run("warm (PubKey)", pk, BOOT_WARM_REPS)
    if len(sk.matrices) != minted:
        raise AssertionError("boot: the PubKey runs minted a matrix")
    print(f"boot: cold {json.dumps(cold)}; {minted} matrices minted "
          f"({info['matrix_bytes'] / 2**20:.1f} MiB); warm, the mean of "
          f"{BOOT_WARM_REPS} PubKey runs, {json.dumps(warm)}; decrypts, "
          f"capacity and the multiply after it checked on both")

    # one warm run both timed per stage and sampled for K3's row
    marks = stage_marks(rec, rc)

    def staged():
        with marks:
            rec.thin_recrypt(low, rc, pk)
    row = sampled_kernel_row(staged, warm["conv_aux"])
    stages = marks.ms()
    print("boot: host ms per stage " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items()))

    # one warm bootstrap with the plain K3, its diagonals rebuilt plain too
    with swap(convmod, "conv_aux", convmod.conv_aux_plain), plain_fats(fats):
        reset_launches()
        ref = rec.thin_recrypt(low, rc, pk)
        torch.cuda.synchronize()
        if any(read_launches().values()):
            raise AssertionError("reference run launched a kernel")
    same_parts(out_warm, ref, "boot: kernel path != plain path")
    print(f"boot: warm bootstrap bit-identical to the plain-K3 chain "
          f"({len(fats)} device constants rebuilt plain)")

    t0 = time.time()
    profile(lambda: rec.thin_recrypt(low, rc, pk), (),
            "bgv thin bootstrap m=31775, warm")
    print(f"boot: the profile took {time.time() - t0:.1f} s")
    print(json.dumps({"metric": "torch_cuda_bgv_thinboot_m31775_b600",
                      "e": rc.e, "ePrime": rc.ePrime, "setup_s": setup,
                      "cold": cold, "warm": warm, "stage_ms": stages,
                      **info, "conv_aux_row": row,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "card": card}))
    return row


def tiny_boot_path(dev, card: str) -> dict:
    """Phase 14: thin and fat bootstraps at m=1271 through K3 alone; the
    thin one held against the port on the host CPU at the full 600
    bits."""
    from helib_tpu_torch import convert, recryption as rec
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.ea import EncryptedArray
    from helib_tpu_torch.keys import SecKey, PubKey

    res = {}

    def drive(fat: bool):
        """Setup, a cold run with the SecKey and a warm one with the PubKey,
        each checked; returns what the thin checks below need."""
        name = "fat" if fat else "thin"
        t0 = time.time()
        ctx = Context(**BOOT_TINY, scheme="bgv", device=dev)
        sk = SecKey(ctx, seed=BOOT_TINY_SEED, hwt=BOOT_HWT)
        pk, ea = PubKey(sk), EncryptedArray(ctx)
        r = res[name] = {"context_keys_ea_s": time.time() - t0}
        rc, r["setup_s"] = boot_setup(ctx, sk, ea, fat)
        rng = np.random.default_rng(BOOT_TINY_DATA_SEED)
        if fat:
            slots = [rng.integers(0, ea.pr, ea.d) for _ in range(ea.nslots)]
        else:
            slots = [int(v) for v in rng.integers(0, ea.pr, ea.nslots)]
        low = ea.encrypt(slots, pk, rng)
        low.bring_to_k(3)
        fn = rec.fat_recrypt if fat else rec.thin_recrypt
        for which, key in (("cold", sk), ("warm", pk)):
            n = len(sk.matrices)
            reset_launches()
            out, h, e = timed(lambda: fn(low, rc, key))
            c = read_launches()
            expect_only(c, "conv_aux", f"boot m=1271 {name} {which}")
            if which == "warm" and len(sk.matrices) != n:
                raise AssertionError("boot m=1271: the PubKey run minted")
            cap = boot_check(f"m=1271 {name} {which}", ea, sk, low, out,
                             slots, key, fat)
            r[which] = {"host_ms": h, "event_ms": e,
                        "conv_aux": c["conv_aux"], "capacity": cap}
        r["matrices_minted"] = len(sk.matrices)
        print(f"boot m=1271 {name}: {rc!r}; {json.dumps(r)}; decrypts "
              f"exactly, capacity {low.capacity():.1f} -> "
              f"{out.capacity():.1f}")
        return rc, sk, ea, low, out

    torch.cuda.reset_peak_memory_stats()
    rc, sk, ea, low, out = drive(fat=False)
    # the warm thin bootstrap on the host CPU: slot tables shared, keys and
    # the recryption state carried over by convert.py
    t0 = time.time()
    ctx_cpu = Context(**BOOT_TINY, scheme="bgv", device="cpu")
    sk_cpu = keys_on_host(ctx_cpu, sk)
    rc_cpu = rec.RecryptData(ctx_cpu, sk_cpu, ea_on_host(ea, ctx_cpu),
                             hwt=BOOT_HWT)
    convert.load_recrypt_state(rc_cpu, sk_cpu, convert.recrypt_state(rc, sk))
    low_cpu = convert.ctxt_from_arrays(ctx_cpu, sk_cpu.pubkey,
                                       **convert.ctxt_arrays(low))
    t1 = time.time()
    host = rec.thin_recrypt(low_cpu, rc_cpu, sk_cpu.pubkey)
    same_parts(out, host, "boot m=1271 thin: GPU != CPU port")
    print(f"boot m=1271 thin: warm bootstrap bit-identical to the port on "
          f"the host CPU at bits={BOOT_TINY['bits']} (setup {t1 - t0:.1f} s, "
          f"bootstrap {time.time() - t1:.1f} s on {torch.get_num_threads()} "
          f"threads)")
    row = sampled_kernel_row(lambda: rec.thin_recrypt(low, rc, sk.pubkey),
                             res["thin"]["warm"]["conv_aux"])
    del rc, sk, ea, low, out, rc_cpu, sk_cpu
    gc.collect()
    torch.cuda.empty_cache()
    drive(fat=True)
    print(json.dumps({"metric": "torch_cuda_bgv_boot_m1271_b600", **res,
                      "conv_aux_row_thin": row,
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
    """Device time of one call by kernel name (torch.profiler, the card's
    activity alone), and the call's wall time: the share of the call the
    device is busy.  The raw kernel events are summed here: key_averages()
    takes minutes over a bootstrap's ~4e5 launches."""
    from torch.profiler import profile as prof, ProfilerActivity
    fn(*args)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        t0 = time.time()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.time() - t0
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict = {}
    for e in p.profiler.kineto_results.events():
        if e.device_type() == cuda and e.duration_ns() > 0:
            count, ns = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (count + 1, ns + e.duration_ns())
    rows = sorted(((k, c, ns / 1e6) for k, (c, ns) in by_name.items()),
                  key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    print(f"profile ({label}): one call {wall * 1e3:.3f} ms wall, device "
          f"busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f} %), "
          f"{sum(r[1] for r in rows)} kernel launches")
    for key, count, ms in rows[:top]:
        print(f"  {ms:9.3f} ms {count:5d}x  {key[:90]}")


def kernel_table() -> dict:
    """name -> (module, attribute the path calls, source, the TPU kernel it
    replaces, kernel, plain version, bound)."""
    from helib_tpu_torch.ops import conv as convmod, ntt_fused, ntt2
    conv_bound = lambda x, aux, kh, khsh: conv_bound_ms(x, kh)  # noqa: E731
    ntt_bound = lambda x, t, inv: ntt_bound_ms(x, inv)  # noqa: E731
    return {
        "conv": (convmod, "conv", "helib_tpu_torch/ops/csrc/conv.cu",
                 "helib_tpu/ops/pallas_ntt.py:452", convmod.conv_cuda,
                 convmod.conv_plain, conv_bound),
        "ntt": (ntt_fused, "ntt", "helib_tpu_torch/ops/csrc/ntt.cu",
                "helib_tpu/ops/pallas_ntt.py:396",
                lambda x, t, inv: ntt_fused.ntt_cuda(x.contiguous(),
                                                     t["flat"], t["q"], inv),
                ntt_fused.ntt_plain, ntt_bound),
        "conv_aux": (convmod, "conv_aux",
                     "helib_tpu_torch/ops/csrc/conv_aux.cu",
                     "helib_tpu/ops/pallas_ntt.py:527", convmod.conv_aux_cuda,
                     convmod.conv_aux_plain, conv_bound),
        # the v2 kernels at the composite size the path ran (ntt_v2())
        "ntt2": (ntt_fused, "ntt", "helib_tpu_torch/ops/csrc/ntt2.cu",
                 "helib_tpu/ops/pallas_ntt2.py:211",
                 lambda x, t, inv: ntt2.ntt2_cuda(
                     x.contiguous(), t["flat"], t["q"], inv, ntt2.ntt_v2()[1]),
                 lambda x, t, inv: ntt2.ntt2_plain(
                     x, t["flat"], t["q"], inv, ntt2.ntt_v2()[1]),
                 ntt_bound),
        "conv2": (convmod, "conv", "helib_tpu_torch/ops/csrc/ntt2.cu",
                  "helib_tpu/ops/pallas_ntt2.py:245",
                  lambda *a: ntt2.conv2_cuda(*a, ntt2.ntt_v2()[1]),
                  lambda *a: ntt2.conv2_plain(*a, ntt2.ntt_v2()[1]),
                  conv_bound),
    }


def kernel_row(fn, args, launches: dict, name: str) -> dict:
    """Times one kernel on the inputs its path gave it: the kernel, its
    plain version and the bound, averaged over the path's launches.  Each
    of those launches is also held to the plain version bit for bit."""
    mod, attr = kernel_table()[name][:2]
    with capture(mod, attr) as cap:
        fn(*args)
    torch.cuda.synchronize()
    if len(cap.calls) != launches[name]:
        raise AssertionError(f"capture run made another number of {name}s")
    return row_on(cap.calls, launches[name], name)


def row_on(calls, launches: int, name: str) -> dict:
    """The kernel's row on the given inputs: ms, plain ms and bound averaged
    over them, each held to the plain version bit for bit; `launches` is
    the count the path made."""
    _, _, src, replaces, kernel, plain, bound = kernel_table()[name]
    ms = plain_ms = bb = bo = 0.0
    err = 0
    for a in calls:
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
    n = len(calls)
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
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


# ---------------------------------------------------------------------------
# the v2 schedule on both batched paths (K4, K5)
# ---------------------------------------------------------------------------

def set_v2(on: bool):
    """HELIB_NTT_V2=1 (composites of K_MAX: HELIB_NTT_V2_K unset) or off."""
    os.environ.pop("HELIB_NTT_V2_K", None)
    if on:
        os.environ["HELIB_NTT_V2"] = "1"
    else:
        os.environ.pop("HELIB_NTT_V2", None)


def per_k_ms(fn, args, name: str, v1: str) -> tuple[dict, float]:
    """The v2 kernel `name` at every composite size k, and the v1 kernel,
    each timed on every input the path gives it (mean per launch)."""
    from helib_tpu_torch.ops import ntt2
    table = kernel_table()
    mod, attr = table[name][:2]
    with capture(mod, attr) as cap:
        fn(*args)
    torch.cuda.synchronize()
    if name == "ntt2":
        def kern(k, x, t, inv):
            return ntt2.ntt2_cuda(x.contiguous(), t["flat"], t["q"], inv, k)
    else:
        def kern(k, *a):
            return ntt2.conv2_cuda(*a, k)
    by_k = {k: sum(event_ms(lambda: kern(k, *a)) for a in cap.calls)
            / len(cap.calls) for k in range(1, ntt2.K_MAX + 1)}
    v1_ms = sum(event_ms(lambda: table[v1][4](*a)) for a in cap.calls) \
        / len(cap.calls)
    return by_k, v1_ms


def v2_path(fn, args, name: str, v1: str, label: str, metric: str,
            card: str) -> dict:
    """The path of fn with HELIB_NTT_V2=1 on the same inputs: only `name`
    launches, the outputs equal the default run's bit for bit; then its
    timing, profile, kernel row and per-k times, and the default run timed
    again after it (default, v2, default in one call)."""
    base = fn(*args)
    torch.cuda.synchronize()
    set_v2(True)
    try:
        reset_launches()
        out = fn(*args)
        torch.cuda.synchronize()
        launches = read_launches()
        print(f"{label} v2: one batched call launched {launches}")
        expect_only(launches, name, f"{label} path under HELIB_NTT_V2=1")
        if not all(torch.equal(a, b) for a, b in zip(out, base)):
            raise AssertionError(f"{label} v2: output != default run")
        print(f"{label} v2: bit-identical to the default ({v1}) run")
        row = measure(fn, args, launches, name, metric, f"{label} v2", card)
        by_k, v1_ms = per_k_ms(fn, args, name, v1)
        print(json.dumps({"metric": f"torch_cuda_{name}_ms_per_launch_by_k",
                          "path": label, "ms_by_k": by_k,
                          f"{v1}_ms_same_inputs": v1_ms, "card": card}))
    finally:
        set_v2(False)
    print(json.dumps({"metric": f"{metric}_default_again", **timing(fn, args),
                      "card": card}))
    return row


# ---------------------------------------------------------------------------
# the CKKS rotation family at m=65536 (K2, and K4 under v2)
# ---------------------------------------------------------------------------

ROT_SCALE_BITS = 40


def rotation_path(ctx, sk, card: str):
    """rotate by 1 and 5, conjugate, shift by 1, real and imaginary part of
    one ciphertext, once through K2 and once through K4 (bit-identical),
    each with a decrypt oracle; ms per op on the host clock (ended by a
    synchronize) and between CUDA events, and launches per op."""
    from helib_tpu_torch.ckks import EncryptedArrayCKKS

    ea = EncryptedArrayCKKS(ctx)
    rng = np.random.default_rng(CKKS_SEED + 3)
    z = rng.uniform(-1, 1, ea.nslots) + 1j * rng.uniform(-1, 1, ea.nslots)
    ct = ea.encrypt(z, sk.pubkey, rng, scale=1 << ROT_SCALE_BITS)

    def shifted(v):
        out = np.roll(v, 1)
        out[0] = 0
        return out

    ops = {"rotate1": (lambda c: ea.rotate(c.copy(), 1, sk),
                       lambda v: np.roll(v, 1)),
           "rotate5": (lambda c: ea.rotate(c.copy(), 5, sk),
                       lambda v: np.roll(v, 5)),
           "conjugate": (lambda c: c.copy().conjugate(sk), np.conj),
           "shift1": (lambda c: ea.shift(c, 1, sk), shifted),
           "real": (lambda c: ea.extract_real_part(c, sk),
                    lambda v: np.real(v) + 0j),
           "imag": (lambda c: ea.extract_imaginary_part(c, sk),
                    lambda v: np.imag(v) + 0j)}
    torch.cuda.reset_peak_memory_stats()
    outs, counts, ms, device_ms = {}, {}, {}, {}
    for v2, kname in ((False, "ntt"), (True, "ntt2")):
        set_v2(v2)
        try:
            for op, (f, want) in ops.items():
                reset_launches()
                out = f(ct)
                torch.cuda.synchronize()
                counts[f"{op}/{kname}"] = c = read_launches()
                expect_only(c, kname, f"rotation {op}")
                got = ea.decrypt(out, sk)
                err = float(np.max(np.abs(got - want(z))))
                tol = min(CKKS_TOL, 4 * out.error_bound())
                print(f"rotations ({kname}): {op} decrypt max |err| = "
                      f"{err:.3e}, limit {tol:.3e}, {c[kname]} launches")
                if not err <= tol:
                    raise AssertionError(f"rotation {op}: decrypt oracle")
                outs[op, v2] = out

                def go(f=f):
                    f(ct)
                    torch.cuda.synchronize()
                ms[f"{op}/{kname}"] = host_ms(go, 3)
                device_ms[f"{op}/{kname}"] = event_ms(lambda: f(ct), reps=3,
                                                      warm=1)
        finally:
            set_v2(False)
    for op in ops:
        a, b = outs[op, False], outs[op, True]
        if (a.k, a.ratFactor) != (b.k, b.ratFactor) or not all(
                torch.equal(x, y) for (_, x), (_, y) in zip(a.parts,
                                                            b.parts)):
            raise AssertionError(f"rotation {op}: K4 run != K2 run")
    print(f"rotations: every op bit-identical through K2 and K4 "
          f"({ea.nslots} slots, scale 2^{ROT_SCALE_BITS})")
    for op, v in ms.items():
        print(f"rotations: {op} {v:.3f} ms ({device_ms[op]:.3f} ms between "
              f"CUDA events)")
    print(json.dumps({
        "metric": "torch_cuda_ckks_rotation_ms_m65536_b440",
        "ms_per_op": ms, "event_ms_per_op": device_ms,
        "launches_per_op": {k: {n: v for n, v in c.items() if v}
                            for k, c in counts.items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "card": card}))


# ---------------------------------------------------------------------------
# the cost probes (P1, P2)
# ---------------------------------------------------------------------------

PROBE_ROWS, PROBE_N, P1_CHAIN, P2_CHAIN = 160, 16384, 50, 100


def probe_bound_ms(kind: str, variant: str, R: int, n: int):
    """(bytes bound, multiplies bound) in ms of one application: x read and
    out written once, the twiddles the variant reads once; 3 32-bit
    multiplies a Shoup product."""
    from helib_tpu_torch.ops import probes
    words, h = R * n, n // 2
    if kind == "p1":
        if variant == "mul":
            tab, muls = 2 * words, probes.MULS * words
        else:
            used = h if variant in ("bfly", "stage_w") \
                else probes.p1_blocks(variant)
            tab, muls = 2 * R * used, probes.ROUNDS * R * h
        nbytes = 4 * (2 * words + tab + R)
    else:
        lo, hi = probes.p2_range(variant, n.bit_length() - 1)
        nbytes = 4 * (2 * words + 2 * 3 * ((1 << hi) - (1 << lo)) + 3)
        muls = 2 * (hi - lo) * R * h
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            3 * muls / INT32_MUL_PER_S * 1e3)


def probe_path(dev, card: str) -> list:
    """Each probe against its plain version on the card, then the chained
    probe run (counts reset before, read after) and the timings; K1 and K5
    per row at the same n for comparison.  Returns the P1 and P2 rows."""
    from helib_tpu_torch.ops import probes, ntt2
    from helib_tpu_torch.ops.conv import conv_cuda
    from helib_tpu_torch.ops.ntt import aux_primes, aux_tree
    from helib_tpu_torch.ops.modops import shoup, to_device

    R, n = PROBE_ROWS, PROBE_N
    qrow = aux_primes()[np.arange(R) % 3].astype(np.uint32)
    rng = np.random.default_rng(0)
    x = rng.integers(0, qrow[:, None].astype(np.int64), (R, n))
    w = rng.integers(1, qrow[:, None].astype(np.int64), (R, n))
    wsh = shoup(w.astype(np.uint32), qrow[:, None].astype(np.uint64))
    X, W, WS, Q = (to_device(a.astype(np.uint32), dev)
                   for a in (x, w, wsh, qrow[:, None]))
    aux = aux_tree(n, dev)["aux"]
    probe = {"p1": (probes.P1_VARIANTS, P1_CHAIN, probes.p1_cuda,
                    probes.p1_plain, (W, WS, Q)),
             "p2": (probes.P2_PHASES, P2_CHAIN, probes.p2_cuda,
                    probes.p2_plain, (aux["tw_all"], aux["tw_all_sh"],
                                      aux["q"].reshape(3, 1)))}

    def chained(run, v, args, count):
        o = X
        for _ in range(count):
            o = run(v, o, *args)
        return o

    # on the card against the plain versions, one application and a chain
    for kind, (variants, count, run, plain, args) in probe.items():
        for v in variants:
            got, ref = run(v, X, *args), plain(v, X, *args)
            if not torch.equal(got, ref):
                raise AssertionError(f"{kind} {v}: kernel != plain")
            o = X
            for _ in range(3):
                o = plain(v, o, *args)
            if not torch.equal(chained(run, v, args, 3), o):
                raise AssertionError(f"{kind} {v}: chained kernel != plain")
    print(f"probes: P1 ({len(probes.P1_VARIANTS)} variants) and P2 "
          f"({len(probes.P2_PHASES)} phases) == plain bit for bit on "
          f"[{R}, {n}]")

    reset_launches()
    for kind, (variants, count, run, _, args) in probe.items():
        for v in variants:
            chained(run, v, args, count)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"probes: the probe run launched {launches}")
    if not (launches["p1"] == len(probe["p1"][0]) * P1_CHAIN
            and launches["p2"] == len(probe["p2"][0]) * P2_CHAIN) or any(
                v for k, v in launches.items() if k not in ("p1", "p2")):
        raise AssertionError("probe run: unexpected launches")

    # K1 (and K5) per row at n = 16384 on 162 rows
    args1 = conv_inputs(n, 54, (1,), seed=7, dev=dev)
    rows1 = args1[0].numel() // n
    k1_us = event_ms(lambda: conv_cuda(*args1)) / rows1 * 1e3
    k5_us = event_ms(lambda: ntt2.conv2_cuda(*args1)) / rows1 * 1e3
    print(f"probes: per row at n={n}: K1 {k1_us:.3f} us, K5 (k="
          f"{ntt2.K_MAX}) {k5_us:.3f} us")

    rows, detail = [], {}
    replaces = {"p1": "benchmarks/kernel_parts.py:26",
                "p2": "benchmarks/kernel_phases.py:31"}
    for kind, (variants, count, run, plain, args) in probe.items():
        tot = tot_plain = bb = bo = 0.0
        for v in variants:
            app = event_ms(lambda: chained(run, v, args, count), reps=3,
                           warm=1) / count
            pl = event_ms(lambda: plain(v, X, *args), reps=2, warm=1)
            b, o = probe_bound_ms(kind, v, R, n)
            detail[f"{kind}/{v}"] = {"us_per_app": app * 1e3,
                                     "us_per_row": app * 1e3 / R,
                                     "bound_us": max(b, o) * 1e3,
                                     "bound_by": "bytes" if b >= o
                                     else "operations",
                                     "plain_us": pl * 1e3}
            print(f"probes: {kind} {v:9s} {app * 1e3:9.2f} us/app "
                  f"{app * 1e3 / R:7.3f} us/row, bound {max(b, o) * 1e3:8.2f}"
                  f" us ({'bytes' if b >= o else 'operations'}), plain "
                  f"{pl * 1e3:10.1f} us")
            tot, tot_plain, bb, bo = tot + app, tot_plain + pl, bb + b, bo + o
        nv = len(variants)
        rows.append({"name": kind, "route": "cuda",
                     "source": "helib_tpu_torch/ops/csrc/probes.cu",
                     "replaces": replaces[kind], "launches": launches[kind],
                     "max_abs_err": 0, "ms": tot / nv,
                     "plain_ms": tot_plain / nv, "bound_ms": max(bb, bo) / nv,
                     "bound_by": "bytes" if bb >= bo else "operations",
                     "library_ms": None})
    print(json.dumps({"metric": "torch_cuda_probes_us", "rows": R, "n": n,
                      "variants": detail, "k1_us_per_row": k1_us,
                      "k5_us_per_row": k5_us, "card": card}))
    return rows


def beside(fn, args, name: str, label: str, other, card: str) -> dict:
    """Times `other` on the inputs the path gave kernel `name`, in turns
    with the kernel (kernel, other, other, kernel on each input), after
    holding it to the kernel bit for bit; prints and returns the mean ms a
    launch of both."""
    mod, attr, _, _, kernel, _, _ = kernel_table()[name]
    with capture(mod, attr) as cap:
        fn(*args)
    torch.cuda.synchronize()
    ms = {name: 0.0, label: 0.0}
    for a in cap.calls:
        if not torch.equal(kernel(*a), other(*a)):
            raise AssertionError(f"{label} != {name} on the path's input "
                                 f"{tuple(a[0].shape)}")
        for key, f in ((name, kernel), (label, other), (label, other),
                       (name, kernel)):
            ms[key] += event_ms(lambda: f(*a)) / 2 / len(cap.calls)
    print(json.dumps({"metric": f"torch_cuda_{name}_beside_{label}_ms",
                      "ms_per_launch": ms, "inputs": len(cap.calls),
                      "card": card}))
    return ms


MODES = {0: "conv", 1: "forward", 2: "inverse"}   # ntt_rows.cuh Mode


def ptxas_summary(log: str) -> list:
    """One line per kernel of nvcc's -Xptxas -v report: name and template
    arguments, registers, stack frame and spills."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d((?:ntt_rows|staged|p1|p2)_kernel)",
                          m.group(1))
            targs = m.group(1)[k.end(1):] if k else ""
            name = m.group(1) if k is None else k.group(1) + "<" + ",".join(
                re.findall(r"(RowMajor|AuxMajor|PrimeRows)", targs)
                + [MODES[int(v)] for v in re.findall(
                    r"LN(?:5helib|S_)4ModeE(\d+)E", targs)]
                + re.findall(r"L[bi](\d+)E", targs)) + ">"
            cur = {"name": name}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["frame"], cur["spill_st"], cur["spill_ld"] = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = m.group(1)
    return [f"{e['name']}: {e.get('regs', '?')} registers, "
            f"{e.get('frame', '?')} B stack frame, spills "
            f"{e.get('spill_st', '?')}/{e.get('spill_ld', '?')} B"
            for e in out]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from helib_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    set_v2(False)

    start = time.time()
    sources = ("conv", "ntt", "conv_aux", "ntt2", "probes")
    _build.build(*sources)
    print(f"build: {', '.join(s + '.cu' for s in sources)} in "
          f"{time.time() - start:.1f} s")
    for name in sources:
        for line in ptxas_summary(_build.ptxas_log.get(name, "")):
            print(f"  {name}.cu {line}")

    rows, err = check_conv(dev)
    print(f"kernels: conv == conv_plain == conv2 (k=3) bit for bit on {rows} "
          f"rows (n = 8 .. 32768, max |err| = {err})")
    rows, err = check_ntt(dev)
    print(f"kernels: ntt == ntt_plain bit for bit on {rows} rows "
          f"(n = 8 .. 65536, P = 5 and 20, both directions, "
          f"max |err| = {err})")
    rows, err = check_conv_aux(dev)
    print(f"kernels: conv_aux == conv_aux_plain bit for bit on {rows} rows "
          f"(n = 8 .. 65536, P = 5 and 20, aux-major with a lead dim, the "
          f"n = 65536 rows on 4-CTA and on 2-CTA clusters, max |err| = {err})")
    rows, err = check_ntt2(dev)
    print(f"kernels: ntt2 == ntt2_plain == ntt_plain bit for bit on {rows} "
          f"rows (n = 8 .. 65536, P = 5 and 20, both directions, every k; "
          f"== ntt at k = 3; max |err| = {err})")
    rows, err = check_conv2(dev)
    print(f"kernels: conv2 == conv2_plain == conv_plain bit for bit on "
          f"{rows} rows (n = 8 .. 32768, P = 5 and 20, every k, "
          f"max |err| = {err})")

    fn, args, launches = main_path(dev)
    kernels = {"conv": measure(
        fn, args, launches, "conv",
        "torch_cuda_mult_relin_ops_per_s_m8009_b380_batch16", "bgv", card)}
    from helib_tpu_torch.ops.ntt2 import conv2_cuda
    beside(fn, args, "conv", "conv2_k3", lambda *a: conv2_cuda(*a, 3), card)
    kernels["conv2"] = v2_path(
        fn, args, "conv2", "conv", "bgv",
        "torch_cuda_mult_relin_v2_ops_per_s_m8009_b380_batch16", card)
    del fn, args
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    fn, args, launches, ctx, sk = ckks_path(dev)
    kernels["ntt"] = measure(
        fn, args, launches, "ntt",
        "torch_cuda_ckks_mult_relin_ops_per_s_m65536_b440_batch16", "ckks",
        card)
    from helib_tpu_torch.ops.ntt2 import ntt2_cuda
    from helib_tpu_torch.ops.ntt_fused import ntt_max_clusters
    beside(fn, args, "ntt", "ntt2_k3", lambda x, t, inv: ntt2_cuda(
        x.contiguous(), t["flat"], t["q"], inv, 3), card)
    print(f"ckks path: K2's n = 32768 kernel: {ntt_max_clusters(dev, 15)} "
          f"rows resident at once (one CTA a row)")
    kernels["ntt2"] = v2_path(
        fn, args, "ntt2", "ntt", "ckks",
        "torch_cuda_ckks_mult_relin_v2_ops_per_s_m65536_b440_batch16", card)
    del fn, args
    torch.cuda.empty_cache()
    rotation_path(ctx, sk, card)
    del ctx, sk
    torch.cuda.empty_cache()
    ckks_big_path(dev, card)
    torch.cuda.empty_cache()

    kernels["conv_aux"] = perop_path(dev, card)
    torch.cuda.empty_cache()
    kernels["p1"], kernels["p2"] = probe_path(dev, card)
    torch.cuda.empty_cache()
    _, held = slot_path(dev, card)
    t0 = time.time()
    boot_path(*held, card)
    print(f"chip_smoke: phase 13 took {time.time() - t0:.1f} s")
    del held
    gc.collect()         # the stage wrappers leave reference cycles
    torch.cuda.empty_cache()
    t0 = time.time()
    tiny_boot_path(dev, card)
    print(f"chip_smoke: phase 14 took {time.time() - t0:.1f} s")
    print(f"chip_smoke: {time.time() - start:.1f} s of command time after "
          f"start-up")
    print(card)
    order = ("conv", "ntt", "conv_aux", "ntt2", "conv2", "p1", "p2")
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
