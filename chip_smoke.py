"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the seven CUDA sources from ops/csrc (one nvcc per source,
     started together, sm_90a), timed, with every kernel's registers and
     spills (the NTT family each an instantiation of ntt_rows.cuh, printed
     as ntt_rows_kernel<row map, mode, largest composite K, CTAs a row,
     threads a CTA, minimum CTAs an SM>; K4 and K5 at K = 1, 2, 3);
  3. each kernel against its plain torch version on the card, bit for bit:
     K1 conv (and K5 at k = 3, the same code), n = 8 .. 32768; K2 ntt,
     both directions, n = 8 .. 65536, so on every shipped configuration
     (one CTA of 512 threads a row, one of 1024 at n = 32768, 4-CTA
     clusters at n = 65536); K3 conv_aux (aux-major), n = 8 .. 65536, the
     last on 4-CTA clusters and on 2-CTA ones (conv_aux.cu's
     helib_conv_aux_launch_c2); K4 ntt2 at every k, n = 8 .. 65536, and K5
     conv2 at every k, n = 8 .. 32768, against their own plain versions and
     K2's and K1's, K4 at k = 3 also against K2; P = 5 and 20; then
     embed_max, the canonical-embedding max of the measured mod-switch
     noise, against embed_max_plain and the host's FFT to 1e-12 relative at
     every m the port runs eager BGV at (odd 31 .. 35113, powers of 2 64 ..
     65536), its us a call at m = 8009 and 32003 beside its bound, the
     plain version on the card and the host path it replaced, and its
     launches over one eager BGV mult at m=8009 (2), lifted batched
     mult+relin calls (0) and a CKKS mult+rescale at m=1024 (0); then
     basis_ext, the RNS basis extension of the key switch and the
     mod-down, against basis_ext_plain bit for bit (residues and the
     float64 remainder) at m=32003's 65 -> 259 and 65 -> 194 + p^r rows,
     CKKS m=65536's [16, 5 -> 20, 32768] and smaller ragged shapes, its ms
     a lift at the first three beside its bound and the plain version, and
     its launches over an eager BGV mult and rotate at m=8009 and a CKKS
     mult+rescale at m=1024, each equal to the lifts asked for (one a
     digit of each relinearized part, one a scaled mod-down);
  4. the BGV path -- batched mult+relin at m=8009, p=2, bits=380, c=3,
     batch 16 -- through K1 (and no other kernel bar the lift), held
     against the same chain with the plain convolution and against the
     port on the host CPU, and an encrypt -> multiply -> decrypt oracle;
  5. the CKKS path -- batched mult+relin at m=65536, bits=440, c=3, r=30,
     batch 16 -- through K2 (and no other kernel bar the lift), held
     against the same chain with the plain NTT and against the port on the
     host CPU, and an encrypt -> multiply -> rescale -> decrypt oracle within
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
     CPU (in a second process, checked after phase 12's setup); ms per op,
     setup time, peak memory, a profile of one mult+relin, K3's row and the
     clusters the card holds at once;
 11. the cost probes at the TPU probes' shapes: P1's seven variants on 160
     rows of 16384 words, 50 chained applications, and P2's three phases on
     160 rows of n = 16384 and of n = 65536 (K3's 4-CTA clusters, coarse
     through distributed shared memory), 100 chained, each held to its
     plain version bit for bit alone and over a chain of 3; each
     kernels-line row (p1, p2 at n = 16384, p2_65536) driven with the counts
     reset before and read after; us per application (the median of 5
     timed chains) and per row beside each bound and what bounds it (P2's
     distributed shared memory bytes beside it), K1's and K5's time per row
     at n = 16384 and K3's at n = 65536, and P2's split of each;
 12. the BGV slot layer at m=31775, p=2, bits=600, c=3, mvec=(31, 25, 41)
     (HElib's small thin-bootstrapping size: 1200 slots of GF(2^20),
     hypercube [30, 20, 2], the last dimension bad; B = 65536), with
     SecKey(seed=141, hwt=64) and every rotation matrix minted before the
     ops: encrypt, multiply, add_constant(encode_ptxt), a FatEncodedPtxt's
     build and mul_by_constant, rotate by 1 and by 41, shift_1d on the bad
     dimension, total_sums and replicate, each through K3 and no other
     kernel and decrypted exactly to the PtxtBGV oracle; the rotate by 1
     held against the plain K3 and, with mul_by_constant, against the port
     on the host CPU (in a second process, checked after phase 13's cold
     run); setup s, host encode/decode ms, cold and warm ms and
     K3 launches per op, the device masks cached, peak memory and K3's row
     on the rotate's inputs;
 13. BGV thin bootstrapping at m=31775 on phase 12's context, keys and
     EncryptedArray (HElib's bgv_thinboot "small" size): RecryptData(hwt=64)
     (e, ePrime, setup s split into the big-space EncryptedArray, the two
     EvalMaps and ekey), slots from default_rng(143) brought to k=3, one cold
     thin_recrypt with the SecKey (matrices minted, their bytes) and a warm
     one with the PubKey alone (nothing minted; its host and event ms, host
     ms per stage; K3's row on a sample of a warm run's inputs under
     disable_jit(), equal to the graphs' run); each decrypts to
     the input slots, is correct, gains more than 30 bits of capacity and
     multiplies correctly after; K3 alone launched, its count; a warm run
     under the profiler with the graphs and one under disable_jit() (busy
     share), each equal to the first; the warm run bit-identical to the
     plain-K3 chain (the cached diagonals rebuilt plain, each site's
     plain chain one replay of a CUDA graph of its own); peak memory;
 14. m=1271 (HElib's bgv_thinboot/bgv_fatboot "tiny" size), thin and fat
     with SecKey(seed=131, hwt=64): ms of a cold run with the SecKey and a
     warm one with the PubKey (nothing minted) through K3 alone, each
     decrypting exactly to its input; the warm thin bootstrap bit-identical
     to the port on the host CPU at the full 600 bits (in a second process
     while the fat one runs; keys and recryption state carried by
     convert.py, slot tables rebuilt); K3's row on the inputs of the thin
     warm run again under disable_jit() (equal to the graphs' run);
 15. HElib's circuit library at the BGV_binary_arithmetic size m=4095, p=2,
     bits=500, c=2, mvec=(7, 5, 9, 13) (144 slots of GF(2^12), hypercube
     [6, 4, 6], B = 8192) with SecKey(seed=151), data from
     default_rng(153), and the relinearization, Frobenius and permutation
     network matrices (add_matrices_4_network) minted first: the 8-bit
     add, the 4-bit multiply, the 8-bit compare, add_many of four 4-bit
     numbers, a table lookup on a 4-bit index, three database queries
     (an AND, an OR with a NOT, an OR of an AND), the optimized
     permutation network of a default_rng(1) permutation at depth bound 5
     (21 rotations, 13 matrices), unpack of full slots into 12 ciphertexts
     and repack, and a random MatMul1D on dimension 0 -- each through K3
     alone with the PubKey, decrypted exactly to numpy in all 144 slots;
     the permutation held against the plain K3 and the 8-bit add against
     the port on the host CPU; ms cold and warm, K3 launches and capacity
     left per op, the busy share of a profiled 8-bit add, the add, the
     compare and the permutation warm again under disable_jit() (equal to
     the graphs' run) and K3's row on a sample of their inputs, peak
     memory;
 16. MatMulCKKS at HElib's ckks_basic size m=16384 (N = 8192, 4096 slots),
     bits=360, c=3, r=30, with SecKey(seed=161), a dense M and z uniform in
     [-1, 1] from default_rng(163) and the 126 BSGS rotation matrices
     minted first: one apply with BSGS (g = 64) through K2 alone under
     disable_jit() (sampled for K2's row), within 4 x error_bound() of
     M @ z (and within 1e-2 without the decrypt's mitigation noise); the
     same apply with the graphs and with the plain K2 (each site's plain
     chain one replay of a CUDA graph of its own), the diagonals and
     encodes replayed, each bit-identical to it; ms split into host
     diagonal extraction, encodes and the rest, the graphs' ms, K2's row
     at n = 8192, peak memory;
 17. diagnostics, infra and the size above the kernels: (a) HElib's big
     bootstrapping size m=35113, p=2, bits=600, c=3, mvec=(37, 949)
     (benchmarks/thinboot_bench.py "big", B = 131072) with SecKey(seed=141,
     hwt=64): encrypt, mult+relin and an automorphism with its key switch
     on the staged transforms (ops/ntt.py, as helib_tpu above its kernels'
     2^16) and no kernel, each decrypted to the host's product, the
     mult+relin bit-identical to the port on the host CPU at 600 bits (in a
     second process); setup s, ms per op (host and CUDA events), the ms of
     one staged transform, peak memory; (b) SecKey.noise_of and
     debugging.check_noise on phase 10's context and keys, a fresh
     encryption and a mult+relin, the estimate within 40 bits; (c) the CLI
     (python -m helib_tpu_torch.cli create-context / key-gen / encrypt /
     decrypt) at m=4095, bits=500, c=2 as four processes on the card, 144
     values from default_rng(171) round-tripped, Context.printout; (d)
     fhe_stats on: one mult+relin on phase 15's context
     (break-into-digits-ratio, KS-noise-ratio) and four CKKS encodes at
     m=16384 (CKKS_encode_ratio), each max <= 1; (e) export_helib_binary
     of phase 15's context, SecKey, PubKey (relinearization matrix alone)
     and a ciphertext, read back, c0 + c1*s = p*e on the exported rows, the
     same bytes as the export carried to the host CPU; (f) every step in
     a timing.timer (spans on for the phase), printed with
     print_all_timers, with the port's own spans, beside its CUDA-event
     ms;
 18. the parallel layer (helib_tpu_torch/parallel), ranks as processes on
     the card started by parallel.distributed.launch: (a) one NCCL rank
     runs sharded_mult_relin on a (1, 1) mesh at phase 4's size, its
     gathered result (one NCCL all_gather) bit-identical to phase 4's, K1
     alone; then two gloo ranks sharing the card (NCCL refuses two ranks
     on one device): (b) the same on a (batch=2, limb=1) mesh, the
     gathered result bit-identical to phase 4's, each rank K1 alone;
     (c) sharded_mult_relin and sharded_automorph_relin at m=32003,
     bits=5800, c=3, batch 2 on a (batch=1, limb=2) mesh (97 of the 194
     ciphertext rows a rank), each rank K3 alone, both results
     bit-identical to the unsharded port on rank 0 alone; (d) ShardedNTT
     at n = 65536 (negacyclic) split over the two ranks, its forward equal
     to K2's and its inverse back to the input, and the m=31775
     bluestein_apply_sharded (B = 65536) both ways equal to the unsharded
     K3 path; (e) the dry run's sharded thin bootstrap at m=1271, bits=360,
     mvec=(31, 41) (SecKey(seed=141, hwt=64), default_rng(143),
     bring_to_k(3), A = 2): cold with the SecKey, then warm with the
     PubKey, each decrypting to its slots with capacity restored, no
     kernel launched, the warm one bit-identical to the unsharded warm
     one; each op's host and CUDA-event ms, profiled device ms (its own
     kernels) and launches a rank beside the unsharded ones, the
     collectives' count, bytes and ms, the sharded transforms and each
     rank's peak memory;
 19. the ten twins of examples/01-10 (helib_tpu_torch/examples) run in
     this process on the card through importlib, each passing its own
     assertions; ms and kernel launches per example.
Every path runs through the package's jit sites (helib_tpu_torch/
jitutil.py): each transform, digit decomposition, scaled mod-down and
decrypt inner product is one CUDA-graph replay a call once captured, and
phases 4, 5, 9 and 10 wrap their mult+relin (and phase 10 its rotate) in
jitutil.lifted_jit, as bench.py wraps helib_tpu's, so a call is one replay
plus its input and output copies; the first call of each signature runs
the function once (counted) and captures it.  Each lifted call is held
bit for bit to the same call under jitutil.disable_jit(); the plain-chain
checks, K3's samples and the kernel rows run under disable_jit(), where
every site runs its Python (the swapped-in function is called, the
wrappers count); the plain reruns of phases 13 and 16 keep the graphs on,
each site capturing the plain chain as a graph of its own (a graph is
keyed by the kernel entry points it dispatched to).  Six paths -- the BGV
m=8009 and CKKS m=65536 batch-16 calls, the m=32003 mult+relin, the
m=31775 warm rotate by 1 and warm thin bootstrap, the m=4095 warm 8-bit
add -- are read with their graphs and under disable_jit() (the launches
the host issued a call, device ms and busy share from torch.profiler, host
ms, ops/s of the batched two, the graphs their cold call captured, the
pool's bytes), the outputs of the two equal, and printed as one block at
the end.
Phase 18's ranks start and set up while phase 19 runs, then run their
timed parts.  `--parallel-only` runs the build, phases 3 and 4 and then
phases 19 and 18 alone; `--probes-only` the build, phase 3 and phase 11.
The counts include embed_max's: every eager BGV path that measures its
mod-switch noise (the slot phase, the bootstraps, the circuits) launches it
once a measured mod-down, beside its transform kernel, and prints the
count; and basis_ext's: every key switch and scaled mod-down launches it,
once a digit and once a mod-down, so each path's transform check allows
it; the plain-chain reruns take both plain versions too, so they launch
nothing.
Each path, each op and the probe run is driven with the launch
counts set to 0 just before it and read just after; the counts include the
staged transforms, which phases 1-16 must leave at 0, and the sharded ones,
which phases 1-17 must leave at 0.  The last three lines are the card's
name and power limit as nvidia-smi prints them, the kernel table as JSON, and
{"ok": true, "device": {...}}.  Imports nothing of JAX or helib_tpu.
"""

from __future__ import annotations

import contextlib
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
    or records every call's arguments (`capture`).  With eager=True it
    also holds jitutil.disable_jit() open, so every site runs its Python
    (a replay would skip the swapped-in function)."""

    def __init__(self, mod, name: str, repl, eager: bool = False):
        self.mod, self.name, self.repl = mod, name, repl
        self.eager = contextlib.ExitStack() if eager else None

    def __enter__(self):
        if self.eager is not None:
            from helib_tpu_torch.jitutil import disable_jit
            self.eager.enter_context(disable_jit())
        self.saved = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.repl)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.saved)
        if self.eager is not None:
            self.eager.close()


def plain(mod, name: str, repl) -> swap:
    """The plain-chain check's swap: the kernel's plain version in its
    place, every site eager."""
    return swap(mod, name, repl, eager=True)


@contextlib.contextmanager
def plain_own():
    """The port's own kernels in their plain versions -- the noise
    measurement's embed_max and the lift's basis_ext -- so a plain-chain
    rerun launches no kernel at all."""
    from helib_tpu_torch.ops import basis_ext, embed_max
    with swap(embed_max, "embed_max_cuda", embed_max.embed_max_plain), swap(
            basis_ext, "basis_ext_cuda", basis_ext.basis_ext_plain):
        yield


def capture(mod, name: str) -> swap:
    """swap() that passes every call through and keeps its arguments in
    `.calls`, every site eager."""
    orig = getattr(mod, name)
    calls = []

    def rec(*args):
        calls.append(args)
        return orig(*args)
    cm = swap(mod, name, rec, eager=True)
    cm.calls = calls
    return cm


_counters: dict = {}


def _launch_counters() -> dict:
    """name -> the wrapper whose `.launches` counts that kernel, taken at
    the first call: `plain_own()` puts plain versions in the place of the
    own kernels' wrappers, and those count nothing."""
    if not _counters:
        from helib_tpu_torch.ops import (basis_ext, conv, embed_max, ntt2,
                                         ntt_fused, probes)
        _counters.update({
            "conv": conv.conv_cuda, "ntt": ntt_fused.ntt_cuda,
            "conv_aux": conv.conv_aux_cuda, "ntt2": ntt2.ntt2_cuda,
            "conv2": ntt2.conv2_cuda, "p1": probes.p1_cuda,
            "p2": probes.p2_cuda, "embed_max": embed_max.embed_max_cuda,
            "basis_ext": basis_ext.basis_ext_cuda})
    return _counters


# staged transforms (ops/ntt.py: the sizes above the kernels' 2^16) and
# sharded four-step transforms (parallel/sharded_ntt.py) counted before the
# last reset_launches(): phases 1-16 must leave both at 0, phase 17 the
# sharded one
_staged_seen = _sharded_seen = 0


def reset_launches():
    global _staged_seen, _sharded_seen
    from helib_tpu_torch.ops import ntt
    from helib_tpu_torch.parallel import sharded_ntt
    for fn in _launch_counters().values():
        fn.launches = 0
    _staged_seen += ntt.staged_transforms
    ntt.staged_transforms = 0
    _sharded_seen += sharded_ntt.sharded_transforms
    sharded_ntt.sharded_transforms = 0


def read_launches() -> dict:
    """Each kernel's launches since the last reset, `staged`, the staged
    transforms run instead of a kernel above 2^16, and `sharded`, the
    phi(m)-axis four-step transforms (each direction one)."""
    from helib_tpu_torch.ops import ntt
    from helib_tpu_torch.parallel import sharded_ntt
    out = {name: fn.launches for name, fn in _launch_counters().items()}
    out["staged"] = ntt.staged_transforms
    out["sharded"] = sharded_ntt.sharded_transforms
    return out


def staged_since_start() -> int:
    from helib_tpu_torch.ops import ntt
    return _staged_seen + ntt.staged_transforms


def sharded_since_start() -> int:
    from helib_tpu_torch.parallel import sharded_ntt
    return _sharded_seen + sharded_ntt.sharded_transforms


# what every key switch and scaled mod-down launches beside its
# transforms: basis_ext, once a digit and once a mod-down
LIFT = ("basis_ext",)


def expect_only(launches: dict, name: str, what: str, allow=LIFT):
    """Fails unless `name` launched and no other kernel did, bar those
    named in `allow` (the lift's basis_ext; with NOISE also embed_max, on
    the eager BGV paths that measure their mod-switch noise)."""
    if launches[name] == 0 or any(v for k, v in launches.items()
                                  if k != name and k not in allow):
        bar = f" bar {', '.join(allow)}" if allow else ""
        raise AssertionError(f"{what} must launch {name} and no other "
                             f"kernel{bar}: {launches}")


# what an eager BGV path launches beside its transforms and the lift:
# embed_max, once a measured mod-down (Ctxt.mod_down_to's noise)
NOISE = ("embed_max",) + LIFT


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


def once_a_call(fn, args, first, launches: dict, label: str):
    """A lifted_jit run after its capture: one replay a call, whose launch
    counts equal those of its first (eager) call; the output equal to the
    first call's and to the same call under disable_jit()."""
    from helib_tpu_torch import jitutil
    if fn.captures != 1:
        raise AssertionError(f"{label}: {fn.captures} graphs captured")
    reset_launches()
    replays = jitutil.replays
    out = fn(*args)
    torch.cuda.synchronize()
    if jitutil.replays - replays != 1 or read_launches() != launches:
        raise AssertionError(f"{label}: a call was not one replay of the "
                             f"captured launches: {read_launches()}")
    same_outputs(out, first, f"{label} (the replay against the first call)")
    with jitutil.disable_jit():
        ref = fn(*args)
    same_outputs(out, ref, label)
    print(f"{label}: a call is one CUDA-graph replay (1 graph, "
          f"{fn.pool_bytes} bytes added to the pool by its capture), its "
          f"counts those of the eager call; bit-identical to the same call "
          f"under disable_jit()")


# ---------------------------------------------------------------------------
# embed_max: the canonical-embedding max of the measured mod-switch noise
# ---------------------------------------------------------------------------

# every m at which the port runs eager BGV: odd (rows of m coefficients)
# and power-of-2 (rows of m/2)
EMBED_MS = (31, 1271, 4095, 8009, 31775, 32003, 35113, 64, 256, 1024,
            65536)
# float64 outside the tensor cores (H100 SXM data sheet, 700 W)
FP64_FLOP_PER_S = 34e12


def embed_rows(m: int, R: int, seed: int, dev):
    """The tables and R seeded float32 rows of balanced remainders in
    [-1/2, 1/2) at m."""
    from helib_tpu_torch.ops.embed_max import embed_tables
    n = m // 2 if m & (m - 1) == 0 else m
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.random((R, n)) - 0.5).astype(np.float32))
    return x.to(dev), embed_tables(m, n, dev)


def embed_bound_ms(x, tab) -> tuple[float, float]:
    """(bytes, operations) bound of one embed_max call in ms: the rows and
    tables read once and the maxima written; per row two complex FFTs of L
    points (5 L log2 L flops each), the chirp, twiddle and bhat products
    and the magnitudes."""
    R, n = x.shape
    m, log_l = tab["m"], tab["log_l"]
    L = 1 << log_l
    nbytes = 4 * R * n + 16 * (n + 2 * L) + m + 8 * R
    flops = R * (10 * L * log_l + 2 * n + 18 * L + 3 * m)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP64_FLOP_PER_S * 1e3


def embed_max_path(dev, card: str) -> dict:
    """embed_max against embed_max_plain on the card (and the host's FFT,
    norms._largest) at every m of EMBED_MS, to 1e-12 relative, a zero row
    reading 0; its time a call at m = 8009 and 32003 on two rows beside its
    bound, the plain version on the card and the host path it replaced;
    its launches over one eager BGV mult at m = 8009 (2: one a measured
    mod-down), a lifted batched mult+relin there and an eager CKKS
    mult+rescale at m = 1024 (0 each).  Returns the kernels-line row at
    m = 8009."""
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import PubKey, SecKey, SKHandle
    from helib_tpu_torch.norms import _largest
    from helib_tpu_torch.ops.embed_max import embed_max_cuda, embed_max_plain
    from helib_tpu_torch.pipeline import make_batched_mult_relin
    from helib_tpu_torch import jitutil

    worst = worst_host = 0.0
    for m in EMBED_MS:
        x, tab = embed_rows(m, 3, seed=m, dev=dev)
        x[-1] = 0.0
        got = embed_max_cuda(x, tab)
        want = embed_max_plain(x, tab)
        torch.cuda.synchronize()
        if got[-1].item() != 0.0:
            raise AssertionError(f"embed_max at m={m}: a zero row read "
                                 f"{got[-1].item()}")
        rel = float(((got - want).abs() / want.clamp_min(1e-300))[:-1].max())
        host = [_largest(r.cpu().numpy().astype(np.float64), m,
                         m & (m - 1) == 0) for r in x[:-1]]
        rel_host = max(abs(g - h) / h for g, h in zip(got.tolist(), host))
        if rel > 1e-12 or rel_host > 1e-12:
            raise AssertionError(f"embed_max at m={m}: {rel:.3g} from the "
                                 f"plain version, {rel_host:.3g} from the "
                                 f"host FFT")
        worst, worst_host = max(worst, rel), max(worst_host, rel_host)
    print(f"embed_max: == embed_max_plain at m = "
          f"{', '.join(map(str, EMBED_MS))} (3 rows, the last zero, which "
          f"reads 0): max rel err {worst:.3g}; {worst_host:.3g} from the "
          f"host FFT (norms._largest)")

    rows = {}
    for m in (8009, 32003):
        x, tab = embed_rows(m, 2, seed=m + 1, dev=dev)
        us = event_ms(lambda: embed_max_cuda(x, tab), reps=100) * 1e3
        plain_us = event_ms(lambda: embed_max_plain(x, tab), reps=20) * 1e3
        t0 = time.perf_counter()
        for _ in range(50):
            embed_max_cuda(x, tab).cpu()
        call_us = (time.perf_counter() - t0) / 50 * 1e6
        t0 = time.perf_counter()
        for _ in range(10):
            for r in x:
                _largest(r.cpu().numpy().astype(np.float64), m, False)
        host_us = (time.perf_counter() - t0) / 10 * 1e6
        bb, bo = embed_bound_ms(x, tab)
        rows[m] = {"us": us, "plain_us": plain_us, "call_us": call_us,
                   "host_us": host_us, "bound_us": max(bb, bo) * 1e3,
                   "bound_by": "bytes" if bb >= bo else "operations"}
        print(f"embed_max: m={m}, 2 rows, L = 2^{tab['log_l']}: "
              f"{us:.2f} us a call on the card (3 launches), bound "
              f"{max(bb, bo) * 1e3:.3f} us "
              f"({rows[m]['bound_by']}); a call and its .cpu() "
              f"{call_us:.1f} us on the host clock; the plain version on the "
              f"card {plain_us:.1f} us; the host path it replaced (.cpu() "
              f"and norms._largest a row) {host_us:.1f} us")

    ctx = Context(m=M, p=P_PLAIN, r=1, bits=BITS, c=C, device=dev)
    sk = SecKey(ctx, seed=SEED)
    pk = PubKey(sk)
    sk.gen_ks_matrix(SKHandle(2, 1, 0))
    rng = np.random.default_rng(SEED + 2)
    a, b = (pk.encrypt_bgv(rng.integers(0, 2, ctx.phi_m), rng)
            for _ in range(2))
    a.multiply(b, pk)          # warm: the tables and the graphs
    torch.cuda.synchronize()
    reset_launches()
    a.multiply(b, pk)
    torch.cuda.synchronize()
    bgv = read_launches()["embed_max"]
    fn, args = make_batched_mult_relin(ctx, sk, 2)
    fn = jitutil.lifted_jit(fn, *args)
    reset_launches()
    fn(*args)
    fn(*args)
    torch.cuda.synchronize()
    batched = read_launches()["embed_max"]
    del fn, args, ctx, sk, pk, a, b
    from helib_tpu_torch.ckks import EncryptedArrayCKKS
    cc = Context(m=1024, p=-1, r=30, bits=240, c=3, scheme="ckks",
                 device=dev)
    csk = SecKey(cc, seed=SEED)
    cpk = PubKey(csk)
    csk.gen_ks_matrix(SKHandle(2, 1, 0))
    cea = EncryptedArrayCKKS(cc)
    z = cea.encrypt(np.ones(cea.nslots), cpk, np.random.default_rng(SEED))
    reset_launches()
    cea.rescale(z.multiply(z, cpk))
    torch.cuda.synchronize()
    ckks = read_launches()["embed_max"]
    print(f"embed_max: launches over one eager BGV mult at m={M}: {bgv}; "
          f"two lifted batched mult+relin calls: {batched}; one CKKS "
          f"mult+rescale at m=1024: {ckks}")
    if (bgv, batched, ckks) != (2, 0, 0):
        raise AssertionError("embed_max: expected 2 launches a BGV mult, "
                             "none batched or in CKKS")
    r = rows[8009]
    return {"name": "embed_max", "route": "cuda",
            "source": "helib_tpu_torch/ops/csrc/embed_max.cu",
            "replaces": "none (helib_tpu's host FFT, norms._largest)",
            "launches": bgv, "max_rel_err": worst, "ms": r["us"] / 1e3,
            "plain_ms": r["plain_us"] / 1e3, "bound_ms": r["bound_us"] / 1e3,
            "bound_by": r["bound_by"], "library_ms": None}


# ---------------------------------------------------------------------------
# basis_ext: the RNS basis extension of the key switch and the mod-down
# ---------------------------------------------------------------------------

# (label, batch, source rows, target rows, p^r row, N, frac): the main
# path's lifts -- BGV m=32003's digit (65 onto all 259 rows) and special
# mod-down (65 onto 194 and the p^r row, with the measured remainder), CKKS
# m=65536's batched digit (5 onto 20) -- and smaller ones of the other
# paths' widths, ragged N
LIFTS = (("ks m=32003", 1, 65, 259, 0, 32003, False),
         ("mod-down m=32003", 1, 65, 194, 2, 32003, True),
         ("ks CKKS m=65536 b16", 16, 5, 20, 0, 32768, False),
         ("ks m=8009", 1, 5, 18, 0, 8009, False),
         ("mod-down m=8009", 2, 5, 13, 2, 8009, True),
         ("one prime", 3, 1, 13, 0, 1000, True),
         ("digit 4 rows", 2, 4, 18, 257, 131, True))


def lift_inputs(batch: int, kd: int, T: int, pr: int, n: int, seed: int,
                dev):
    """The tables from kd primes onto T others (and p^r, when pr > 1) and
    seeded residues x [batch, kd, n] on dev."""
    from helib_tpu_torch.nt.primegen import gen_primes
    from helib_tpu_torch.ops.basis_ext import basis_ext_tables
    from helib_tpu_torch.ops.modops import to_device
    primes = gen_primes(2, kd + T)
    d, t = primes[:kd], primes[kd:] + ([pr] if pr > 1 else [])
    rng = np.random.default_rng(seed)
    x = rng.integers(0, np.array(d, dtype=np.int64)[:, None],
                     (batch, kd, n)).astype(np.uint32)
    return to_device(x, dev), basis_ext_tables(d, t, dev)


def lift_bound_ms(batch: int, kd: int, T: int, n: int, frac: bool):
    """(bytes, operations) bound of one lift in ms: x read and the output
    (and the remainder) written once; kd multiply-adds an output residue,
    each 32x32->64 two 32-bit multiplies (the low and the high half)."""
    nbytes = batch * n * (4 * kd + 4 * T + (8 if frac else 0))
    mults = 2 * batch * kd * T * n
    return nbytes / HBM_BYTES_PER_S * 1e3, mults / INT32_MUL_PER_S * 1e3


def lift_counts(fn) -> tuple[int, int]:
    """(basis_ext launches, the lifts fn asked for) over fn(): one a digit
    of each rt_break_into_digits and one a rt_scale_down call (graph
    replays add their capture's launches, so the two agree either way)."""
    from helib_tpu_torch import ctxt
    asked = [0]
    digits_fn, down_fn = ctxt.rt_break_into_digits, ctxt.rt_scale_down

    def digits(*a, **kw):
        out = digits_fn(*a, **kw)
        asked[0] += len(out[0])
        return out

    def down(*a, **kw):
        asked[0] += 1
        return down_fn(*a, **kw)
    with swap(ctxt, "rt_break_into_digits", digits), swap(
            ctxt, "rt_scale_down", down):
        reset_launches()
        fn()
        torch.cuda.synchronize()
    return read_launches()["basis_ext"], asked[0]


def basis_ext_path(dev, card: str) -> dict:
    """basis_ext against basis_ext_plain on the card, bit for bit, on every
    shape of LIFTS (the residues and the float64 remainder); its time a
    lift at the first three beside its bound and the plain version on the
    card; its launches over an eager BGV mult and rotate at m=8009, a CKKS
    mult+rescale at m=1024 (one a digit of each relinearized part plus one
    a scaled mod-down, counted from the calls) and lifted batched
    mult+relin calls.  Returns the kernels-line row at m=32003's digit."""
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import PubKey, SecKey, SKHandle
    from helib_tpu_torch.ops.basis_ext import (basis_ext_cuda,
                                               basis_ext_plain)
    from helib_tpu_torch.pipeline import make_batched_mult_relin
    from helib_tpu_torch import jitutil

    rows = {}
    for i, (label, batch, kd, T, pr, n, frac) in enumerate(LIFTS):
        x, tab = lift_inputs(batch, kd, T, pr, n, seed=i + 1, dev=dev)
        got, gfrac = basis_ext_cuda(x, tab, frac)
        want, wfrac = basis_ext_plain(x, tab, frac)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or (frac and not torch.equal(gfrac,
                                                                   wfrac)):
            raise AssertionError(f"basis_ext {label}: kernel != plain")
        if i >= 3:
            continue
        ms = event_ms(lambda: basis_ext_cuda(x, tab, frac), reps=50)
        plain_ms = event_ms(lambda: basis_ext_plain(x, tab, frac), reps=3,
                            warm=1)
        bb, bo = lift_bound_ms(batch, kd, T + (pr > 1), n, frac)
        rows[label] = {"ms": ms, "plain_ms": plain_ms, "bytes_ms": bb,
                       "ops_ms": bo}
        print(f"basis_ext: {label} [{batch}, {kd} -> {T}"
              f"{' + p^r' if pr > 1 else ''}, {n}]: {ms:.4f} ms a lift "
              f"(one launch); bound {max(bb, bo):.4f} ms "
              f"({'bytes' if bb >= bo else 'multiplies'}; bytes {bb:.4f}, "
              f"multiplies {bo:.4f}); the plain version on the card "
              f"{plain_ms:.3f} ms")
    print(f"basis_ext: == basis_ext_plain bit for bit on "
          f"{', '.join(r[0] for r in LIFTS)} (residues and remainders)")

    ctx = Context(m=M, p=P_PLAIN, r=1, bits=BITS, c=C, device=dev)
    sk = SecKey(ctx, seed=SEED)
    pk = PubKey(sk)
    sk.gen_ks_matrix(SKHandle(2, 1, 0))
    sk.gen_ks_matrix(SKHandle(1, 3, 0))
    rng = np.random.default_rng(SEED + 3)
    a, b = (pk.encrypt_bgv(rng.integers(0, 2, ctx.phi_m), rng)
            for _ in range(2))
    counts = {}
    for name, f in (("BGV mult", lambda: a.multiply(b, pk)),
                    ("BGV rotate", lambda: a.copy().smart_automorph(3, pk))):
        f()                    # warm: the tables and the graphs
        counts[name] = lift_counts(f)
    fn, args = make_batched_mult_relin(ctx, sk, 2)
    fn = jitutil.lifted_jit(fn, *args)
    reset_launches()
    fn(*args)
    fn(*args)
    torch.cuda.synchronize()
    batched = read_launches()["basis_ext"]
    del fn, args, ctx, sk, pk, a, b
    from helib_tpu_torch.ckks import EncryptedArrayCKKS
    cc = Context(m=1024, p=-1, r=30, bits=240, c=3, scheme="ckks",
                 device=dev)
    csk = SecKey(cc, seed=SEED)
    cpk = PubKey(csk)
    csk.gen_ks_matrix(SKHandle(2, 1, 0))
    cea = EncryptedArrayCKKS(cc)
    z = cea.encrypt(np.ones(cea.nslots), cpk, np.random.default_rng(SEED))

    def ckks_mult():
        cea.rescale(z.multiply(z, cpk))
    ckks_mult()
    counts["CKKS mult+rescale"] = lift_counts(ckks_mult)
    each = ", ".join(f"{k}: {v[0]} ({v[1]})" for k, v in counts.items())
    print(f"basis_ext: launches (and lifts asked for: one a digit, one a "
          f"scaled mod-down) over one eager {each}; two lifted batched "
          f"mult+relin calls at m={M}: {batched}")
    if any(got != want or got == 0 for got, want in counts.values()) or (
            batched == 0 or batched % 2):
        raise AssertionError("basis_ext: launches differ from the lifts "
                             "the paths asked for")
    r = rows["ks m=32003"]
    return {"name": "basis_ext", "route": "cuda",
            "source": "helib_tpu_torch/ops/csrc/basis_ext.cu",
            "replaces": "none (helib_tpu leaves the lift to XLA as jnp ops)",
            "launches": counts["BGV mult"][0], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
            "bound_by": ("bytes" if r["bytes_ms"] >= r["ops_ms"]
                         else "operations"), "library_ms": None}


def main_path(dev):
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey, SKHandle, reduce_mod_phim
    from helib_tpu_torch.ctxt import Ctxt
    from helib_tpu_torch.pipeline import (make_batched_mult_relin,
                                          make_mult_relin, mult_relin,
                                          fresh_noise)
    from helib_tpu_torch.ops import conv as convmod

    from helib_tpu_torch import jitutil

    t0 = time.time()
    ctx = Context(m=M, p=P_PLAIN, r=1, bits=BITS, c=C, device=dev)
    sk = SecKey(ctx, seed=SEED)
    fn, args = make_batched_mult_relin(ctx, sk, BATCH)
    # one compiled program a call, as bench.py:55-56 runs helib_tpu's
    fn = jitutil.lifted_jit(fn, *args)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    print(f"main path: {ctx!r}; setup {setup_s:.1f} s")

    reset_launches()
    t0 = time.time()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"main path: one batched call launched {launches} (its warm-up "
          f"and capture: {(time.time() - t0) * 1e3:.1f} ms)")
    expect_only(launches, "conv", "BGV path")
    check_outputs(out, ctx, BATCH, dev)
    once_a_call(fn, args, out, launches, "main path")

    # the same chain on batch element 0 with the plain convolution
    pk = sk.pubkey
    with plain(convmod, "conv", convmod.conv_plain), plain_own():
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
    return fn, args, launches, [o.cpu() for o in out]


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
    from helib_tpu_torch.jitutil import lifted_jit

    t0 = time.time()
    ctx = Context(**params, device=dev)
    sk = SecKey(ctx, seed=CKKS_SEED)
    fn, args = (make_mult_relin(ctx, sk) if batch is None
                else make_batched_mult_relin(ctx, sk, batch))
    fn = lifted_jit(fn, *args)
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
    once_a_call(fn, args, out, launches, label)
    one = list(args) if batch is None else [a[0] for a in args]
    first = list(out) if batch is None else [o[0] for o in out]

    # the same chain on batch element 0 with the plain NTT
    pk = sk.pubkey
    with plain(ntt_fused, "ntt", ntt_fused.ntt_plain), plain_own():
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


def keys_arrays(sk) -> dict:
    """The card's secret key, its matrices and its public key as numpy
    arrays and plain values (convert.py's)."""
    from helib_tpu_torch import convert
    from helib_tpu_torch.ops.modops import to_host

    pk = sk.pubkey
    return {"skeys": [{"coeffs": s["coeffs"], "bound": s["bound"],
                       "full": to_host(s["full"])} for s in sk.skeys],
            "matrices": {key: convert.ksmatrix_arrays(W)
                         for key, W in sk.matrices.items()},
            "enc_key": [((h.powS, h.powX, h.keyID), to_host(d))
                        for h, d in pk.enc_key],
            "enc_noise": pk.enc_noise, "sk_bound": pk.sk_bound}


def keys_from_arrays(ctx_cpu, keys: dict):
    """The SecKey (its PubKey attached) of `keys_arrays` on a host-CPU
    context."""
    from helib_tpu_torch import convert

    sk_cpu = convert.seckey_from_arrays(ctx_cpu, keys["skeys"],
                                        keys["matrices"])
    sk_cpu.pubkey = convert.pubkey_from_arrays(
        ctx_cpu, keys["enc_key"], keys["enc_noise"], keys["sk_bound"],
        sk_cpu.matrices)
    return sk_cpu


def keys_on_host(ctx_cpu, sk):
    """The card's secret key, its matrices and its public key carried over
    to a host-CPU context by convert.py."""
    return keys_from_arrays(ctx_cpu, keys_arrays(sk))


def _host_threads(n: int):
    torch.set_num_threads(n)


class on_host:
    """fn(*args) run through the port on the host CPU in a new Python
    process while the card's work goes on.  The host's threads are split
    in halves between that process and this one until `.result()`: more
    threads than cores in all slows both many times over.  The process is
    spawned, so it holds no CUDA state; the arguments and the result travel
    pickled, so they are numpy arrays and plain values.  `.result()` waits
    for it, re-raises its error, ends the process and gives the threads
    back."""

    def __init__(self, fn, *args):
        import concurrent.futures as cf
        import multiprocessing as mp
        self.saved = torch.get_num_threads()
        self.threads = max(1, self.saved // 2)
        self.pool = cf.ProcessPoolExecutor(
            1, mp_context=mp.get_context("spawn"), initializer=_host_threads,
            initargs=(self.threads,))
        self.future = self.pool.submit(fn, *args)
        torch.set_num_threads(max(1, self.saved - self.threads))

    def result(self):
        try:
            return self.future.result()
        finally:
            self.pool.shutdown()
            torch.set_num_threads(self.saved)


def same_arrays(a: dict, b: dict, what: str):
    """Two ciphertexts' convert.ctxt_arrays equal: prime sets and residues,
    part by part."""
    if (a["k"], a["special"], [h for h, _ in a["parts"]]) != (
            b["k"], b["special"], [h for h, _ in b["parts"]]) or not all(
            np.array_equal(x, y) for (_, x), (_, y) in
            zip(a["parts"], b["parts"])):
        raise AssertionError(what)


def _rotate_host(keys: dict, args: list) -> tuple:
    """The rotate of `rotate_on_host` through the port on the host CPU (in
    an `on_host` process): (its outputs, setup s, rotate s)."""
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.pipeline import make_automorph_relin

    t0 = time.time()
    ctx = Context(**{**BIG, "bits": HOST_BITS}, device="cpu")
    fn, _ = make_automorph_relin(ctx, keys_from_arrays(ctx, keys))
    t1 = time.time()
    out = fn(*[torch.from_numpy(a) for a in args])
    return [t.numpy() for t in out], t1 - t0, time.time() - t1


def rotate_on_host(dev):
    """The rotate at m=32003 and HOST_BITS on the card, and started through
    the port on the host CPU in a second process, with the card's keys
    carried over by convert.py (the matrix of X -> X^3 included); the
    function returned waits for it and checks the two bit-identical."""
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey, PubKey
    from helib_tpu_torch.pipeline import make_automorph_relin

    ctx = Context(**{**BIG, "bits": HOST_BITS}, device=dev)
    sk = SecKey(ctx, seed=BIG_SEED)
    PubKey(sk)
    fn, args = make_automorph_relin(ctx, sk)
    out = [a.cpu().numpy() for a in fn(*args)]
    job = on_host(_rotate_host, keys_arrays(sk),
                  [a.cpu().numpy() for a in args])
    what = f"m={ctx.m}, bits={ctx.bits}, L={ctx.L}, S={ctx.S}"

    def host_check():
        host, setup_s, run_s = job.result()
        if not all(np.array_equal(a, b) for a, b in zip(out, host)):
            raise AssertionError("perop rotate: GPU != CPU port")
        print(f"perop: rotate bit-identical to the port on the host CPU at "
              f"{what} (setup {setup_s:.1f} s, rotate {run_s:.1f} s on "
              f"{job.threads} threads, in a second process)")
    return host_check


def perop_path(dev, card: str) -> dict:
    """Drives each op once with the counts reset before it and read after,
    checks it by decryption, holds the rotate against the plain K3 and
    starts it on the host CPU (the function returned last waits for that
    and checks), then times every op and K3."""
    from helib_tpu_torch import io as tio
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.ctxt import Ctxt
    from helib_tpu_torch.dcrt import rt_add, small_coeffs_to_rt
    from helib_tpu_torch.keys import SecKey, PubKey, SKHandle, reduce_mod_phim
    from helib_tpu_torch.ops import conv as convmod
    from helib_tpu_torch.nt import native
    from helib_tpu_torch.pipeline import (make_mult_relin,
                                          make_automorph_relin, make_encrypt)
    from helib_tpu_torch import jitutil

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ctx = Context(**BIG, device=dev)
    sk = SecKey(ctx, seed=BIG_SEED)
    pk = PubKey(sk)
    # the mult+relin and the rotate each one compiled program; the encrypt
    # stays eager (its samplers draw from a torch.Generator), its
    # transforms graphed at their site
    mfn, margs = make_mult_relin(ctx, sk)
    mfn = jitutil.lifted_jit(mfn, *margs)
    rfn, rargs = make_automorph_relin(ctx, sk)
    rfn = jitutil.lifted_jit(rfn, *rargs)
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
        if any(v for key, v in c.items() if key != "conv_aux"
               and key not in LIFT) or (c["conv_aux"] > 0) != k3:
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

    caps = jitutil.captures
    out = run("mult", lambda: mfn(*parts[0], *parts[1]), True)
    caps_mult = jitutil.captures - caps
    check("mult", sk.decrypt_bgv(ctxt(out, L, False)),
          np.convolve(pts[0], pts[1]))
    once_a_call(mfn, (*parts[0], *parts[1]), out, counts["mult"],
                "perop mult")

    rot = run("rotate", lambda: rfn(*parts[0]), True)
    once_a_call(rfn, parts[0], rot, counts["rotate"], "perop rotate")
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
    with plain(convmod, "conv_aux", convmod.conv_aux_plain), plain_own():
        reset_launches()
        ref = rfn(*parts[0])
        torch.cuda.synchronize()
        if any(read_launches().values()):
            raise AssertionError("reference run launched a kernel")
    if not all(torch.equal(a, b) for a, b in zip(rot, ref)):
        raise AssertionError("perop rotate: kernel path != plain path")
    print("perop: rotate bit-identical to the plain-K3 chain")
    host_check = rotate_on_host(dev)

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
    peak = torch.cuda.max_memory_allocated() / 2**30
    graphs_beside_eager("m=32003 mult+relin", mfn, (*parts[0], *parts[1]),
                        caps_mult, card)
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
        "peak_mem_gb": peak, "card": card}))
    return row, host_check, (ctx, sk, pk, cts)


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


def fat_masks(ea) -> tuple[int, int]:
    """(device masks built, their bytes) in the EA's cache."""
    from helib_tpu_torch.encoded import FatEncodedPtxt
    fats = [v._full for v in ea._mask_cache.values()
            if isinstance(v, FatEncodedPtxt) and v._full is not None]
    return len(fats), sum(t.numel() * t.element_size() for t in fats)


def _slots_host(keys: dict, c2: dict, c3: dict, enc_a) -> tuple:
    """Phase 12's mul_by_constant(fat) and rotate by 1 through the port on
    the host CPU (in an `on_host` process): the card's keys carried by
    convert.py, the slot tables rebuilt; (the two outputs' ctxt_arrays,
    setup s, mul s, rotate s)."""
    from helib_tpu_torch import convert
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.ea import EncryptedArray
    from helib_tpu_torch.encoded import FatEncodedPtxt

    t0 = time.time()
    ctx = Context(**SLOTS, scheme="bgv", device="cpu")
    sk = keys_from_arrays(ctx, keys)
    ea = EncryptedArray(ctx)
    c2, c3 = (convert.ctxt_from_arrays(ctx, sk.pubkey, **x) for x in (c2, c3))
    t1 = time.time()
    mul = _times(c2, FatEncodedPtxt(ctx, enc_a, space=ea.pr))
    t2 = time.time()
    rot = ea.rotate(c3, 1, sk)
    return (convert.ctxt_arrays(mul), convert.ctxt_arrays(rot), t1 - t0,
            t2 - t1, time.time() - t2)


def slot_path(dev, card: str, perop_host) -> dict:
    """The slot layer at m=31775 through K3 alone: each op driven with the
    counts reset before it and read after, its decrypt held to the PtxtBGV
    oracle exactly; the rotate by 1 held against the plain K3 and, with
    mul_by_constant(fat), against the port on the host CPU (started in a
    second process; the function returned last waits for it and checks);
    then timed warm, and K3's row on the rotate's own inputs.  Phase 11's
    host-CPU check (`perop_host`) is waited for after the setup."""
    from helib_tpu_torch import convert, ksstrategy
    from helib_tpu_torch.algos.replicate import replicate
    from helib_tpu_torch.algos.sums import total_sums
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.ea import EncryptedArray
    from helib_tpu_torch.encoded import FatEncodedPtxt
    from helib_tpu_torch.keys import SecKey, PubKey
    from helib_tpu_torch.ops import conv as convmod
    from helib_tpu_torch.ptxt import PtxtBGV
    from helib_tpu_torch import jitutil

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
    perop_host()
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
        """f() once with the counts reset (K3 and the noise's embed_max
        alone, or nothing), its decrypt checked against the oracle; then
        WARM_REPS times more, warm (the counts are of one run)."""
        reset_launches()
        caps = jitutil.captures
        out, cold_h, cold_e = timed(f)
        c = read_launches()
        if any(v for key, v in c.items() if key != "conv_aux"
               and key not in NOISE):
            raise AssertionError(f"slots {name}: launched {c}")
        for key, v in c.items():
            total[key] = total.get(key, 0) + v
        if want is not None:
            check(name, out, want)
        ms[name] = {"cold_host": cold_h, "cold_event": cold_e}
        counts[name] = {"cold": c["conv_aux"],
                        "embed_max": c["embed_max"],
                        "captures": jitutil.captures - caps}
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
    caps_rotate = counts["rotate1"]["captures"]
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
    expect_only(total, "conv_aux", "slot phase", NOISE)
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
    with plain(convmod, "conv_aux", convmod.conv_aux_plain), plain_own():
        reset_launches()
        ref = ea.rotate(c3.copy(), 1, sk)
        torch.cuda.synchronize()
        if any(read_launches().values()):
            raise AssertionError("reference run launched a kernel")
    ea._mask_cache = saved
    same_parts(r1, ref, "rotate by 1: kernel path != plain path")
    print("slots: rotate by 1 bit-identical to the plain-K3 chain")

    # the rotate by 1 and mul_by_constant(fat) on the host CPU, in a second
    # process while phase 13's setup and cold run go on
    job = on_host(_slots_host, keys_arrays(sk), convert.ctxt_arrays(c2),
                  convert.ctxt_arrays(c3), ea.encode(a))
    want = [convert.ctxt_arrays(x) for x in (c3, r1)]

    def host_check():
        mul, rot, *took = job.result()
        same_arrays(want[0], mul, "slots mul_by_constant(fat): GPU != CPU "
                    "port")
        same_arrays(want[1], rot, "slots rotate by 1: GPU != CPU port")
        print(f"slots: rotate by 1 and mul_by_constant(fat) bit-identical to "
              f"the port on the host CPU at bits={SLOTS['bits']} (setup "
              f"{took[0]:.1f} s, mul {took[1]:.1f} s, rotate {took[2]:.1f} s "
              f"on {job.threads} threads, in a second process)")

    peak = torch.cuda.max_memory_allocated() / 2**30
    graphs_beside_eager("m=31775 warm rotate by 1",
                        lambda: ea.rotate(c3.copy(), 1, sk), (), caps_rotate,
                        card)
    row = kernel_row(lambda: ea.rotate(c3.copy(), 1, sk), (),
                     {"conv_aux": counts["rotate1"]["warm"]},
                     "conv_aux")
    print(json.dumps({"metric": "torch_cuda_bgv_slots_m31775_b600",
                      "setup_s": setup, "host_ms": host, "ms_per_op": ms,
                      "conv_aux_launches_per_op": counts,
                      "fat_masks_count_bytes": masks,
                      "peak_mem_gb": peak,
                      "conv_aux_row_rotate1": row, "card": card}))
    return row, (ctx, sk, pk, ea), host_check


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


def boot_path(ctx, sk, pk, ea, card: str, slots_host) -> dict:
    """Phase 13: the thin bootstrap at m=31775 on phase 12's context and
    keys, through K3 alone; phase 12's host-CPU check (`slots_host`) is
    waited for after the cold run, before the timed ones."""
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

    from helib_tpu_torch import jitutil
    reset_launches()
    caps = jitutil.captures
    out, h, e = timed(lambda: rec.thin_recrypt(low, rc, sk))
    caps = jitutil.captures - caps
    c = read_launches()
    expect_only(c, "conv_aux", "boot cold", NOISE)
    cold = {"host_ms": h, "event_ms": e, "conv_aux": c["conv_aux"],
            "embed_max": c["embed_max"], "captures": caps,
            "capacity": boot_check("cold", ea, sk, low, out, slots, sk)}
    minted = len(sk.matrices)
    slots_host()
    # the device constants the bootstrap reads (with phase 12's masks)
    fats = all_fats(ea, rc.ea_big, rc.slot_to_coeff, rc.coeff_to_slot)
    info = {"capacity_in": low.capacity(), "matrices_minted": minted,
            "matrix_bytes": sum(t.numel() * t.element_size()
                                for W in sk.matrices.values()
                                for t in W.b + W.a),
            "device_constants_count_bytes": (
                len(fats), sum(f._full.numel() * 4 for f in fats
                               if f._full is not None))}
    # a warm run with the PubKey, timed per stage
    marks = stage_marks(rec, rc)
    reset_launches()
    with marks:
        out_warm, h, e = timed(lambda: rec.thin_recrypt(low, rc, pk))
    c = read_launches()
    expect_only(c, "conv_aux", "boot warm (PubKey)", NOISE)
    warm = {"host_ms": h, "event_ms": e, "conv_aux": c["conv_aux"],
            "embed_max": c["embed_max"],
            "capacity": boot_check("warm (PubKey)", ea, sk, low, out_warm,
                                   slots, pk)}
    stages = marks.ms()
    # the same under disable_jit(), sampled for K3's row
    smp = sampling("conv_aux")
    reset_launches()
    with smp:
        out_eager, eh, ee = timed(lambda: rec.thin_recrypt(low, rc, pk))
    if read_launches() != c:
        raise AssertionError(f"boot: the eager run launched "
                             f"{read_launches()}, the graphs' run {c}")
    same_outputs(out_warm, out_eager, "boot warm")
    row = smp.row(c["conv_aux"])
    del out_eager
    # and each under the profiler: the device's busy share
    profs = {}
    for eager in (False, True):
        held = []
        reset_launches()
        with jitutil.disable_jit() if eager else contextlib.nullcontext():
            profs[eager] = profile(
                lambda: held.append(rec.thin_recrypt(low, rc, pk)), (),
                f"bgv thin bootstrap m=31775, warm, "
                f"{'eager' if eager else 'graphs'}", warmup=False)
        expect_only(read_launches(), "conv_aux", "boot warm (profiled)",
                    NOISE)
        same_parts(out_warm, held[0], "boot: the profiled run != the timed "
                   "run")
        del held
    prof = profs[False]
    warm.update(profiled_ms=prof["wall_ms"], busy_share=prof["busy_share"],
                launches=prof["launches"])
    graph_row("m=31775 warm thin bootstrap", mode_numbers(h, e, prof),
              mode_numbers(eh, ee, profs[True]), caps, card)
    if len(sk.matrices) != minted:
        raise AssertionError("boot: the PubKey runs minted a matrix")
    print(f"boot: cold {json.dumps(cold)}; {minted} matrices minted "
          f"({info['matrix_bytes'] / 2**20:.1f} MiB); warm (the PubKey) "
          f"{json.dumps(warm)}; decrypts, capacity and the multiply after "
          f"it checked on both; the profiled run equal to the timed one")
    print("boot: host ms per stage " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items()))

    # one warm bootstrap with the plain K3, its diagonals rebuilt plain
    # too; the sites capture the plain chain as graphs of their own (keyed
    # by the swapped-in function), so each plain transform is one replay
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.time()
    caps = jitutil.captures
    with swap(convmod, "conv_aux", convmod.conv_aux_plain), plain_fats(
            fats), plain_own():
        reset_launches()
        ref = rec.thin_recrypt(low, rc, pk)
        torch.cuda.synchronize()
        if any(read_launches().values()):
            raise AssertionError("reference run launched a kernel")
    same_parts(out_warm, ref, "boot: kernel path != plain path")
    print(f"boot: warm bootstrap bit-identical to the plain-K3 chain "
          f"({len(fats)} device constants rebuilt plain; "
          f"{jitutil.captures - caps} graphs of the plain chain; "
          f"{time.time() - t0:.1f} s)")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"metric": "torch_cuda_bgv_thinboot_m31775_b600",
                      "e": rc.e, "ePrime": rc.ePrime, "setup_s": setup,
                      "cold": cold, "warm": warm, "stage_ms": stages,
                      **info, "conv_aux_row": row, "peak_mem_gb": peak,
                      "card": card}))
    return row


def _thin_boot_host(keys: dict, state: dict, low: dict) -> tuple:
    """Phase 14's warm thin bootstrap through the port on the host CPU (in
    an `on_host` process): the card's keys and recryption state carried by
    convert.py, the slot tables rebuilt (they depend on (m, p, r, mvec)
    alone); (the output's ctxt_arrays, setup s, bootstrap s)."""
    from helib_tpu_torch import convert, recryption as rec
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.ea import EncryptedArray

    t0 = time.time()
    ctx = Context(**BOOT_TINY, scheme="bgv", device="cpu")
    sk = keys_from_arrays(ctx, keys)
    rc = rec.RecryptData(ctx, sk, EncryptedArray(ctx), hwt=BOOT_HWT)
    convert.load_recrypt_state(rc, sk, state)
    ct = convert.ctxt_from_arrays(ctx, sk.pubkey, **low)
    t1 = time.time()
    out = rec.thin_recrypt(ct, rc, sk.pubkey)
    return convert.ctxt_arrays(out), t1 - t0, time.time() - t1


def tiny_boot_path(dev, card: str) -> dict:
    """Phase 14: thin and fat bootstraps at m=1271 through K3 alone; the
    thin one held against the port on the host CPU at the full 600 bits,
    which runs in a second process while the fat one runs on the card."""
    from helib_tpu_torch import convert, recryption as rec
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.ea import EncryptedArray
    from helib_tpu_torch.keys import SecKey, PubKey
    from helib_tpu_torch import jitutil

    res = {}

    def drive(fat: bool):
        """Setup, a cold run with the SecKey and a warm one with the PubKey
        (nothing minted), each checked; returns what the thin checks below
        need."""
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
        smp = sampling("conv_aux")
        # cold and warm with the graphs; the thin one warm again under
        # disable_jit(), sampled for K3's row
        runs = (("cold", sk), ("warm", pk)) + (() if fat else (
            ("eager", pk),))
        for which, key in runs:
            n = len(sk.matrices)
            reset_launches()
            caps = jitutil.captures
            with smp if which == "eager" else contextlib.nullcontext():
                out, h, e = timed(lambda: fn(low, rc, key))
            c = read_launches()
            expect_only(c, "conv_aux", f"boot m=1271 {name} {which}",
                        NOISE)
            if which != "cold" and len(sk.matrices) != n:
                raise AssertionError(f"boot m=1271 {name}: the PubKey run "
                                     f"minted")
            cap = boot_check(f"m=1271 {name} {which}", ea, sk, low, out,
                             slots, key, fat)
            r[which] = {"host_ms": h, "event_ms": e,
                        "conv_aux": c["conv_aux"],
                        "embed_max": c["embed_max"], "capacity": cap,
                        "captures": jitutil.captures - caps}
            if which == "eager":
                same_outputs(warm_out, out, f"boot m=1271 {name} warm")
                if (c["conv_aux"], c["embed_max"]) != (
                        r["warm"]["conv_aux"], r["warm"]["embed_max"]):
                    raise AssertionError(f"boot m=1271 {name}: the eager "
                                         f"run launched {c}")
            warm_out = out
        r["matrices_minted"] = len(sk.matrices)
        print(f"boot m=1271 {name}: {rc!r}; {json.dumps(r)}; decrypts "
              f"exactly, capacity {low.capacity():.1f} -> "
              f"{out.capacity():.1f}")
        return rc, sk, low, out, smp

    torch.cuda.reset_peak_memory_stats()
    rc, sk, low, out, smp = drive(fat=False)
    row = smp.row(res["thin"]["eager"]["conv_aux"])
    # the warm thin bootstrap on the host CPU, in a second process while
    # the fat one runs on the card
    job = on_host(_thin_boot_host, keys_arrays(sk),
                  convert.recrypt_state(rc, sk), convert.ctxt_arrays(low))
    want = convert.ctxt_arrays(out)
    del rc, sk, low, out, smp
    gc.collect()
    torch.cuda.empty_cache()
    drive(fat=True)
    host, setup_s, run_s = job.result()
    same_arrays(want, host, "boot m=1271 thin: GPU != CPU port")
    print(f"boot m=1271 thin: warm bootstrap bit-identical to the port on "
          f"the host CPU at bits={BOOT_TINY['bits']} (setup {setup_s:.1f} s, "
          f"bootstrap {run_s:.1f} s on {job.threads} threads, in a second "
          f"process)")
    print(json.dumps({"metric": "torch_cuda_bgv_boot_m1271_b600", **res,
                      "conv_aux_row_thin": row,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "card": card}))
    return row


# ---------------------------------------------------------------------------
# HElib's circuit library at m=4095 (K3) and MatMulCKKS at m=16384 (K2)
# ---------------------------------------------------------------------------

# HElib's BGV_binary_arithmetic example size (BASELINE.json's first
# configuration): 144 slots of GF(2^12), hypercube [6, 4, 6], all native,
# 17 ciphertext and 9 special primes, B = 8192
BINARY = dict(m=4095, p=2, r=1, bits=500, c=2, mvec=(7, 5, 9, 13))
BINARY_SEED, BINARY_DATA_SEED, BINARY_PERM_SEED = 151, 153, 1
BINARY_HYPERCUBE = ([6, 4, 6], [True, True, True])
# the least depth bound optimal_upper accepts on [6, 4, 6]: 21 rotations
# through 13 distinct matrices for the default_rng(1) permutation
BINARY_DEPTH = 5
BINARY_NETWORK = (5, 21, 13)
# HElib's ckks_basic size m=16384 (benchmarks/bench_suite.py:225): 4096
# slots, N = 8192; BSGS with g = 64
CKKS_MM = dict(m=16384, p=-1, r=30, bits=360, c=3, scheme="ckks")
CKKS_MM_SEED, CKKS_MM_DATA_SEED = 161, 163
# |M z - the decrypt without its mitigation noise|: 2.9e-3 on the H100; the
# 4 x error_bound() limit (68) is near max |M z| (80) and would pass a wrong
# product
CKKS_MM_RAW_TOL = 1e-2


# the circuits run again under disable_jit() (sampled for K3's row), the
# 8-bit add among them for the graphs' block
EAGER_OPS = ("add_two_numbers 8+8", "compare_two_numbers 8", "permutation")


class sampling:
    """Context manager keeping a uniform sample of at most ROW_SAMPLES of
    the inputs kernel `name` gets while it is open (reservoir sampling from
    a fixed seed) and the count of its calls, every site eager while it is
    open; `.row(launches)` is the kernel's row on them."""

    def __init__(self, name: str):
        self.name = name
        self.mod, self.attr = kernel_table()[name][:2]
        self.kept, self.count = [], 0
        self.rng = np.random.default_rng(0)

    def __enter__(self):
        orig = getattr(self.mod, self.attr)

        def rec(*args):
            self.count += 1
            if len(self.kept) < ROW_SAMPLES:
                self.kept.append(args)
            else:
                j = int(self.rng.integers(self.count))
                if j < ROW_SAMPLES:
                    self.kept[j] = args
            return orig(*args)
        self.sw = swap(self.mod, self.attr, rec, eager=True)
        self.sw.__enter__()
        return self

    def __exit__(self, *exc):
        self.sw.__exit__(*exc)

    def row(self, launches: int) -> dict:
        """The row; `launches` is the count read while the sample was open,
        and must equal the calls the sample saw."""
        if self.count != launches:
            raise AssertionError(f"the sample saw {self.count} {self.name} "
                                 f"calls, not {launches}")
        return {**row_on(self.kept, launches, self.name),
                "sampled_inputs": len(self.kept),
                "shapes": sorted({str(tuple(a[0].shape))
                                  for a in self.kept})}


def matmul1d_oracle(pal, dim: int, M, v, p: int) -> np.ndarray:
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


def circuits_path(dev, card: str) -> dict:
    """Phase 15: HElib's circuit library at m=4095 through K3 alone, every
    matrix minted first and each op run with the PubKey; each op's decrypt
    held to numpy, the permutation to the plain K3 and the 8-bit add to
    the port on the host CPU."""
    from helib_tpu_torch import convert, ksstrategy
    from helib_tpu_torch.algos import binary as B
    from helib_tpu_torch.algos import intraslot, random_matrices
    from helib_tpu_torch.algos import optimize_perms, tablelookup
    from helib_tpu_torch.algos.query import Database
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.ea import EncryptedArray
    from helib_tpu_torch.keys import SecKey, PubKey
    from helib_tpu_torch.ops import conv as convmod
    from helib_tpu_torch import jitutil

    torch.cuda.reset_peak_memory_stats()
    setup = {}
    t0 = time.time()
    ctx = Context(**BINARY, scheme="bgv", device=dev)
    sk = SecKey(ctx, seed=BINARY_SEED)
    pk = PubKey(sk)
    ea = EncryptedArray(ctx)
    torch.cuda.synchronize()
    setup["context_keys_ea_s"] = time.time() - t0
    pal = ctx.pal
    if (pal.orders, pal.native) != BINARY_HYPERCUBE:
        raise AssertionError(f"circuits: hypercube {pal.orders} "
                             f"{pal.native}")
    t0 = time.time()
    pip = optimize_perms.PermIndepPrecomp(ea, BINARY_DEPTH)
    perm = np.random.default_rng(BINARY_PERM_SEED).permutation(ea.nslots)
    pp = optimize_perms.PermPrecomp(pip, perm)
    unpack_enc = intraslot.build_unpack_slot_encoding(ea)
    setup["network_and_unpack_maps_s"] = time.time() - t0
    t0 = time.time()
    ksstrategy.add_relin_matrix(sk)
    ksstrategy.add_frb_matrices(sk)
    before = len(sk.matrices)
    ksstrategy.add_matrices_4_network(sk, pp)
    torch.cuda.synchronize()
    setup["matrices_s"] = time.time() - t0
    minted = len(sk.matrices)
    network = (pip.depth, pp.rotations(), minted - before)
    v = np.arange(ea.nslots)
    if not np.array_equal(pp.apply_vector(v), v[perm]):
        raise AssertionError("circuits: apply_vector != v[perm]")
    print(f"circuits: {ctx!r}; d={ea.d}, {ea.nslots} slots, B = "
          f"{ctx.ntt_fwd.B}; SecKey(seed="
          f"{BINARY_SEED}), data default_rng({BINARY_DATA_SEED}), "
          f"permutation default_rng({BINARY_PERM_SEED}); network D="
          f"{BINARY_DEPTH}: depth {pip.depth}, rotations() "
          f"{pp.rotations()}, get_cost() {pip.get_cost()}, "
          f"{minted - before} matrices minted for it "
          f"({sorted((int(a), int(b)) for a, b in pp.needed_rotations())}); "
          f"{minted} matrices in all (relin, {ea.d - 1} Frobenius, the "
          f"network's); apply_vector == v[perm]; setup {json.dumps(setup)}")
    if network != BINARY_NETWORK or pip.get_cost() != BINARY_NETWORK[1]:
        raise AssertionError(f"circuits: network {network}")

    rng = np.random.default_rng(BINARY_DATA_SEED)
    n = ea.nslots
    a8, b8 = rng.integers(0, 256, n), rng.integers(0, 256, n)
    b8[:4] = a8[:4]
    a4, b4 = rng.integers(0, 16, n), rng.integers(0, 16, n)
    four = [rng.integers(0, 16, n) for _ in range(4)]
    idx = rng.integers(0, 16, n)
    cols = [rng.integers(0, 2, n) for _ in range(3)]
    qv = [int(x) for x in rng.integers(0, 2, 3)]
    bits = rng.integers(0, 2, n)
    full = [rng.integers(0, 2, ea.d) for _ in range(n)]
    t0 = time.time()
    ca8, cb8 = (B.encrypt_number(ea, pk, rng, x, 8) for x in (a8, b8))
    ca4, cb4 = (B.encrypt_number(ea, pk, rng, x, 4) for x in (a4, b4))
    cfour = [B.encrypt_number(ea, pk, rng, x, 4) for x in four]
    cidx = B.encrypt_number(ea, pk, rng, idx, 4)
    db = Database(ea, pk, [ea.encrypt(list(c), pk, rng) for c in cols])
    qc = {i: ea.encrypt([qv[i]] * n, pk, rng) for i in range(3)}
    cbits = ea.encrypt(list(bits), pk, rng)
    cfull = ea.encrypt(full, pk, rng)
    torch.cuda.synchronize()
    setup["encrypt_s"] = time.time() - t0
    table = tablelookup.build_lookup_table(lambda i: bin(i).count("1"), 4,
                                           ea.pr)
    mat, M = random_matrices.random_matmul1d(ea, 0, rng)
    m = [(c == q).astype(np.int64) for c, q in zip(cols, qv)]

    def number(want):
        return lambda out: B.decrypt_number(ea, sk, out), want

    def ints(want):
        return lambda out: ea.decrypt_ints(out, sk), want

    def unpacked(out):
        return np.stack([ea.decrypt_ints(x, sk) for x in out], 1)
    # name -> (op, (decrypt, oracle))
    ops = {
        "add_two_numbers 8+8": (
            lambda: B.add_two_numbers(ea, ca8, cb8, pk), number(a8 + b8)),
        "mult_two_numbers 4x4": (
            lambda: B.mult_two_numbers(ea, ca4, cb4, pk), number(a4 * b4)),
        "compare_two_numbers 8": (
            lambda: list(B.compare_two_numbers(ea, ca8, cb8, pk)),
            (lambda out: np.stack([ea.decrypt_ints(x, sk) for x in out]),
             np.stack([a8 > b8, a8 == b8]).astype(np.int64))),
        "add_many_numbers 4x4": (
            lambda: B.add_many_numbers(ea, cfour, pk), number(sum(four))),
        "table_lookup 4-bit": (
            lambda: tablelookup.table_lookup(ea, cidx, table, pk),
            ints(np.array(table)[idx])),
        "contains 0 AND 1": (lambda: db.contains("0 AND 1", qc),
                             ints(m[0] & m[1])),
        "contains 0 OR NOT 1": (lambda: db.contains("0 OR NOT 1", qc),
                                ints(m[0] | (1 - m[1]))),
        "contains (0 AND 1) OR 2": (
            lambda: db.contains("(0 AND 1) OR 2", qc),
            ints((m[0] & m[1]) | m[2])),
        "permutation": (lambda: pp.apply(cbits, pk), ints(bits[perm])),
        "unpack": (lambda: intraslot.unpack(ea, cfull, pk, unpack_enc),
                   (unpacked, np.array(full))),
        "random_matmul1d dim 0": (
            lambda: mat.apply(cbits, pk),
            ints(matmul1d_oracle(pal, 0, M, bits, ea.pr))),
    }
    res, outs, total, warm_total = {}, {}, 0, 0
    smp = sampling("conv_aux")
    for name, (f, (dec, want)) in ops.items():
        reset_launches()
        caps = jitutil.captures
        out, cold_h, cold_e = timed(f)
        caps = jitutil.captures - caps
        c = read_launches()
        expect_only(c, "conv_aux", f"circuits {name}", NOISE)
        if not np.array_equal(dec(out), want):
            raise AssertionError(f"circuits {name}: decrypt != numpy")
        reset_launches()
        warm, warm_h, warm_e = timed(f)
        cw = read_launches()
        expect_only(cw, "conv_aux", f"circuits {name} warm", NOISE)
        res[name] = {"cold_host_ms": cold_h, "cold_event_ms": cold_e,
                     "warm_host_ms": warm_h, "warm_event_ms": warm_e}
        if name in EAGER_OPS:
            # warm again under disable_jit(), sampled for K3's row
            with smp:
                reset_launches()
                eager, eager_h, eager_e = timed(f)
                ce = read_launches()
            if ce != cw:
                raise AssertionError(f"circuits {name}: the eager run "
                                     f"launched {ce}, the graphs' run {cw}")
            same_outputs(warm, eager, f"circuits {name}")
            warm_total += ce["conv_aux"]
            res[name].update(eager_host_ms=eager_h, eager_event_ms=eager_e)
        total += c["conv_aux"]
        cts = out if isinstance(out, list) else [out]
        outs[name] = out
        res[name].update(conv_aux=c["conv_aux"], embed_max=c["embed_max"],
                         captures=caps,
                         capacity=min(x.capacity() for x in cts))
        print(f"circuits: {name} {json.dumps(res[name])}")
    # repack of the unpacked ciphertexts
    parts = outs["unpack"]
    reset_launches()
    back, h, e = timed(lambda: intraslot.repack(ea, parts))
    c = read_launches()
    expect_only(c, "conv_aux", "circuits repack", NOISE)
    if not np.array_equal(sk.decrypt_bgv(back), ea.encode(full)):
        raise AssertionError("circuits repack: decrypt != the full slots")
    res["repack"] = {"cold_host_ms": h, "cold_event_ms": e,
                     "conv_aux": c["conv_aux"], "embed_max": c["embed_max"],
                     "capacity": back.capacity()}
    total += c["conv_aux"]
    if len(sk.matrices) != minted:
        raise AssertionError("circuits: a matrix was minted during the ops")
    print(f"circuits: every op and repack decrypted to numpy in all {n} "
          f"slots through K3 alone ({total} launches), no matrix minted")
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = graphs_beside_eager(
        "m=4095 warm 8-bit add", ops["add_two_numbers 8+8"][0], (),
        res["add_two_numbers 8+8"]["captures"], card)

    # the permutation with the plain K3
    with plain(convmod, "conv_aux", convmod.conv_aux_plain), plain_own():
        reset_launches()
        ref = pp.apply(cbits, pk)
        torch.cuda.synchronize()
        if any(read_launches().values()):
            raise AssertionError("reference run launched a kernel")
    same_parts(outs["permutation"], ref,
               "circuits permutation: kernel path != plain path")
    print("circuits: the permutation bit-identical to the plain-K3 chain")

    # the 8-bit add on the host CPU, keys carried over by convert.py
    t0 = time.time()
    ctx_cpu = Context(**BINARY, scheme="bgv", device="cpu")
    sk_cpu = keys_on_host(ctx_cpu, sk)
    ea_cpu = EncryptedArray(ctx_cpu)
    host_in = [[convert.ctxt_from_arrays(ctx_cpu, sk_cpu.pubkey,
                                         **convert.ctxt_arrays(x))
                for x in num] for num in (ca8, cb8)]
    t1 = time.time()
    host = B.add_two_numbers(ea_cpu, *host_in, sk_cpu.pubkey)
    for i, (x, y) in enumerate(zip(outs["add_two_numbers 8+8"], host)):
        same_parts(x, y, f"circuits add bit {i}: GPU != CPU port")
    print(f"circuits: the 8-bit add bit-identical to the port on the host "
          f"CPU at bits={ctx.bits} (setup {t1 - t0:.1f} s, add "
          f"{time.time() - t1:.1f} s on {torch.get_num_threads()} threads)")
    row = smp.row(warm_total)
    print(json.dumps({"metric": "torch_cuda_bgv_circuits_m4095_b500",
                      "setup_s": setup, "ops": res,
                      "conv_aux_launches": total,
                      "profiled_add": busy,
                      "network": {"depth_bound": BINARY_DEPTH,
                                  "depth": pip.depth,
                                  "rotations": pp.rotations(),
                                  "cost": pip.get_cost(),
                                  "matrices": minted - before},
                      "matrices_minted": minted,
                      "conv_aux_row_warm_ops": row,
                      "peak_mem_gb": peak,
                      "card": card}))
    return row, (ctx, sk, pk, ea)


def matmul_ckks_path(dev, card: str) -> dict:
    """Phase 16: MatMulCKKS with BSGS at m=16384 through K2 alone: within
    4 x error_bound() of M @ z, and bit-identical to the same apply with
    the plain K2 (its diagonals replayed from the first run)."""
    from helib_tpu_torch.algos.matmul_ckks import MatMulCKKS
    from helib_tpu_torch.ckks import EncryptedArrayCKKS
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey, PubKey, SKHandle
    from helib_tpu_torch.nt.numbth import inv_mod
    from helib_tpu_torch.ops import ntt_fused
    from helib_tpu_torch import jitutil

    torch.cuda.reset_peak_memory_stats()
    setup = {}
    t0 = time.time()
    ctx = Context(**CKKS_MM, device=dev)
    sk = SecKey(ctx, seed=CKKS_MM_SEED)
    pk = PubKey(sk)
    ea = EncryptedArrayCKKS(ctx)
    n = ea.nslots
    g = math.isqrt(n)
    inv5 = inv_mod(5, ctx.m)
    for amt in list(range(1, g)) + list(range(g, n, g)):
        sk.gen_ks_matrix(SKHandle(1, pow(inv5, amt, ctx.m), 0))
    torch.cuda.synchronize()
    setup["context_keys_matrices_s"] = time.time() - t0
    minted = len(sk.matrices)
    rng = np.random.default_rng(CKKS_MM_DATA_SEED)
    M = rng.uniform(-1, 1, (n, n))
    z = rng.uniform(-1, 1, n)
    ct = ea.encrypt(z, pk, rng)
    mm = MatMulCKKS(ea, lambda i, j: M[i, j])
    print(f"matmul_ckks: {ctx!r}; N = {ea.N}, {n} slots, BSGS g = {g}; "
          f"SecKey(seed={CKKS_MM_SEED}), M and z uniform in [-1, 1] from "
          f"default_rng({CKKS_MM_DATA_SEED}); {minted} rotation matrices "
          f"minted first; setup {json.dumps(setup)}")

    # the diagonals and encodes, recorded for the graphs' and the plain-K2
    # reruns
    diags, encodes = [], []

    def recorded(fn, into, keep=lambda v: v):
        def rec(*a, **kw):
            out = fn(*a, **kw)
            into.append(keep(out))
            return out
        return rec
    smp = sampling("ntt")
    with timers((mm, "_diag", "diag_extraction_s"),
                (ea, "encode", "encode_s")) as tm, swap(
            mm, "_diag", recorded(mm._diag, diags)), swap(
            ea, "encode", recorded(ea.encode, encodes, lambda e: (
                e[0].astype(np.int64),) + e[1:])), smp:
        reset_launches()
        out, host, event = timed(lambda: mm.apply(ct, pk, bsgs=True))
        c = read_launches()
    expect_only(c, "ntt", "matmul_ckks")
    if len(sk.matrices) != minted:
        raise AssertionError("matmul_ckks: a matrix was minted")
    want = M @ z
    got = ea.decrypt(out, sk)
    err = float(np.max(np.abs(got - want)))
    raw_err = float(np.max(np.abs(ea.raw_decrypt(out, sk) - want)))
    bound = out.error_bound()
    if not err <= 4 * bound:
        raise AssertionError(f"matmul_ckks: |dec - M z| = {err} > 4 x "
                             f"{bound}")
    if not raw_err <= CKKS_MM_RAW_TOL:
        raise AssertionError(f"matmul_ckks: |raw dec - M z| = {raw_err} > "
                             f"{CKKS_MM_RAW_TOL}")
    split = {"apply_ms": host, "event_ms": event,
             **{k.replace("_s", "_ms"): v * 1e3 for k, v in tm.s.items()}}
    split["device_and_launch_ms"] = (host - split["diag_extraction_ms"]
                                     - split["encode_ms"])
    print(f"matmul_ckks: one apply {json.dumps(split)} ({len(diags)} "
          f"diagonals, {c['ntt']} K2 launches, {sum(c.values())} in all); "
          f"max |dec - M z| = {err:.3e} against 4 x error_bound() = "
          f"{4 * bound:.3e} (max |M z| = {np.max(np.abs(want)):.3e}; "
          f"without the decrypt's mitigation noise {raw_err:.3e}, within "
          f"{CKKS_MM_RAW_TOL})")

    def replayed():
        """The apply with the diagonals and encodes replayed in order: the
        device's part and its launches alone."""
        next_diag, next_encode = iter(diags).__next__, iter(encodes).__next__
        with swap(mm, "_diag", lambda *a, **kw: next_diag()), swap(
                ea, "encode", lambda *a, **kw: next_encode()):
            return mm.apply(ct, pk, bsgs=True)

    # the same apply with the graphs (the run above was under disable_jit()
    # for the sample), its first: each transform's graph captured then
    peak = torch.cuda.max_memory_allocated() / 2**30
    reset_launches()
    caps = jitutil.captures
    graphed, gh, ge = timed(replayed)
    split["graphs_device_and_launch_ms"] = gh
    split["graphs_event_ms"] = ge
    split["graphs_captured"] = jitutil.captures - caps
    if read_launches() != c:
        raise AssertionError(f"matmul_ckks: the graphs' run launched "
                             f"{read_launches()}, the eager one {c}")
    same_outputs(graphed, out, "matmul_ckks")
    print(f"matmul_ckks: the apply with the graphs (diagonals and encodes "
          f"replayed) {gh:.1f} ms, {split['graphs_captured']} graphs "
          f"captured; bit-identical to the eager apply")
    del graphed

    # the same apply with the plain K2, the diagonals and encodes replayed;
    # the sites capture the plain chain as graphs of their own
    caps = jitutil.captures
    with swap(ntt_fused, "ntt", ntt_fused.ntt_plain), plain_own():
        reset_launches()
        t0 = time.time()
        ref = replayed()
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        if any(read_launches().values()):
            raise AssertionError("reference run launched a kernel")
    same_parts(out, ref, "matmul_ckks: kernel path != plain path")
    print(f"matmul_ckks: bit-identical to the plain-K2 chain ({plain_s:.1f} "
          f"s, {jitutil.captures - caps} graphs of the plain chain)")
    del diags, encodes, ref
    row = smp.row(c["ntt"])
    print(json.dumps({"metric": "torch_cuda_ckks_matmul_m16384_b360",
                      "setup_s": setup, "ms": split, "ntt": c["ntt"],
                      "max_abs_err": err, "max_abs_err_raw": raw_err,
                      "error_bound": bound, "plain_rerun_s": plain_s,
                      "ntt_row": row, "peak_mem_gb": peak, "card": card}))
    return row, ctx


# ---------------------------------------------------------------------------
# phase 17: m=35113 on the staged transforms, noise measurement, the CLI,
# fhe_stats, the binary export, the timers
# ---------------------------------------------------------------------------

# HElib's big bootstrapping size (benchmarks/thinboot_bench.py "big")
BIG_BOOT = dict(m=35113, p=2, r=1, bits=600, c=3, mvec=(37, 949))
BIG_BOOT_SEED, BIG_BOOT_HWT, BIG_BOOT_DATA_SEED = 141, 64, 145
# the CLI at phase 15's size, as the CLI takes it (no mvec argument)
CLI_CONTEXT = ("m=4095", "p=2", "r=1", "bits=500", "c=2")
CLI_DATA_SEED, CLI_VALUES = 171, 144
NOISE_SLACK_BITS = 40      # tests/test_noise_stats.py's non-vacuity bound


class steps:
    """Each step of phase 17 in a timing.timer (the host's wall clock, as
    helib_tpu's timers: no synchronize inside) and between two CUDA events
    (the device time of what it queued); `report` prints both."""

    def __init__(self):
        self.events: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        from helib_tpu_torch import timing
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        with timing.timer(name):
            yield
        b.record()
        self.events.setdefault(name, []).append((a, b))

    def report(self) -> dict:
        from helib_tpu_torch import timing
        torch.cuda.synchronize()
        print("diag: timing.print_all_timers (host s) and the CUDA-event ms "
              "of the same steps:")
        timing.print_all_timers(file=sys.stdout)
        out = {}
        for name, evs in self.events.items():
            count, host_s = timing.get_timer(name)
            out[name] = {"host_s": host_s, "count": count,
                         "event_ms": sum(a.elapsed_time(b) for a, b in evs)}
            print(f"  {name}: CUDA events {out[name]['event_ms']:.3f} ms")
        return out


def _big_boot_host(keys: dict, args: list) -> tuple:
    """Phase 17a's mult+relin through the port on the host CPU (in an
    `on_host` process): (its outputs, setup s, mult s)."""
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.pipeline import make_mult_relin

    t0 = time.time()
    ctx = Context(**BIG_BOOT, device="cpu")
    fn, _ = make_mult_relin(ctx, keys_from_arrays(ctx, keys))
    t1 = time.time()
    out = fn(*[torch.from_numpy(a) for a in args])
    return [t.numpy() for t in out], t1 - t0, time.time() - t1


def big_boot_path(dev, step) -> tuple:
    """Phase 17a: m=35113 (B = 131072) through the staged transforms, no
    kernel bar the lift's basis_ext: encrypt, mult+relin and an
    automorphism with its key switch, each decrypted to the host's product;
    the mult+relin started on the host CPU in a second process (the
    function returned waits and checks)."""
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.ctxt import Ctxt
    from helib_tpu_torch.keys import SecKey, PubKey, SKHandle, reduce_mod_phim
    from helib_tpu_torch.ops import ntt as nttmod
    from helib_tpu_torch.pipeline import make_mult_relin, make_automorph_relin

    torch.cuda.reset_peak_memory_stats()
    with step("17a setup (context, keys, 2 matrices)"):
        t0 = time.time()
        ctx = Context(**BIG_BOOT, device=dev)
        sk = SecKey(ctx, seed=BIG_BOOT_SEED, hwt=BIG_BOOT_HWT)
        pk = PubKey(sk)
        mfn, _ = make_mult_relin(ctx, sk)
        rfn, _ = make_automorph_relin(ctx, sk)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
    kexp = ctx.pal.gens[0]
    print(f"big: {ctx!r}; B = {ctx.ntt_fwd.B}; SecKey(seed={BIG_BOOT_SEED}, "
          f"hwt={BIG_BOOT_HWT}); setup {setup_s:.1f} s; automorphism "
          f"X -> X^{kexp}")
    L = ctx.L

    def ctxt(parts):
        return Ctxt(ctx, pk, [(SKHandle(0, 1, 0), parts[0]),
                              (SKHandle(1, 1, 0), parts[1])], L, False, 2,
                    0.0, 1)

    def check(name, got, want):
        if not np.array_equal(got, reduce_mod_phim(want % 2, ctx, 2)):
            raise AssertionError(f"big {name}: decrypt oracle failed")

    rng = np.random.default_rng(BIG_BOOT_DATA_SEED)
    pts = [rng.integers(0, 2, ctx.phi_m) for _ in range(2)]
    counts = {}

    def run(name, f):
        reset_launches()
        with step(f"17a {name}"):
            out = f()
            torch.cuda.synchronize()
        counts[name] = c = read_launches()
        if c["staged"] == 0 or any(v for k, v in c.items()
                                   if k != "staged" and k not in LIFT):
            raise AssertionError(f"big {name}: must run the staged "
                                 f"transforms and launch no kernel bar the "
                                 f"lift: {c}")
        return out

    cts = run("encrypt", lambda: [pk.encrypt_bgv(pt, rng) for pt in pts])
    parts = [[d for _, d in ct.parts] for ct in cts]
    for ct, pt in zip(cts, pts):
        check("encrypt", sk.decrypt_bgv(ct), pt)
    cap = capture(nttmod, "staged_conv")
    with cap:
        prod = run("mult+relin", lambda: mfn(*parts[0], *parts[1]))
    check("mult+relin", sk.decrypt_bgv(ctxt(prod)),
          np.convolve(pts[0], pts[1]))
    rot = run("automorph", lambda: rfn(*parts[0]))
    moved = np.zeros(ctx.m, dtype=np.int64)
    np.add.at(moved, (np.arange(ctx.phi_m) * kexp) % ctx.m, pts[0])
    check("automorph", sk.decrypt_bgv(ctxt(rot)), moved)
    print(f"big: encrypt, mult+relin and automorph decrypt oracles passed; "
          f"launches per op {json.dumps(counts)}")
    job = on_host(_big_boot_host, keys_arrays(sk),
                  [a.cpu().numpy() for a in (*parts[0], *parts[1])])
    out = [a.cpu().numpy() for a in prod]

    ms = {"mult+relin": host_ms(lambda: (mfn(*parts[0], *parts[1]),
                                        torch.cuda.synchronize()), 2),
          "automorph": host_ms(lambda: (rfn(*parts[0]),
                                       torch.cuda.synchronize()), 2)}
    ev = {"mult+relin": event_ms(lambda: mfn(*parts[0], *parts[1]), 2, 1),
          "automorph": event_ms(lambda: rfn(*parts[0]), 2, 1)}
    x, aux, khat, khat_sh = cap.calls[0]
    staged_ms = {
        "conv": event_ms(lambda: nttmod.staged_conv(x, aux, khat, khat_sh),
                         5, 1),
        "pow2_fwd": event_ms(lambda: nttmod.ntt_pow2_fwd(x, aux), 5, 1)}
    reset_launches()          # the timing runs are not the path's count
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"big: ms per op (host) {json.dumps(ms)}, (CUDA events) "
          f"{json.dumps(ev)}; one staged transform on {list(x.shape)}: "
          f"convolution {staged_ms['conv']:.3f} ms, power-of-2 forward "
          f"{staged_ms['pow2_fwd']:.3f} ms; {len(cap.calls)} staged "
          f"convolutions a mult+relin; peak {peak:.2f} GB")

    def host_check():
        host, h_setup, h_run = job.result()
        if not all(np.array_equal(a, b) for a, b in zip(out, host)):
            raise AssertionError("big mult+relin: GPU != CPU port")
        print(f"big: mult+relin bit-identical to the port on the host CPU "
              f"at the full {ctx.bits} bits (setup {h_setup:.1f} s, mult "
              f"{h_run:.1f} s on {job.threads} threads, in a second process)")
    return {"setup_s": setup_s, "ms_host": ms, "ms_events": ev,
            "staged_ms": staged_ms, "staged_shape": list(x.shape),
            "staged_convs_per_mult": len(cap.calls),
            "launches_per_op": counts, "peak_mem_gb": peak}, host_check


def noise_diag(held, step) -> dict:
    """Phase 17b: SecKey.noise_of and debugging.check_noise on phase 10's
    m=32003 context and keys, on a fresh encryption and on a mult+relin."""
    from helib_tpu_torch import debugging

    ctx, sk, pk, cts = held
    with step("17b mult+relin"):
        prod = cts[0].multiply(cts[1], pk)
    debugging.setup_debug_globals(sk)
    out = {}
    try:
        for name, ct in (("fresh", cts[0]), ("mult+relin", prod)):
            with step(f"17b noise_of {name}"):
                t0 = time.time()
                actual = sk.noise_of(ct)
                noise_ms = (time.time() - t0) * 1e3
            if not debugging.check_noise(ct, name):
                raise AssertionError(f"noise {name}: check_noise failed")
            if not ct.noise - actual < NOISE_SLACK_BITS:
                raise AssertionError(f"noise {name}: estimate {ct.noise} "
                                     f"vacuous over {actual}")
            out[name] = {"noise_of": actual, "estimate": ct.noise,
                         "noise_of_host_ms": noise_ms}
    finally:
        debugging.setup_debug_globals(None)
    print(f"noise: m={ctx.m}, bits={ctx.bits}: {json.dumps(out)}; "
          f"check_noise holds, estimate within {NOISE_SLACK_BITS} bits")
    return out


def cli_diag(dev, step) -> dict:
    """Phase 17c: the four commands of `python -m helib_tpu_torch.cli` as
    four processes on the card, in build/cli_smoke/ of the checkout; the
    decrypted file equals the input; Context.printout of the context."""
    from helib_tpu_torch import io as tio
    from helib_tpu_torch.security import context_security

    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, "build", "cli_smoke")
    os.makedirs(d, exist_ok=True)
    f = {k: os.path.join(d, v) for k, v in (
        ("ctx", "ctx.bin"), ("key", "key"), ("in", "data.txt"),
        ("ct", "ct.bin"), ("out", "out.txt"))}
    vals = np.random.default_rng(CLI_DATA_SEED).integers(0, 2, CLI_VALUES)
    np.savetxt(f["in"], vals, fmt="%d")
    cmds = [("create-context", *CLI_CONTEXT, f"out={f['ctx']}", "info"),
            ("key-gen", f"ctx={f['ctx']}", f"out={f['key']}"),
            ("encrypt", f"ctx={f['ctx']}", f"key={f['key']}.pk",
             f"in={f['in']}", f"out={f['ct']}"),
            ("decrypt", f"ctx={f['ctx']}", f"key={f['key']}.sk",
             f"in={f['ct']}", f"out={f['out']}")]
    secs = {}
    for cmd in cmds:
        with step(f"17c cli {cmd[0]}"):
            t0 = time.time()
            done = subprocess.run(
                [sys.executable, "-m", "helib_tpu_torch.cli", *cmd],
                cwd=root, capture_output=True, text=True, timeout=300)
            secs[cmd[0]] = time.time() - t0
        if done.returncode:
            raise AssertionError(f"cli {cmd[0]} failed: {done.stderr}")
        print(f"cli: {cmd[0]} ({secs[cmd[0]]:.1f} s): "
              f"{done.stdout.strip().splitlines()[-1]}")
    got = np.loadtxt(f["out"], dtype=np.int64, ndmin=1)
    if not np.array_equal(got, vals):
        raise AssertionError("cli: decrypted file != input")
    with open(f["ctx"], "rb") as fh:
        ctx = tio.read_context(fh, device=dev)
    print(f"cli: {CLI_VALUES} values round-tripped on the card; "
          f"Context.printout:")
    ctx.printout(sys.stdout)
    return {"s_per_command": secs, "security": context_security(ctx)}


def stats_diag(held15, ctx16, step) -> dict:
    """Phase 17d: one mult+relin on phase 15's context with fhe_stats on
    (break-into-digits-ratio and KS-noise-ratio) and four CKKS encodes at
    phase 16's m=16384 (CKKS_encode_ratio); fhe_stats off again after."""
    from helib_tpu_torch import timing
    from helib_tpu_torch.ckks import EncryptedArrayCKKS

    ctx, sk, pk, ea = held15
    rng = np.random.default_rng(BINARY_DATA_SEED)
    a, b = (ea.encrypt(list(rng.integers(0, 2, ea.nslots)), pk, rng)
            for _ in range(2))
    eac = EncryptedArrayCKKS(ctx16)
    timing.reset_stats()
    timing.fhe_stats = True
    try:
        with step("17d mult+relin with fhe_stats"):
            a.multiply(b, pk)
        with step("17d 4 CKKS encodes with fhe_stats"):
            for _ in range(4):
                eac.encode(rng.normal(size=eac.nslots)
                           + 1j * rng.normal(size=eac.nslots))
    finally:
        timing.fhe_stats = False
    out = {}
    for name in ("break-into-digits-ratio", "KS-noise-ratio",
                 "CKKS_encode_ratio"):
        s = timing._stats.get(name)
        if s is None or not s.count or not s.max <= 1.0:
            raise AssertionError(f"stats: {name} {s}")
        out[name] = {"count": s.count, "max": s.max}
    timing.reset_stats()
    print(f"stats: {json.dumps(out)} (each max <= 1); fhe_stats off")
    return out


def export_diag(held15, step) -> dict:
    """Phase 17e: export_helib_binary of phase 15's context, SecKey, PubKey
    (its relinearization matrix alone) and one ciphertext; read back with
    read_binary_dump, HElib's decryption identity c0 + c1*s = p*e on the
    exported rows, and the same bytes as the export of the same objects
    carried to the host CPU by convert.py."""
    from helib_tpu_torch import convert, io_helib_bin
    from helib_tpu_torch.ctxt import Ctxt
    from helib_tpu_torch.dcrt import crt_reconstruct
    from helib_tpu_torch.keys import PubKey
    from helib_tpu_torch.ops.modops import to_device, to_host

    ctx, sk, pk, ea = held15
    relin = {(2, 1): pk.matrices[(2, 1)]}
    pk1 = PubKey.restore(ctx, pk.enc_key, pk.enc_noise, pk.sk_bound, relin)
    rng = np.random.default_rng(BINARY_DATA_SEED + 1)
    ct = ea.encrypt(list(rng.integers(0, 2, ea.nslots)), pk1, rng)
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "build", "cli_smoke", "export.bin")
    with step("17e export_helib_binary"):
        t0 = time.time()
        io_helib_bin.export_helib_binary(path, ctx, sk=sk, pk=pk1,
                                         ctxts=[ct])
        export_s = time.time() - t0
    with step("17e read_binary_dump"):
        d = io_helib_bin.read_binary_dump(path)
    if ((d.m, d.p, d.r) != (ctx.m, ctx.p, ctx.r) or
            [k.handle for k in d.ks_matrices] != [(2, 1, 0)] or
            d.primes != [int(q) for q in ctx.all_q]):
        raise AssertionError("export: the dump's fields differ")
    # c0 + c1*s per prime at the exported (primitive-root) columns equals
    # the card's decryption of pubEncrKey, p*e: even and small
    res, rows = sk._inner_product_residues(Ctxt(
        ctx, pk1, list(pk1.enc_key), ctx.L, False, ctx.ptxt_space,
        pk1.enc_noise, 1))
    pe = crt_reconstruct(ctx, res, rows)
    if any(int(v) % ctx.p for v in pe) or max(abs(int(v)) for v in pe) \
            >= 2 ** 40:
        raise AssertionError("export: pubEncrKey does not decrypt to p*e")
    prim = np.array([j for j in range(ctx.m) if math.gcd(j, ctx.m) == 1])
    ev = to_host(ctx.fwd_ntt(to_device(res, ctx.device), rows))[:, prim]
    for i, q in enumerate(d.primes[:3]):
        c0, c1 = (np.array(d.pub_enc_parts[j][2][i], dtype=np.int64)
                  for j in (0, 1))
        v = (c0 + c1 * np.array(d.sk_rows[i], dtype=np.int64) % q) % q
        if not np.array_equal(v, ev[i].astype(np.int64)):
            raise AssertionError("export: c0 + c1*s != p*e on the rows")
    # the same export from the host CPU
    ctx_cpu = convert.context_from_params(convert.context_params(ctx), "cpu")
    sk_cpu = keys_from_arrays(ctx_cpu, keys_arrays(sk))
    pk_cpu = PubKey.restore(ctx_cpu, sk_cpu.pubkey.enc_key,
                            pk.enc_noise, pk.sk_bound,
                            {(2, 1): sk_cpu.matrices[(2, 1)]})
    ct_cpu = convert.ctxt_from_arrays(ctx_cpu, pk_cpu,
                                      **convert.ctxt_arrays(ct))
    host_path = path + ".host"
    io_helib_bin.export_helib_binary(host_path, ctx_cpu, sk=sk_cpu,
                                     pk=pk_cpu, ctxts=[ct_cpu])
    with open(path, "rb") as f, open(host_path, "rb") as g:
        blob = f.read()
        if blob != g.read():
            raise AssertionError("export: card bytes != host-CPU bytes")
    print(f"export: {len(blob)} bytes in {export_s:.2f} s; read back, "
          f"c0 + c1*s = p*e on the exported rows, the same bytes as the "
          f"host CPU's export")
    return {"bytes": len(blob), "export_s": export_s}


def diag_path(dev, card: str, held10, held15, ctx16) -> None:
    """Phase 17: a-f in order, the m=35113 host-CPU check collected last."""
    from helib_tpu_torch import timing

    timing.reset_all_timers()
    timing.tracing = True
    try:
        step = steps()
        big, host_check = big_boot_path(dev, step)
        noise = noise_diag(held10, step)
        cli = cli_diag(dev, step)
        stats = stats_diag(held15, ctx16, step)
        export = export_diag(held15, step)
        with step("17a host-CPU check (wait)"):
            host_check()
        timers = step.report()
    finally:
        timing.tracing = False
        timing.reset_spans()
    print(json.dumps({"metric": "torch_cuda_diag_phase17", "big": big,
                      "noise": noise, "cli": cli, "stats": stats,
                      "export": export, "timers": timers, "card": card}))


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


def kernel_times(fn, args) -> tuple[list, float, int]:
    """One call of fn(*args) under torch.profiler (the card's activity
    alone): [(kernel name, launches, ms)] longest first, the call's wall
    seconds, and the launches the host issued: the distinct correlation ids
    of the card's activity (the kernels, copies and fills of one CUDA-graph
    replay share its launch's)."""
    from torch.profiler import profile as prof, ProfilerActivity
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        t0 = time.time()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.time() - t0
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict = {}
    issued = set()
    for e in p.profiler.kineto_results.events():
        if e.device_type() == cuda and e.duration_ns() > 0:
            count, ns = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (count + 1, ns + e.duration_ns())
            issued.add(e.correlation_id())
    rows = sorted(((k, c, ns / 1e6) for k, (c, ns) in by_name.items()),
                  key=lambda r: -r[2])
    return rows, wall, len(issued)


def profile(fn, args, label: str, top: int = 10, warmup: bool = True):
    """Device time of one call by kernel name (torch.profiler, the card's
    activity alone), and the call's wall time: the share of the call the
    device is busy, after one unprofiled call unless `warmup` is False.
    The raw kernel events are summed here: key_averages() takes minutes
    over a bootstrap's ~4e5 launches."""
    if warmup:
        fn(*args)
    rows, wall, issued = kernel_times(fn, args)
    busy = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"profile ({label}): one call {wall * 1e3:.3f} ms wall, device "
          f"busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f} %), "
          f"{launches} kernels and copies on the card, {issued} launches "
          f"from the host")
    for key, count, ms in rows[:top]:
        print(f"  {ms:9.3f} ms {count:5d}x  {key[:90]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy,
            "busy_share": busy / (wall * 1e3), "launches": launches,
            "issued": issued, "rows": rows}


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


# the six paths read with their graphs and under disable_jit(), printed
# together at the end
GRAPH_ROWS: list = []


def flat_tensors(x) -> list:
    """The tensors of an output: a tensor, a Ctxt's parts, nested
    sequences of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if hasattr(x, "parts"):
        return [d for _, d in x.parts]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in flat_tensors(v)]
    return []


def same_outputs(a, b, what: str):
    ta, tb = flat_tensors(a), flat_tensors(b)
    if not ta or len(ta) != len(tb) or not all(
            torch.equal(x, y) for x, y in zip(ta, tb)):
        raise AssertionError(f"{what}: the graphed call != the same call "
                             f"under disable_jit()")


def in_mode(fn, args, label: str, eager: bool) -> tuple:
    """fn(*args), warm, with its graphs or under disable_jit(): one call
    timed (host and CUDA-event ms) and one under the profiler (the
    launches the host issued, the kernels and copies on the card, device
    ms and busy share), the peak memory of the two; (those numbers, the
    timed call's outputs).  With the graphs, one call before them, so
    every graph is captured and has been replayed once."""
    from helib_tpu_torch.jitutil import disable_jit
    if not eager:
        fn(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with disable_jit() if eager else contextlib.nullcontext():
        out, h, e = timed(lambda: fn(*args))
        p = profile(fn, args, f"{label}, {'eager' if eager else 'graphs'}",
                    top=3, warmup=False)
    return mode_numbers(h, e, p), out


def mode_numbers(host_ms: float, event_ms: float, prof: dict) -> dict:
    """One mode's numbers from a timed call and a profiled one; the kernels
    of ops/csrc are counted by name (a replay's kernel nodes must be
    reported as the eager launches are)."""
    ours = sum(c for name, c, _ in prof["rows"] if "ntt_rows_kernel" in name)
    return {"host_ms": host_ms, "event_ms": event_ms,
            "issued": prof["issued"], "kernels": prof["launches"],
            "ntt_rows_kernels": ours, "device_ms": prof["busy_ms"],
            "busy_share": prof["busy_share"], "profiled_ms": prof["wall_ms"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def graph_row(label: str, graphs: dict, eager: dict, captures: int,
              card: str, **extra) -> dict:
    """Records one path's numbers with its graphs and under disable_jit(),
    the graphs its first (cold) call captured and the bytes the shared
    graph pool holds."""
    from helib_tpu_torch import jitutil
    # a replay's kernel nodes are reported under their own names (the
    # profiler may drop an event now and then, so the counts are printed,
    # not compared)
    if eager["ntt_rows_kernels"] and not graphs["ntt_rows_kernels"]:
        raise AssertionError(f"{label}: the profiler saw no kernel of "
                             f"ops/csrc in the graphs' call")
    row = {"path": label, "graphs": graphs, "eager": eager,
           "captures": captures,
           "pool_bytes": jitutil.pool_bytes(torch.device("cuda")),
           "all_captures": jitutil.captures, **extra}
    GRAPH_ROWS.append(row)
    print(json.dumps({"metric": "torch_cuda_graphs_beside_eager", **row,
                      "card": card}))
    return row


def graphs_beside_eager(label: str, fn, args, captures: int, card: str,
                        **extra) -> dict:
    """graph_row of fn(*args) read in both modes, whose outputs must be
    equal bit for bit."""
    g, out = in_mode(fn, args, label, eager=False)
    e, ref = in_mode(fn, args, label, eager=True)
    same_outputs(out, ref, label)
    return graph_row(label, g, e, captures, card, **extra)


def batched_row(label: str, fn, args, captures: int, card: str) -> dict:
    """graphs_beside_eager of a batched lifted_jit path, with its ops/s in
    both modes (timing)."""
    from helib_tpu_torch.jitutil import disable_jit
    g = timing(fn, args)
    with disable_jit():
        e = timing(fn, args)
    return graphs_beside_eager(
        label, fn, args, captures, card,
        ops_per_s={"graphs": g["ops_per_s"], "eager": e["ops_per_s"]})


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
# P2 at K1's n and at K3's cluster size (4 CTAs of 64 KB quarters)
P2_SIZES = (16384, 65536)


def probe_bound_ms(kind: str, variant: str, R: int, n: int):
    """(bytes bound, multiplies bound) in ms of one application: x read and
    out written once, the twiddles the variant reads once; 3 32-bit
    multiplies a Shoup product.  The distributed shared memory of P2's
    cross composite is on-chip traffic (probe_dsmem_bytes), not here."""
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


def probe_dsmem_bytes(kind: str, variant: str, R: int, n: int) -> int:
    """The bytes one application moves between the CTAs of a cluster:
    P2's coarse phase at n = 65536 writes the 3 quarters of a row that
    belong to the other CTAs of its 4-CTA cluster, and reads them back."""
    if kind == "p2" and variant == "coarse" and n == 65536:
        return 2 * 4 * R * n * 3 // 4
    return 0


def median_event_ms(fn, reps: int = 5) -> float:
    """Median over `reps` runs of fn()'s device time in ms, each run queued
    behind a sleep kernel, after one warm run."""
    fn()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def probe_cases(dev, sizes=P2_SIZES) -> list:
    """(kernels-line row, kind, variant, n, x, tables, chain length) of
    every P1 variant on [PROBE_ROWS, PROBE_N] and every P2 phase on
    [PROBE_ROWS, n] for n in sizes, from seed 0.  P2 at n != PROBE_N is a
    row of its own (p2_65536)."""
    from helib_tpu_torch.ops import probes
    from helib_tpu_torch.ops.ntt import aux_primes, aux_tree
    from helib_tpu_torch.ops.modops import shoup, to_device

    R = PROBE_ROWS
    qrow = aux_primes()[np.arange(R) % 3].astype(np.uint32)
    rng = np.random.default_rng(0)

    def rows_of(n):
        return to_device(rng.integers(0, qrow[:, None].astype(np.int64),
                                      (R, n)).astype(np.uint32), dev)
    X = rows_of(PROBE_N)
    w = rng.integers(1, qrow[:, None].astype(np.int64), (R, PROBE_N))
    wsh = shoup(w.astype(np.uint32), qrow[:, None].astype(np.uint64))
    W, WS, Q = (to_device(a.astype(np.uint32), dev)
                for a in (w, wsh, qrow[:, None]))
    cases = [("p1", "p1", v, PROBE_N, X, (W, WS, Q), P1_CHAIN)
             for v in probes.P1_VARIANTS]
    for n in sizes:
        aux = aux_tree(n, dev)["aux"]
        tabs = (aux["tw_all"], aux["tw_all_sh"], aux["q"].reshape(3, 1))
        xn = X if n == PROBE_N else rows_of(n)
        row = "p2" if n == PROBE_N else f"p2_{n}"
        cases += [(row, "p2", ph, n, xn, tabs, P2_CHAIN)
                  for ph in probes.P2_PHASES]
    return cases


def probe_apply(kind: str, v: str, x, args, count: int = 1,
                plain: bool = False):
    """`count` chained applications of probe `kind` variant v to x, by
    its kernel or by its plain version."""
    from helib_tpu_torch.ops import probes
    f = getattr(probes, f"{kind}_{'plain' if plain else 'cuda'}")
    o = x
    for _ in range(count):
        o = f(v, o, *args)
    return o


def check_probes(cases) -> None:
    """Each probe == its plain version bit for bit, alone and chained 3
    times."""
    for _, kind, v, n, x, args, _ in cases:
        for count in (1, 3):
            if not torch.equal(probe_apply(kind, v, x, args, count),
                               probe_apply(kind, v, x, args, count, True)):
                raise AssertionError(f"{kind} {v} at n={n}: {count} "
                                     f"kernel application(s) != plain")


def probe_us(cases, reps: int = 5) -> dict:
    """Microseconds an application of each case, keyed kind/variant/n: the
    median of its chain's device time over `reps` runs, over the chain's
    length."""
    return {f"{kind}/{v}/{n}": median_event_ms(
        lambda: probe_apply(kind, v, x, args, count), reps) / count * 1e3
        for _, kind, v, n, x, args, count in cases}


def conv_rows_us(dev, reps: int = 5) -> dict:
    """Microseconds a row of K1 and K5 at n = PROBE_N on [1, 3, 54, n] and
    of K3 at n = 65536 on the aux-major [3, 2, 27, n] (162 rows each)."""
    from helib_tpu_torch.ops import ntt2
    from helib_tpu_torch.ops.conv import conv_aux_cuda, conv_cuda
    a1 = conv_inputs(PROBE_N, 54, (1,), seed=7, dev=dev)
    x3, aux3, kh3, khsh3 = conv_inputs(65536, 27, (2,), seed=8, dev=dev)
    a3 = (x3.movedim(1, 0).contiguous(), aux3, kh3, khsh3)
    out = {}
    for name, fn, a, n in (("k1", conv_cuda, a1, PROBE_N),
                           ("k5", ntt2.conv2_cuda, a1, PROBE_N),
                           ("k3", conv_aux_cuda, a3, 65536)):
        out[name] = median_event_ms(lambda: [fn(*a) for _ in range(10)],
                                    reps) / 10 / (a[0].numel() // n) * 1e3
    return out


def probe_path(dev, card: str) -> list:
    """Each probe against its plain version on the card, alone and over a
    chain of 3, then the probe run of each kernels-line row (counts reset
    before, read after) and the timings; K1 and K5 a row at n = 16384 and
    K3 a row at n = 65536 for comparison.  Returns the rows p1, p2 (P2 at
    n = 16384, as the TPU probe runs it) and p2_65536."""
    from helib_tpu_torch.ops import probes, ntt2

    R = PROBE_ROWS
    cases = probe_cases(dev)
    check_probes(cases)
    print(f"probes: P1 ({len(probes.P1_VARIANTS)} variants) on [{R}, "
          f"{PROBE_N}] and P2 ({len(probes.P2_PHASES)} phases) on [{R}, n], "
          f"n = {', '.join(map(str, P2_SIZES))}, == plain bit for bit, alone "
          f"and over a chain of 3")

    names = list(dict.fromkeys(c[0] for c in cases))
    launches = {}
    for name in names:
        mine = [c for c in cases if c[0] == name]
        kind = mine[0][1]
        reset_launches()
        for _, _, v, _, x, args, count in mine:
            probe_apply(kind, v, x, args, count)
        torch.cuda.synchronize()
        got = read_launches()
        want = sum(c[6] for c in mine)
        print(f"probes: the {name} run launched {got}")
        if got[kind] != want or any(v for k, v in got.items() if k != kind):
            raise AssertionError(f"{name} run: unexpected launches "
                                 f"(expected {kind}: {want} alone)")
        launches[name] = got[kind]

    k_us = conv_rows_us(dev)
    print(f"probes: per row: K1 {k_us['k1']:.3f} us and K5 (k="
          f"{ntt2.K_MAX}) {k_us['k5']:.3f} us at n={PROBE_N}, K3 "
          f"{k_us['k3']:.3f} us at n=65536")

    app_us = probe_us(cases)
    detail = {}
    for _, kind, v, n, x, args, _ in cases:
        app = app_us[f"{kind}/{v}/{n}"] / 1e3
        pl = event_ms(lambda: probe_apply(kind, v, x, args, plain=True),
                      reps=2, warm=1)
        b, o = probe_bound_ms(kind, v, R, n)
        dsmem = probe_dsmem_bytes(kind, v, R, n)
        by = "bytes" if b >= o else "operations"
        detail[f"{kind}/{v}/{n}"] = {
            "us_per_app": app * 1e3, "us_per_row": app * 1e3 / R,
            "bound_us": max(b, o) * 1e3, "bound_by": by,
            "bytes_bound_us": b * 1e3, "ops_bound_us": o * 1e3,
            "plain_us": pl * 1e3, "dsmem_bytes": dsmem}
        print(f"probes: {kind} {v:9s} n={n:5d} {app * 1e3:9.2f} us/app "
              f"{app * 1e3 / R:7.3f} us/row, bound {max(b, o) * 1e3:8.2f} us "
              f"({by}; bytes {b * 1e3:.2f}, operations {o * 1e3:.2f})"
              + (f", {dsmem / 2**20:.1f} MiB through distributed shared "
                 f"memory" if dsmem else "")
              + f", plain {pl * 1e3:10.1f} us")
    for n, k_name in ((PROBE_N, "k1"), (65536, "k3")):
        us = {ph: detail[f"p2/{ph}/{n}"]["us_per_row"]
              for ph in probes.P2_PHASES}
        both = us["coarse"] + us["fine"] - us["memory"]
        print(f"probes: at n={n} per row: memory {us['memory']:.3f}, "
              f"coarse {us['coarse']:.3f}, fine {us['fine']:.3f} us; coarse "
              f"+ fine - memory = {both:.3f} us = "
              f"{100 * both / k_us[k_name]:.1f} % of {k_name.upper()}'s "
              f"{k_us[k_name]:.3f} us")
    stages = {n: probes.p2_range("coarse", n.bit_length() - 1)[1]
              for n in P2_SIZES}
    per_ws = {n: detail[f"p2/coarse/{n}"]["us_per_row"] * 1e3
              / (n * stages[n]) for n in P2_SIZES}
    print("probes: coarse per word and stage: " + ", ".join(
        f"{per_ws[n]:.4f} ns at n={n} ({stages[n]} stages)"
        for n in P2_SIZES))

    # one kernels-line row a name: the mean over its variants or phases
    replaces = {"p1": "benchmarks/kernel_parts.py:26",
                "p2": "benchmarks/kernel_phases.py:31"}
    rows = []
    for name in names:
        mine = [detail[f"{kind}/{v}/{n}"]
                for row, kind, v, n, *_ in cases if row == name]
        bb = sum(d["bytes_bound_us"] for d in mine) / 1e3
        bo = sum(d["ops_bound_us"] for d in mine) / 1e3
        nv = len(mine)
        rows.append({"name": name, "route": "cuda",
                     "source": "helib_tpu_torch/ops/csrc/probes.cu",
                     "replaces": replaces[name[:2]],
                     "launches": launches[name], "max_abs_err": 0,
                     "ms": sum(d["us_per_app"] for d in mine) / 1e3 / nv,
                     "plain_ms": sum(d["plain_us"] for d in mine) / 1e3 / nv,
                     "bound_ms": max(bb, bo) / nv,
                     "bound_by": "bytes" if bb >= bo else "operations",
                     "library_ms": None})
    print(json.dumps({"metric": "torch_cuda_probes_us", "rows": R,
                      "p1_n": PROBE_N, "p2_n": list(P2_SIZES),
                      "variants": detail, "k1_us_per_row": k_us["k1"],
                      "k5_us_per_row": k_us["k5"],
                      "k3_us_per_row_65536": k_us["k3"], "card": card}))
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


# ---------------------------------------------------------------------------
# phase 18: the parallel layer (ranks on the card, started by
# parallel.distributed.launch)
# ---------------------------------------------------------------------------

# the gloo ranks share the card (NCCL refuses two ranks on one device), each
# with its share of the host's threads; their setup runs beside phase 19
RANKS = 2
BOOT_SHARDED = dict(m=1271, p=2, r=1, bits=360, c=3, mvec=(31, 41))


def rank_op(fn, args) -> tuple:
    """One counted run of fn(*args) on every rank at once (a barrier
    first): (outputs, its launches, collectives, host ms and CUDA-event ms,
    and the blocks its limb gathers returned, for solo_device_ms)."""
    import torch.distributed as dist
    from helib_tpu_torch.parallel import distributed as pdist
    from helib_tpu_torch.parallel.mesh import LimbShard
    gathered = []
    orig = LimbShard.gather

    def rec(self, s, e, x):
        gathered.append(orig(self, s, e, x))
        return gathered[-1]
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()
    pdist.reset_collectives()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with swap(LimbShard, "gather", rec):
        t0 = time.time()
        a.record()
        out = fn(*args)
        b.record()
        torch.cuda.synchronize()
    host = (time.time() - t0) * 1e3
    return out, {"launches": read_launches(),
                 "collectives": pdist.read_collectives(), "host_ms": host,
                 "event_ms": a.elapsed_time(b)}, gathered


def solo_device_ms(fn, args, gathered: list) -> float:
    """This rank's device ms of fn(*args) alone on the card: the ranks take
    turns (the others wait at a barrier), each profiling its own rows' work
    with the limb gathers replaying `gathered` (two processes on one card
    time-slice it, which stretches the kernels each profiles at once)."""
    import torch.distributed as dist
    from helib_tpu_torch.parallel.mesh import LimbShard
    ms = 0.0
    for r in range(dist.get_world_size()):
        dist.barrier()
        if dist.get_rank() == r:
            it = iter(gathered)
            with swap(LimbShard, "gather", lambda self, s, e, x: next(it)):
                rows = kernel_times(fn, args)[0]
            ms = sum(row[2] for row in rows)
    dist.barrier()
    return ms


def solo_op(fn, args, warmup: bool = True, profiled: bool = True) -> tuple:
    """fn(*args) on rank 0 alone, the other ranks waiting at a barrier:
    (rank 0's outputs or None, its host ms, CUDA-event ms and, if
    `profiled`, the device ms of a second run), after a warm-up run if
    `warmup`."""
    import torch.distributed as dist
    dist.barrier()
    out = stats = None
    if dist.get_rank() == 0:
        if warmup:
            fn(*args)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.time()
        a.record()
        out = fn(*args)
        b.record()
        torch.cuda.synchronize()
        stats = {"host_ms": (time.time() - t0) * 1e3,
                 "event_ms": a.elapsed_time(b)}
        if profiled:
            rows = kernel_times(fn, args)[0]
            stats["device_ms"] = sum(r[2] for r in rows)
    dist.barrier()
    return out, stats


def _profiler_warmup(dev):
    """The profiler's start-up (seconds, once a process) before the gate."""
    kernel_times(lambda: torch.ones(1, device=dev).add_(1), ())


def _nccl_rank(gate) -> dict:
    """18a on a one-rank NCCL group: phase 4's size on a (1, 1) mesh; the
    gather of the result is one NCCL all_gather."""
    import torch.distributed as dist
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey
    from helib_tpu_torch.parallel.distributed import rank_device
    from helib_tpu_torch.parallel.mesh import make_mesh, sharded_mult_relin
    dev = rank_device("cuda")
    ctx = Context(m=M, p=P_PLAIN, r=1, bits=BITS, c=C, device=dev)
    mesh = make_mesh(1)
    fn, ex = sharded_mult_relin(ctx, SecKey(ctx, seed=SEED), mesh, BATCH)
    _profiler_warmup(dev)
    gate.wait()
    fn(*ex)
    out, st, got = rank_op(fn, ex)
    st["device_ms"] = solo_device_ms(fn, ex, got)
    st["backend"] = dist.get_backend()
    st["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return {"out": [mesh.gather(o).cpu() for o in out], "stats": st}


def _bgv_batch_rank(dev):
    """18b: phase 4's size on a (batch=2, limb=1) mesh (L = 13 is odd);
    returns the run, after the setup."""
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey
    from helib_tpu_torch.parallel.mesh import make_mesh, sharded_mult_relin
    ctx = Context(m=M, p=P_PLAIN, r=1, bits=BITS, c=C, device=dev)
    mesh = make_mesh(RANKS, batch_axis=RANKS)
    fn, ex = sharded_mult_relin(ctx, SecKey(ctx, seed=SEED), mesh, BATCH)

    def run():
        fn(*ex)
        out, st, got = rank_op(fn, ex)
        expect_only(st["launches"], "conv", "phase 18b")
        st["device_ms"] = solo_device_ms(fn, ex, got)
        out = [mesh.gather(o) for o in out]
        return {"out": [o.cpu() for o in out] if mesh.coords == (0, 0)
                else None, "stats": st, "shape": tuple(ex[0].shape)}
    return run


def _big_limb_rank(dev):
    """18c: m=32003, bits=5800 on a (batch=1, limb=2) mesh, batch 2: the
    sharded mult+relin and rotate through K3 alone, gathered and held to
    the unsharded port run on rank 0 alone; returns the run."""
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey
    from helib_tpu_torch.parallel.mesh import (make_mesh, sharded_mult_relin,
                                               sharded_automorph_relin)
    from helib_tpu_torch.pipeline import (make_batched_mult_relin,
                                          make_automorph_relin)
    t0 = time.time()
    ctx = Context(**BIG, device=dev)
    sk = SecKey(ctx, seed=BIG_SEED)
    mesh = make_mesh(RANKS, batch_axis=1)
    ops = [("mult", *sharded_mult_relin(ctx, sk, mesh, 2)),
           ("rotate", *sharded_automorph_relin(ctx, sk, mesh, 2))]
    afn, aex = make_automorph_relin(ctx, sk)
    plain = {"mult": make_batched_mult_relin(ctx, sk, 2),
             "rotate": (afn, tuple(e.unsqueeze(0).expand((2,) + e.shape)
                                   for e in aex))}
    res = {"setup_s": time.time() - t0, "rows": len(mesh.rows(ctx.L)),
           "L": ctx.L, "S": ctx.S, "shape": tuple(ops[0][2][0].shape)}

    def run():
        for name, fn, ex in ops:
            fn(*ex)
            out, st, got = rank_op(fn, ex)
            expect_only(st["launches"], "conv_aux", f"phase 18c {name}")
            st["device_ms"] = solo_device_ms(fn, ex, got)
            res[name] = st
            out = [mesh.gather(o) for o in out]
            # the unsharded port on the same inputs, on rank 0 alone
            want, res[name + "_unsharded"] = solo_op(*plain[name])
            if want is not None and not all(torch.equal(g, w)
                                            for g, w in zip(out, want)):
                raise AssertionError(f"phase 18c {name}: sharded != "
                                     f"unsharded")
        return res
    return run


def _four_step_rank(dev):
    """18d: ShardedNTT at n = 65536 (negacyclic) against K2 both ways, and
    the m=31775 bluestein_apply_sharded (B = 65536) against the unsharded
    K3 path, both directions, A = 2 over the two ranks; returns the run."""
    import torch.distributed as dist
    from helib_tpu_torch.nt.primegen import gen_primes
    from helib_tpu_torch.ops import ntt_fused
    from helib_tpu_torch.ops.modops import to_device
    from helib_tpu_torch.ops.ntt import (BluesteinTables, aux_tree,
                                         aux_primes, bluestein_apply)
    from helib_tpu_torch.parallel.sharded_ntt import (ShardedNTT,
                                                      bluestein_apply_sharded)
    group = dist.group.WORLD
    n, m = 65536, 31775
    x, t = ntt_inputs(n, 2, (), 181, dev)
    s = ShardedNTT(np.array(gen_primes(2 * n, 2), dtype=np.uint32), n,
                   negacyclic=True, A=RANKS, device=dev).set_group(group)
    lo, hi = s.span()
    qs = np.array(gen_primes(2 * m, 2), dtype=np.uint32)
    sntt = ShardedNTT(aux_primes(), 65536, negacyclic=False, A=RANKS,
                      device=dev).set_group(group)
    rng = np.random.default_rng(183)
    xb = to_device(rng.integers(0, qs[:, None].astype(np.int64),
                                (len(qs), m)).astype(np.uint32), dev)
    trees = {}
    for inverse in (False, True):
        bt = BluesteinTables(qs, m, inverse, dev)
        trees[inverse] = (bt.tree(dev, range(len(qs)), aux_tree(bt.B, dev)),
                          bt.B)

    def run():
        res = {}
        y, res["ntt_fwd"], _ = rank_op(lambda v: s.gather(s.fwd(v)),
                                       (x[..., lo:hi].contiguous(),))
        if not torch.equal(y, ntt_fused.ntt(x, t, False)):
            raise AssertionError("phase 18d: ShardedNTT fwd != K2's forward")
        back, res["ntt_inv"], _ = rank_op(lambda v: s.gather(s.inv(v)),
                                          (y[..., lo:hi].contiguous(),))
        if not torch.equal(back, x):
            raise AssertionError("phase 18d: ShardedNTT inv is not the "
                                 "inverse")
        _, res["ntt_k2"] = solo_op(lambda v: ntt_fused.ntt(v, t, False),
                                   (x,), profiled=False)
        for inverse, (tb, B) in trees.items():
            tag = "bluestein_" + ("inv" if inverse else "fwd")
            got, res[tag], _ = rank_op(
                lambda v: bluestein_apply_sharded(v, tb, m, B, sntt), (xb,))
            reset_launches()
            want = bluestein_apply(xb, tb, m, B)
            if read_launches()["conv_aux"] != 1 or not torch.equal(got, want):
                raise AssertionError(f"phase 18d: sharded {tag} != the "
                                     f"unsharded K3 path")
            _, res[tag + "_k3"] = solo_op(
                lambda v: bluestein_apply(v, tb, m, B), (xb,), profiled=False)
        return res
    return run


def _boot_rank(dev):
    """18e: the dry run's thin bootstrap at m=1271 (A = 2) on the sharded
    transforms, with the PubKey after one unsharded cold run with the
    SecKey has minted the matrices (in the setup); it decrypts to its slots
    with capacity restored, launches no kernel bar the noise's embed_max
    and the lift's basis_ext and equals the unsharded
    warm run on rank 0 alone; returns the run."""
    import torch.distributed as dist
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey, PubKey
    from helib_tpu_torch.ea import EncryptedArray
    from helib_tpu_torch.recryption import RecryptData, thin_recrypt
    t0 = time.time()
    ctx = Context(**BOOT_SHARDED, device=dev)
    sk = SecKey(ctx, seed=141, hwt=64)
    pk = PubKey(sk)
    ea = EncryptedArray(ctx)
    rc = RecryptData(ctx, sk, ea, hwt=64)
    rng = np.random.default_rng(143)
    slots = [int(v) for v in rng.integers(0, 2, ea.nslots)]
    ct = ea.encrypt(slots, pk, rng)
    ct.bring_to_k(3)                       # capacity nearly spent
    res = {"setup_s": time.time() - t0}

    def check(out, what):
        if [int(v) for v in ea.decrypt_ints(out, sk)] != slots:
            raise AssertionError(f"phase 18e {what}: wrong decrypt")
        if out.capacity() <= ct.capacity():
            raise AssertionError(f"phase 18e {what}: capacity not restored")
        return out.capacity()

    t0 = time.time()
    check(thin_recrypt(ct, rc, sk), "cold")
    torch.cuda.synchronize()
    res["cold_unsharded_s"] = time.time() - t0

    def run():
        ctx.enable_sharded_transforms(RANKS, dist.group.WORLD)
        warm, st, _ = rank_op(lambda c: thin_recrypt(c, rc, pk), (ct,))
        ctx.disable_sharded_transforms()
        if st["launches"]["sharded"] == 0 or any(
                v for k, v in st["launches"].items()
                if k != "sharded" and k not in NOISE):
            raise AssertionError(f"phase 18e: launched {st['launches']}")
        res["warm"] = st
        res["capacity"] = (ct.capacity(), check(warm, "warm"))
        ref, res["warm_unsharded"] = solo_op(
            lambda c: thin_recrypt(c, rc, pk), (ct,), warmup=False,
            profiled=False)
        if ref is not None:
            same_parts(warm, ref, "phase 18e warm sharded vs unsharded")
        return res
    return run


def _gloo_ranks(gate) -> dict:
    """Phases 18b-e on one rank of the gloo group sharing the card: every
    setup, then the runs once the gate opens."""
    from helib_tpu_torch.parallel.distributed import rank_device
    torch.set_num_threads(max(1, (os.cpu_count() or RANKS) // RANKS))
    dev = rank_device("cuda")
    t0 = time.time()
    runs = [(tag, fn(dev)) for tag, fn in (
        ("b", _bgv_batch_rank), ("c", _big_limb_rank),
        ("d", _four_step_rank), ("e", _boot_rank))]
    _profiler_warmup(dev)
    res = {"setup_s": time.time() - t0}
    gate.wait()
    for tag, run in runs:
        t0 = time.time()
        res[tag] = run()
        res[tag + "_s"] = time.time() - t0
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def _short(st: dict) -> dict:
    """A rank_op record for printing: nonzero launches only."""
    return {**st, "launches": {k: v for k, v in st["launches"].items() if v}}


class parallel_ranks:
    """Phase 18's ranks, started now: a one-rank NCCL group (18a) and two
    gloo ranks (18b-e) set up while this process goes on, each waiting at
    its gate; `.run(phase4)` opens the gates in turn, checks and prints."""

    def __init__(self):
        import concurrent.futures as cf
        from helib_tpu_torch.parallel.distributed import launch
        mp = torch.multiprocessing.get_context("spawn")
        self.t0 = time.time()
        self.gates = mp.Event(), mp.Event()
        self.pool = cf.ThreadPoolExecutor(2)
        self.a = self.pool.submit(launch, _nccl_rank, 1, self.gates[0])
        self.be = self.pool.submit(launch, _gloo_ranks, RANKS, self.gates[1],
                                   backend="gloo")

    def run(self, phase4: list) -> None:
        try:
            self._run(phase4)
        finally:
            for g in self.gates:
                g.set()
            self.pool.shutdown()

    def _run(self, phase4: list) -> None:
        print(f"parallel: ranks started {time.time() - self.t0:.1f} s ago")
        t0 = time.time()
        self.gates[0].set()
        (a,) = self.a.result()
        if a["stats"]["backend"] != "nccl":
            raise AssertionError(f"phase 18a ran on {a['stats']['backend']}")
        expect_only(a["stats"]["launches"], "conv", "phase 18a")
        for got, want in zip(a["out"], phase4):
            if not torch.equal(got, want):
                raise AssertionError("phase 18a: != phase 4's output")
        print(f"parallel 18a: one NCCL rank, (1, 1) mesh, m={M} batch "
              f"{BATCH}: bit-identical to phase 4 "
              f"({time.time() - t0:.1f} s after its gate); "
              f"{json.dumps(_short(a['stats']))}")
        t0 = time.time()
        self.gates[1].set()
        ranks = self.be.result()
        print(f"parallel 18b-e: {time.time() - t0:.1f} s after the gate "
              f"(setup before it: " + ", ".join(
                  f"rank {r} {res['setup_s']:.1f} s"
                  for r, res in enumerate(ranks)) + ")")
        for got, want in zip(ranks[0]["b"]["out"], phase4):
            if not torch.equal(got, want):
                raise AssertionError("phase 18b: != phase 4's output")
        for r, res in enumerate(ranks):
            print(f"parallel 18b rank {r}: (2, 1) mesh, shard "
                  f"{res['b']['shape']}, {res['b_s']:.1f} s: "
                  f"{json.dumps(_short(res['b']['stats']))}")
        print("parallel 18b: gathered result bit-identical to phase 4")
        c0 = ranks[0]["c"]
        for r, res in enumerate(ranks):
            c = res["c"]
            print(f"parallel 18c rank {r}: (1, 2) mesh, {c['rows']} of "
                  f"{c['L']} rows + {c['S']} special, shard {c['shape']}, "
                  f"setup {c['setup_s']:.1f} s, {res['c_s']:.1f} s")
            for op in ("mult", "rotate"):
                st = c[op]
                print(f"parallel 18c rank {r} {op}: {json.dumps(_short(st))}"
                      f"; device ms / unsharded {st['device_ms'] / c0[op + '_unsharded']['device_ms']:.3f}")
        for op in ("mult", "rotate"):
            print(f"parallel 18c {op} unsharded (rank 0 alone): "
                  f"{json.dumps(c0[op + '_unsharded'])}; bit-identical")
        for r, res in enumerate(ranks):
            d = res["d"]
            for tag in ("ntt_fwd", "ntt_inv", "bluestein_fwd",
                        "bluestein_inv"):
                print(f"parallel 18d rank {r} {tag}: "
                      f"{json.dumps(_short(d[tag]))}")
        d0 = ranks[0]["d"]
        print(f"parallel 18d unsharded (rank 0 alone): K2 n = 65536 "
              f"{json.dumps(d0['ntt_k2'])}; K3 m=31775 fwd "
              f"{json.dumps(d0['bluestein_fwd_k3'])}, inv "
              f"{json.dumps(d0['bluestein_inv_k3'])}")
        print("parallel 18d: ShardedNTT == K2 forward, inverse == input; "
              "sharded Bluestein == K3 path, both directions")
        for r, res in enumerate(ranks):
            e = res["e"]
            print(f"parallel 18e rank {r}: setup {e['setup_s']:.1f} s, "
                  f"unsharded cold run (minting) {e['cold_unsharded_s']:.1f} "
                  f"s, capacity {e['capacity'][0]:.1f} -> "
                  f"{e['capacity'][1]:.1f}, {res['e_s']:.1f} s; warm "
                  f"sharded {json.dumps(_short(e['warm']))}")
        print(f"parallel 18e warm unsharded (rank 0 alone): "
              f"{json.dumps(ranks[0]['e']['warm_unsharded'])}")
        print("parallel 18e: the sharded thin bootstrap decrypts to its "
              "slots, capacity restored, == the unsharded warm run")
        for r, res in enumerate(ranks):
            print(f"parallel: rank {r} peak {res['peak_gb']:.2f} GB")


# ---------------------------------------------------------------------------
# phase 19: the twins of examples/01-10
# ---------------------------------------------------------------------------

def examples_path(card: str) -> None:
    """Each twin in helib_tpu_torch/examples/ loaded through importlib and
    run in this process on the card, its own assertions the check; ms and
    kernel launches per example."""
    import importlib.util
    import io
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "helib_tpu_torch", "examples")
    rows = {}
    for name in sorted(f[:-3] for f in os.listdir(here) if f.endswith(".py")):
        spec = importlib.util.spec_from_file_location(
            f"twin_{name}", os.path.join(here, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            mod.main(device="cuda")
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        launches = {k: v for k, v in read_launches().items() if v}
        last = text.getvalue().strip().splitlines()[-1]
        rows[name] = {"ms": ms, "launches": launches}
        print(f"examples: {name} passed in {ms:.0f} ms, {launches}; "
              f"last line: {last}")
    print(json.dumps({"metric": "torch_cuda_examples_ms", "examples": rows,
                      "card": card}))


def parallel_and_examples(card: str, phase4: list, start: float) -> None:
    """Phases 18 and 19: phase 18's ranks start and set up while phase 19
    runs here, then run their timed parts one group at a time."""
    t0 = time.time()
    ranks = parallel_ranks()
    try:
        examples_path(card)
        print(f"chip_smoke: phase 19 took {time.time() - t0:.1f} s (phase "
              f"18's ranks setting up beside it)")
    finally:
        # phase 18 runs even if phase 19 failed: its ranks wait at the gates
        t0 = time.time()
        ranks.run(phase4)
    print(f"chip_smoke: phase 18 took {time.time() - t0:.1f} s after phase "
          f"19")
    print(f"chip_smoke: {time.time() - start:.1f} s of command time after "
          f"start-up")


def print_graph_rows() -> None:
    """The block of the six paths, each with its CUDA graphs and under
    disable_jit(): launches the host issued a call (a replay is one, each
    copy one), device ms and busy share, host ms (ops/s at batch 16), the
    graphs its cold call captured, the shared pool's bytes."""
    if len(GRAPH_ROWS) != 6:
        raise AssertionError(f"{len(GRAPH_ROWS)} of the six graph rows")
    print("graphs: path: graphs | disable_jit()")
    for row in GRAPH_ROWS:
        g, e = row["graphs"], row["eager"]
        ops = row.get("ops_per_s")
        rate = (f"; ops/s {ops['graphs']:.1f} | {ops['eager']:.1f}"
                if ops else "")
        print(f"graphs: {row['path']}: launches {g['issued']} | "
              f"{e['issued']}; device ms {g['device_ms']:.3f} | "
              f"{e['device_ms']:.3f}; busy {100 * g['busy_share']:.1f} % | "
              f"{100 * e['busy_share']:.1f} %; host ms {g['host_ms']:.3f} | "
              f"{e['host_ms']:.3f}{rate}; captured {row['captures']}; pool "
              f"{row['pool_bytes'] / 2**20:.1f} MiB")
    from helib_tpu_torch import jitutil
    print(f"graphs: {jitutil.captures} captured in all, {jitutil.replays} "
          f"replays")


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


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parallel-only", action="store_true",
                    help="build, phase 4 (its output is 18a-b's reference), "
                         "then phases 18 and 19 alone")
    ap.add_argument("--probes-only", action="store_true",
                    help="build, phase 3, then phase 11 alone")
    opts = ap.parse_args(argv)
    only = opts.parallel_only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from helib_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    set_v2(False)

    start = time.time()
    sources = ("conv", "ntt", "conv_aux", "ntt2", "probes", "embed_max",
               "basis_ext")
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

    embed_row = embed_max_path(dev, card)
    lift_row = basis_ext_path(dev, card)

    if opts.probes_only:
        probe_path(dev, card)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    fn, args, launches, phase4 = main_path(dev)
    captures = fn.captures
    if only:
        del fn, args
        parallel_and_examples(card, phase4, start)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    kernels = {"embed_max": embed_row, "basis_ext": lift_row}
    kernels["conv"] = measure(
        fn, args, launches, "conv",
        "torch_cuda_mult_relin_ops_per_s_m8009_b380_batch16", "bgv", card)
    from helib_tpu_torch.ops.ntt2 import conv2_cuda
    beside(fn, args, "conv", "conv2_k3", lambda *a: conv2_cuda(*a, 3), card)
    kernels["conv2"] = v2_path(
        fn, args, "conv2", "conv", "bgv",
        "torch_cuda_mult_relin_v2_ops_per_s_m8009_b380_batch16", card)
    row = batched_row("BGV m=8009 batch 16", fn, args, captures, card)
    # one replay and its copies (4 in, 2 out): the most the host issues a
    # call
    if not 1 <= row["graphs"]["issued"] <= 1 + len(args) + 2:
        raise AssertionError(f"main path: the host issued "
                             f"{row['graphs']['issued']} launches a call")
    del fn, args
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    fn, args, launches, ctx, sk = ckks_path(dev)
    captures = fn.captures
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
    batched_row("CKKS m=65536 batch 16", fn, args, captures, card)
    del fn, args
    torch.cuda.empty_cache()
    rotation_path(ctx, sk, card)
    del ctx, sk
    torch.cuda.empty_cache()
    ckks_big_path(dev, card)
    torch.cuda.empty_cache()

    kernels["conv_aux"], perop_host, held10 = perop_path(dev, card)
    torch.cuda.empty_cache()
    for row in probe_path(dev, card):
        kernels[row["name"]] = row
    torch.cuda.empty_cache()
    _, held, slots_host = slot_path(dev, card, perop_host)
    t0 = time.time()
    boot_path(*held, card, slots_host)
    print(f"chip_smoke: phase 13 took {time.time() - t0:.1f} s")
    del held
    gc.collect()         # the stage wrappers leave reference cycles
    torch.cuda.empty_cache()
    t0 = time.time()
    tiny_boot_path(dev, card)
    print(f"chip_smoke: phase 14 took {time.time() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    _, held15 = circuits_path(dev, card)
    print(f"chip_smoke: phase 15 took {time.time() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    _, ctx16 = matmul_ckks_path(dev, card)
    print(f"chip_smoke: phase 16 took {time.time() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    if staged_since_start():
        raise AssertionError(f"phases 1-16 ran {staged_since_start()} "
                             f"staged transforms: a kernel size fell off "
                             f"its kernel")
    print("chip_smoke: phases 1-16 ran 0 staged transforms")
    t0 = time.time()
    diag_path(dev, card, held10, held15, ctx16)
    print(f"chip_smoke: phase 17 took {time.time() - t0:.1f} s")
    del held10, held15, ctx16
    gc.collect()
    torch.cuda.empty_cache()
    if sharded_since_start():
        raise AssertionError(f"phases 1-17 ran {sharded_since_start()} "
                             f"sharded transforms")
    print("chip_smoke: phases 1-17 ran 0 sharded transforms")
    parallel_and_examples(card, phase4, start)
    print_graph_rows()
    print(card)
    order = ("conv", "ntt", "conv_aux", "ntt2", "conv2", "p1", "p2",
             "p2_65536", "embed_max", "basis_ext")
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
