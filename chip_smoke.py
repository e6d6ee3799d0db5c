"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ops/csrc (nvcc, sm_90a), timed;
  3. each kernel against its plain torch version on the card, bit for bit;
  4. the main path -- batched BGV mult+relin at m=8009, p=2, bits=380, c=3,
     batch 16 -- through the kernels, held against the same chain with the
     plain convolution and against the port on the host CPU, and an
     encrypt -> multiply -> decrypt oracle;
  5. timing: ops/s of the main path, and each kernel's time per launch on the
     inputs the main path gave it, beside its bound and its plain version.
The last three lines are the card's name and power limit as nvidia-smi
prints them, the kernel table as JSON, and {"ok": true, "device": {...}}.
Imports nothing of JAX or helib_tpu.
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
# main path
# ---------------------------------------------------------------------------

class plain_conv:
    """Context manager routing ops.conv.conv to conv_plain (the reference
    run of the chain; the kernel is not launched inside)."""

    def __enter__(self):
        from helib_tpu_torch.ops import conv as convmod
        self.mod, self.saved = convmod, convmod.conv
        convmod.conv = convmod.conv_plain

    def __exit__(self, *exc):
        self.mod.conv = self.saved


class capture_conv:
    """Context manager recording the arguments of every convolution."""

    def __enter__(self):
        from helib_tpu_torch.ops import conv as convmod
        self.mod, self.saved, self.calls = convmod, convmod.conv, []

        def rec(*args):
            self.calls.append(args)
            return self.saved(*args)
        convmod.conv = rec
        return self

    def __exit__(self, *exc):
        self.mod.conv = self.saved


def main_path(dev):
    from helib_tpu_torch.context import Context
    from helib_tpu_torch.keys import SecKey, SKHandle, reduce_mod_phim
    from helib_tpu_torch.ctxt import Ctxt
    from helib_tpu_torch.pipeline import (make_batched_mult_relin,
                                          make_mult_relin, mult_relin,
                                          fresh_noise)
    from helib_tpu_torch.ops.conv import conv_cuda

    t0 = time.time()
    ctx = Context(m=M, p=P_PLAIN, r=1, bits=BITS, c=C, device=dev)
    sk = SecKey(ctx, seed=SEED)
    fn, args = make_batched_mult_relin(ctx, sk, BATCH)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    print(f"main path: {ctx!r}; setup {setup_s:.1f} s")

    conv_cuda.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    launches = {"conv": conv_cuda.launches}
    print(f"main path: one batched call launched {launches}")
    if launches["conv"] == 0:
        raise AssertionError("main path did not launch the conv kernel")
    for o in out:
        if o.shape != (BATCH, ctx.L, ctx.n_eval) or o.dtype != torch.int32:
            raise AssertionError(f"bad output {o.shape} {o.dtype}")
        q = torch.from_numpy(ctx.qs.astype(np.int64)).to(dev)[:, None]
        if bool(((o < 0) | (o.long() >= q)).any()):
            raise AssertionError("output residues out of range")

    # the same chain on batch element 0 with the plain convolution
    pk = sk.pubkey
    with plain_conv():
        before = conv_cuda.launches
        ref = mult_relin(ctx, pk, sk, fresh_noise(ctx, pk), ctx.L,
                         *[a[0] for a in args])
        torch.cuda.synchronize()
        if conv_cuda.launches != before:
            raise AssertionError("reference run launched the kernel")
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


def timing(fn, args):
    def chain(n):
        o0, o1 = fn(*args)
        for _ in range(n - 1):
            o0, o1 = fn(o0, o1, args[2], args[3])
        torch.cuda.synchronize()

    chain(3)
    iters = 10
    t0 = time.time()
    chain(iters)
    dt = time.time() - t0
    return BATCH * iters / dt, dt / iters / BATCH * 1e3


def profile(fn, args, top: int = 10):
    """Device time of one main-path call by kernel name (torch.profiler),
    and the call's wall time: the share of the call the device is busy."""
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
    print(f"profile: one call {wall * 1e3:.3f} ms wall, device busy "
          f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f} %), "
          f"{sum(r[1] for r in rows)} kernel launches")
    for key, count, ms in rows[:top]:
        print(f"  {ms:9.3f} ms {count:5d}x  {key[:90]}")


def kernel_rows(fn, args, launches):
    """Times each kernel on the inputs the main path gave it."""
    from helib_tpu_torch.ops.conv import conv_cuda, conv_plain
    with capture_conv() as cap:
        fn(*args)
    torch.cuda.synchronize()
    if len(cap.calls) != launches["conv"]:
        raise AssertionError("capture run made another number of convs")
    ms = plain = bb = bo = 0.0
    err = 0
    for x, aux, kh, khsh in cap.calls:
        ms += event_ms(lambda: conv_cuda(x, aux, kh, khsh))
        plain += event_ms(lambda: conv_plain(x, aux, kh, khsh), reps=3)
        diff = (conv_cuda(x, aux, kh, khsh).long()
                - conv_plain(x, aux, kh, khsh).long())
        err = max(err, int(diff.abs().max()))
        b, o = conv_bound_ms(x, kh)
        bb, bo = bb + b, bo + o
    n = len(cap.calls)
    return [{"name": "conv", "route": "cuda",
             "source": "helib_tpu_torch/ops/csrc/conv.cu",
             "replaces": "helib_tpu/ops/pallas_ntt.py:452",
             "launches": launches["conv"], "max_abs_err": err,
             "ms": ms / n, "plain_ms": plain / n,
             "bound_ms": max(bb, bo) / n,
             "bound_by": "bytes" if bb >= bo else "operations",
             "library_ms": None}]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from helib_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")

    t0 = time.time()
    _build.build("conv")
    print(f"build: conv.cu in {time.time() - t0:.1f} s")
    for line in _build.ptxas_log.get("conv", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    rows, err = check_conv(dev)
    print(f"kernels: conv == conv_plain bit for bit on {rows} rows "
          f"(n = 8 .. 32768, max |err| = {err})")

    fn, args, launches = main_path(dev)
    ops_s, ms_op = timing(fn, args)
    profile(fn, args)
    kernels = kernel_rows(fn, args, launches)
    k1 = kernels[0]
    print(json.dumps({
        "metric": "torch_cuda_mult_relin_ops_per_s_m8009_b380_batch16",
        "ops_per_s": ops_s, "ms_per_op": ms_op,
        "k1_ms_per_launch": k1["ms"], "k1_launches_per_call": k1["launches"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
