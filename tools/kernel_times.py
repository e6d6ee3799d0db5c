"""Times each of the port's kernels alone on the card: the rows of PERF.md's
kernel table.

    python3 tools/kernel_times.py [--rows K1,P2,...] [--build] [--root DIR]

Each row runs one kernel on seeded inputs of the shapes its row names (a
kernel's work does not depend on the values): K1, K3 and K2 on the
transforms of one relinearized product of their benchmark configuration
(hebench/counts.py `transforms`), K4 and K5 at k = 3 on K2's and K1's
inputs, basis_ext on the three lifts of the main path, embed_max on two rows
at m = 8009 and 32003, the probes P1 and P2 at the TPU probes' shapes.
Every output is held to the kernel's plain version, bit for bit (embed_max,
a float64 transform, to 1e-12 relative), a call must count one launch in
the port's launch counts (its C entry is printed), then the kernel is timed
by CUDA events over launches queued behind a sleep kernel (the probes: the
median of 5 chains) and printed as ms a launch beside its bound -- the
larger of the bytes it moves at the card's bandwidth and its multiplies at
the card's 32-bit multiply rate (K1-K5: hebench/counts.py `conv_bound_ms`
and `ntt_bound_ms`) -- and the plain version's ms on the card.

`--rows` keeps the rows whose name starts with one of the given prefixes.
`--build` compiles every source afresh (into build/kernel_times/) and adds
each kernel's registers, stack frame and spills from nvcc's ptxas report.
`--root DIR` imports helib_tpu_torch from another checkout (built under
DIR/build/), so two trees can be timed in one run.  Prints one line of
human-readable text a row on stderr and one JSON line on stdout: the card's
name and power limit (nvidia-smi), the rows and, with --build, the report.
Imports nothing of JAX or helib_tpu.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_counts():
    """hebench/counts.py of this checkout (the bounds and the transforms of
    a configuration), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "hebench_counts", os.path.join(HERE, "hebench", "counts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


counts = _load_counts()
# float64 outside the tensor cores (NVIDIA H100 SXM data sheet, 700 W)
FP64_FLOP_PER_S = 34e12
# ~50 ms of the card's clock: while a sleep kernel holds the device, the
# host queues the timed launches, so launches shorter than their Python
# launch cost are timed on the device, not at the host's launch rate
HOLD_CYCLES = 100_000_000
# the benchmark configurations of the transform rows, and CKKS at m=131072
# (n = 65536: K2 on 4-CTA clusters) unbatched
CONFIGS = {name: json.load(open(os.path.join(HERE, "hebench", "configs",
                                             name + ".json")))
           for name in ("bgv_m8009", "ckks_m65536", "bgv_m32003")}
CKKS_131072 = {**CONFIGS["ckks_m65536"], "m": 131072}
BATCH = 16        # the batched cells' batch
# (label, batch, source rows, target rows, p^r, N, remainder): BGV
# m=32003's digit and special mod-down, CKKS m=65536's batched digit
LIFTS = (("ks m=32003", 1, 65, 259, 0, 32003, False),
         ("mod-down m=32003", 1, 65, 194, 2, 32003, True),
         ("ks CKKS m=65536 b16", 16, 5, 20, 0, 32768, False))
PROBE_ROWS, PROBE_N, P1_CHAIN, P2_CHAIN = 160, 16384, 50, 100


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device ms of fn() over `reps` back-to-back runs queued behind a
    sleep kernel, after `warm` runs."""
    for _ in range(warm):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def median_ms(fn, reps: int = 5) -> float:
    """Median over `reps` runs of fn()'s device ms, each run queued behind
    a sleep kernel, after one warm run."""
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


def _ms(bytes_, ops, rate) -> tuple[float, float]:
    return (bytes_ / counts.HBM_BYTES_PER_S * 1e3, ops / rate * 1e3)


def once(fn):
    """(fn(), the C entry it launched): fn must count exactly one launch
    in the port's launch counts (None for a checkout that keeps none)."""
    from helib_tpu_torch.ops import _build
    counted = getattr(_build, "launch_counts", None)
    before = None if counted is None else counted.copy()
    out = fn()
    torch.cuda.synchronize()
    if counted is None:
        return out, None
    launched = counted - before
    if sum(launched.values()) != 1:
        raise AssertionError(f"one call launched {dict(launched)}")
    return out, next(iter(launched))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def conv_inputs(n: int, P: int, lead: tuple, seed: int, dev):
    """x [*lead, 3, P, n] and khat/khat_sh [3, P, n] below the auxiliary
    primes, with the auxiliary tables of size n."""
    from helib_tpu_torch.ops.modops import shoup, to_device
    from helib_tpu_torch.ops.ntt import aux_primes, aux_tree
    raux = aux_primes().astype(np.int64)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, raux[:, None, None], lead + (3, P, n))
    kh = rng.integers(0, raux[:, None, None], (3, P, n)).astype(np.uint32)
    khsh = shoup(kh, raux[:, None, None].astype(np.uint64))
    return (to_device(x.astype(np.uint32), dev), aux_tree(n, dev)["aux"],
            to_device(kh, dev), to_device(khsh, dev))


def ntt_inputs(n: int, P: int, lead: tuple, seed: int, dev):
    """x [*lead, P, n] below P negacyclic primes of size n, and their
    tables (stage and flat forms)."""
    from helib_tpu_torch.nt.primegen import gen_primes
    from helib_tpu_torch.ops.modops import to_device
    from helib_tpu_torch.ops.ntt import Pow2NTT
    qs = np.array(gen_primes(2 * n, P), dtype=np.uint32)
    tab = Pow2NTT(qs, n, negacyclic=True)
    t = {**tab.tree(dev),
         "flat": {k: to_device(v, dev) for k, v in tab.flat().items()}}
    rng = np.random.default_rng(seed)
    x = rng.integers(0, qs[:, None].astype(np.int64), lead + (P, n))
    return to_device(x.astype(np.uint32), dev), t


def _bluestein_B(m: int) -> int:
    return 1 << math.ceil(math.log2(2 * m - 1))


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def transform_row(name, cfg, batch, kernel, dev):
    """A transform kernel on the transforms of one relinearized product of
    cfg at `batch` ciphertexts (no batch dimension at batch None): mean ms
    a launch, plain ms and bound over them."""
    m = cfg["m"]
    ms = plain_ms = bb = bo = 0.0
    plan = counts.transforms(cfg)
    for i, (inverse, rows) in enumerate(plan):
        lead = () if batch is None else (batch,)
        if m % 2:
            B = _bluestein_B(m)
            args = conv_inputs(B, rows, lead, seed=i, dev=dev)
            if kernel == "conv_aux":          # aux-major [3, ..., P, B]
                args = (args[0].movedim(len(lead), 0).contiguous(),
                        *args[1:])
            b, o = counts.conv_bound_ms(args[0].shape, args[2].shape)
        else:
            x, t = ntt_inputs(m // 2, rows, lead, seed=i, dev=dev)
            args = (x, t, inverse)
            b, o = counts.ntt_bound_ms(x.shape, inverse)
        run, ref = _pair(kernel)
        (got, entry), want = once(lambda: run(*args)), ref(*args)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain on "
                                 f"{tuple(args[0].shape)}")
        ms += event_ms(lambda: run(*args))
        plain_ms += event_ms(lambda: ref(*args), reps=3, warm=1)
        bb, bo = bb + b, bo + o
    n = len(plan)
    return _row(name, ms / n, plain_ms / n, bb / n, bo / n, entry=entry,
                transforms=[[inv, rows] for inv, rows in plan],
                shape=list(args[0].shape))


def _pair(kernel: str):
    """(the kernel, the plain version it is held to and timed beside) of a
    transform row, on (x, aux, khat, khat_sh) or (x, t, inverse); K4 and K5
    at k = 3."""
    from helib_tpu_torch.ops import conv, ntt2, ntt_fused

    def flat(f, *k):
        return lambda x, t, inv: f(x, t["flat"], t["q"], inv, *k)
    return {
        "conv": (conv.conv_cuda, conv.conv_plain),
        "conv_aux": (conv.conv_aux_cuda, conv.conv_aux_plain),
        "conv2": (lambda *a: ntt2.conv2_cuda(*a, 3),
                  lambda *a: ntt2.conv2_plain(*a, 3)),
        "ntt": (flat(ntt_fused.ntt_cuda), ntt_fused.ntt_plain),
        "ntt2": (flat(ntt2.ntt2_cuda, 3), flat(ntt2.ntt2_plain, 3))}[kernel]


def _row(name, ms, plain_ms, bytes_ms, ops_ms, **extra) -> dict:
    return {"name": name, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "multiplies",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, **extra}


def basis_ext_rows(dev) -> list:
    from helib_tpu_torch.nt.primegen import gen_primes
    from helib_tpu_torch.ops import basis_ext as be
    from helib_tpu_torch.ops.modops import to_device
    rows = []
    for i, (label, batch, kd, T, pr, n, frac) in enumerate(LIFTS):
        primes = gen_primes(2, kd + T)
        d, t = primes[:kd], primes[kd:] + ([pr] if pr > 1 else [])
        rng = np.random.default_rng(i + 1)
        x = to_device(rng.integers(0, np.array(d, dtype=np.int64)[:, None],
                                   (batch, kd, n)).astype(np.uint32), dev)
        tab = be.basis_ext_tables(d, t, dev)
        (got, gfrac), entry = once(lambda: be.basis_ext_cuda(x, tab, frac))
        want, wfrac = be.basis_ext_plain(x, tab, frac)
        if not torch.equal(got, want) or (frac and not torch.equal(gfrac,
                                                                   wfrac)):
            raise AssertionError(f"basis_ext {label}: kernel != plain")
        # x read and the output (and the remainder) written once; kd
        # multiply-adds an output residue, each 32x32->64 two multiplies
        Tt = len(t)
        b, o = _ms(batch * n * (4 * kd + 4 * Tt + (8 if frac else 0)),
                   2 * batch * kd * Tt * n, counts.INT32_MUL_PER_S)
        rows.append(_row(
            f"basis_ext {label}",
            event_ms(lambda: be.basis_ext_cuda(x, tab, frac), reps=50),
            event_ms(lambda: be.basis_ext_plain(x, tab, frac), reps=3,
                     warm=1), b, o, entry=entry, shape=[batch, kd, Tt, n]))
    return rows


def embed_max_rows(dev) -> list:
    from helib_tpu_torch.ops.embed_max import (embed_max_cuda,
                                               embed_max_plain, embed_tables)
    rows = []
    for m in (8009, 32003):
        rng = np.random.default_rng(m + 1)
        x = torch.from_numpy((rng.random((2, m)) - 0.5).astype(
            np.float32)).to(dev)
        tab = embed_tables(m, m, dev)
        (got, entry), want = (once(lambda: embed_max_cuda(x, tab)),
                              embed_max_plain(x, tab))
        if not torch.allclose(got, want, rtol=1e-12, atol=0.0):
            raise AssertionError(f"embed_max m={m}: kernel != plain")
        # the rows and tables read once and the maxima written; a row two
        # complex FFTs of L points, the chirp, twiddle and bhat products
        # and the magnitudes
        R, L, log_l = 2, 1 << tab["log_l"], tab["log_l"]
        b, o = _ms(4 * R * m + 16 * (m + 2 * L) + m + 8 * R,
                   R * (10 * L * log_l + 2 * m + 18 * L + 3 * m),
                   FP64_FLOP_PER_S)
        rows.append(_row(
            f"embed_max m={m}",
            event_ms(lambda: embed_max_cuda(x, tab), reps=100),
            event_ms(lambda: embed_max_plain(x, tab), reps=20), b, o,
            entry=entry, shape=[R, m]))
    return rows


def probe_rows(dev) -> list:
    """P1's variants on [160, 16384], 50 chained, and P2's phases on
    [160, n] at n = 16384 and 65536, 100 chained: each chain held to its
    plain version, the median of 5 chains over the chain's length."""
    from helib_tpu_torch.ops import probes
    from helib_tpu_torch.ops.modops import shoup, to_device
    from helib_tpu_torch.ops.ntt import aux_primes, aux_tree
    R = PROBE_ROWS
    qrow = aux_primes()[np.arange(R) % 3].astype(np.uint32)
    rng = np.random.default_rng(0)

    def rows_of(n):
        return to_device(rng.integers(0, qrow[:, None].astype(np.int64),
                                      (R, n)).astype(np.uint32), dev)
    x = rows_of(PROBE_N)
    w = rng.integers(1, qrow[:, None].astype(np.int64), (R, PROBE_N))
    wsh = shoup(w.astype(np.uint32), qrow[:, None].astype(np.uint64))
    p1_args = tuple(to_device(a.astype(np.uint32), dev)
                    for a in (w, wsh, qrow[:, None]))
    cases = [(f"P1 {v}", probes.p1_cuda, probes.p1_plain, v, x, p1_args,
              P1_CHAIN, "p1") for v in probes.P1_VARIANTS]
    for n in (PROBE_N, 65536):
        aux = aux_tree(n, dev)["aux"]
        tabs = (aux["tw_all"], aux["tw_all_sh"], aux["q"].reshape(3, 1))
        xn = x if n == PROBE_N else rows_of(n)
        cases += [(f"P2 {ph} n={n}", probes.p2_cuda, probes.p2_plain, ph,
                   xn, tabs, P2_CHAIN, "p2") for ph in probes.P2_PHASES]

    def chain(f, v, x, args, count):
        for _ in range(count):
            x = f(v, x, *args)
        return x
    out = []
    for name, kern, plain, v, xv, args, count, kind in cases:
        entry = once(lambda: kern(v, xv, *args))[1]
        for c in (1, 3):
            if not torch.equal(chain(kern, v, xv, args, c),
                               chain(plain, v, xv, args, c)):
                raise AssertionError(f"{name}: {c} application(s) != "
                                     f"plain")
        n = xv.shape[1]
        b, o = probe_bound_ms(kind, v, R, n)
        out.append(_row(
            name, median_ms(lambda: chain(kern, v, xv, args, count))
            / count, event_ms(lambda: plain(v, xv, *args), reps=2, warm=1),
            b, o, entry=entry, shape=[R, n]))
    return out


def probe_bound_ms(kind: str, variant: str, R: int, n: int):
    """(bytes, multiplies) bound in ms of one probe application: x read and
    out written once, the twiddles the variant reads once; 3 32-bit
    multiplies a Shoup product.  P2's coarse phase at n = 65536 moves 3/4
    of each row between the CTAs of its cluster as well: on-chip traffic,
    not counted here."""
    from helib_tpu_torch.ops import probes
    words, h = R * n, n // 2
    if kind == "p1":
        if variant == "mul":
            tab, muls = 2 * words, probes.MULS * words
        else:
            used = (h if variant in ("bfly", "stage_w")
                    else probes.p1_blocks(variant))
            tab, muls = 2 * R * used, probes.ROUNDS * R * h
        nbytes = 4 * (2 * words + tab + R)
    else:
        lo, hi = probes.p2_range(variant, n.bit_length() - 1)
        nbytes = 4 * (2 * words + 2 * 3 * ((1 << hi) - (1 << lo)) + 3)
        muls = 2 * (hi - lo) * R * h
    return _ms(nbytes, 3 * muls, counts.INT32_MUL_PER_S)


ROWS = {
    "K1": lambda dev: [transform_row(
        "K1 conv, BGV m=8009 b16", CONFIGS["bgv_m8009"], BATCH, "conv",
        dev)],
    "K2": lambda dev: [transform_row(
        "K2 ntt n=32768, CKKS m=65536 b16", CONFIGS["ckks_m65536"], BATCH,
        "ntt", dev), transform_row(
        "K2 ntt n=65536, CKKS m=131072 b1", CKKS_131072, None, "ntt", dev)],
    "K3": lambda dev: [transform_row(
        "K3 conv_aux, BGV m=32003 b1", CONFIGS["bgv_m32003"], None,
        "conv_aux", dev)],
    "K4": lambda dev: [transform_row(
        "K4 ntt2 k=3, CKKS m=65536 b16", CONFIGS["ckks_m65536"], BATCH,
        "ntt2", dev)],
    "K5": lambda dev: [transform_row(
        "K5 conv2 k=3, BGV m=8009 b16", CONFIGS["bgv_m8009"], BATCH,
        "conv2", dev)],
    "basis_ext": basis_ext_rows,
    "embed_max": embed_max_rows,
    "P": probe_rows,
}


def ptxas_summary(log: str) -> list:
    """One line a kernel of nvcc's -Xptxas -v report: its entry name,
    registers, stack frame and spills."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"name": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["frame"], cur["spill_st"], cur["spill_ld"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="",
                    help="comma-separated prefixes of the rows to run "
                         "(default: every row)")
    ap.add_argument("--build", action="store_true",
                    help="compile afresh and report registers and spills")
    ap.add_argument("--root", default=HERE)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    from helib_tpu_torch.ops import _build
    if not _build.__file__.startswith(root):
        raise SystemExit(f"imported {_build.__file__}, not {root}'s")
    dev = torch.device("cuda")
    out = {"card": card_line(), "root": root}
    if opts.build:
        _build.BUILD_DIR = os.path.join(root, "build", "kernel_times")
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
        sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                         if f.endswith(".cu"))
        _build.build(*sources)
        out["build"] = {s: ptxas_summary(_build.ptxas_log.get(s, ""))
                        for s in sources}
    prefixes = [p for p in opts.rows.split(",") if p]
    out["rows"] = []
    for key, make in ROWS.items():
        if prefixes and not any(p.startswith(key) or key.startswith(p)
                                for p in prefixes):
            continue
        for row in make(dev):
            if prefixes and not any(row["name"].startswith(p)
                                    for p in prefixes):
                continue
            out["rows"].append(row)
            print(f"{row['name']}: {row['ms']:.5f} ms a launch, bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']}), plain "
                  f"{row['plain_ms']:.3f} ms", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
