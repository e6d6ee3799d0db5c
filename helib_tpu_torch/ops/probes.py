"""Cost probes of the port's kernels: P1 and P2.

Ports of the TPU probes benchmarks/kernel_parts.py::run (P1, kernel
`kern_mul`) and benchmarks/kernel_phases.py::make (P2, inner `kern`).  They
lie on no path: they answer whether K1-K5 (the row template
csrc/ntt_rows.cuh) are bound by their 32-bit multiplies, by their trips
through shared memory, or by the barriers and the cluster's traffic between
their composites.  csrc/probes.cu has the kernels, what each variant does
and what bounds it on the H100; every variant here has its plain torch
version, which the kernel equals bit for bit:

  P1 (`p1_cuda` / `p1_plain`), rows x [R, N] with per-row twiddles w, wsh
     [T, N] and primes q [T, 1] (row r on row r % T), one application a
     launch: mul, bfly, stage, stage_r, stage_c, stage_c64, stage_w.  Every
     variant is register-local on Hopper: a thread holds closed orbits of
     the row (a word, a pair, or the 8 words of stage_r's and stage_w's
     3-bit rotation) for all 28 rounds, no shared memory.  `stage` and
     `stage_c` differ only in the TPU's relayout; here they are one kernel
     instantiation.  2^3 <= N <= 2^15 (the staged variants from
     2^(log2 m + 3)).
  P2 (`p2_cuda` / `p2_plain`), rows x [R, n], row r on prime r % T of the
     flat tables tw, tw_sh [T, n] and q [T, 1] (T = 3: the aux primes):
     memory, coarse, fine -- K1's own pieces, built from the template's
     helpers: register composites, one barrier each, at n = 65536 K3's
     4-CTA cluster with coarse's first two stages through distributed
     shared memory.  2^7 <= n <= 2^16.

Every output is fully reduced; the TPU probes reduce lazily (P1 ends in the
same residues, P2 is congruent mod q).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_tensors, launch
from .modops import add_mod, sub_mod, mul_mod_shoup

P1_VARIANTS = ("mul", "bfly", "stage", "stage_r", "stage_c", "stage_c64",
               "stage_w")
P2_PHASES = ("memory", "coarse", "fine")
ROUNDS = 28      # kernel_parts.py STAGES
MULS = 14        # the Shoup products of the `mul` variant
FINE = 7         # the fine phase's stages (kernel_phases.py: log2 n - 7)
P1_MAX_LOG_N = 15    # kernel_parts.py runs N = 2^14
P2_MAX_LOG_N = 16    # n = 65536: a 4-CTA cluster a row, as K3


def p1_blocks(variant: str) -> int:
    """m, the number of blocks of a staged variant."""
    return 64 if variant == "stage_c64" else 4


def p1_plain(variant: str, x, w, wsh, q):
    """One application of P1 `variant` on x [R, N]."""
    R, n = x.shape
    h = n // 2
    if variant == "mul":
        for _ in range(MULS):
            x = mul_mod_shoup(x, w, wsh, q)
        return x
    if variant == "bfly":
        for _ in range(ROUNDS):
            u, t = x[:, :h], mul_mod_shoup(x[:, h:], w[:, :h], wsh[:, :h], q)
            x = torch.cat([add_mod(u, t, q), sub_mod(u, t, q)], dim=1)
        return x
    m = p1_blocks(variant)
    half = n // (2 * m)
    if variant == "stage_w":
        for _ in range(ROUNDS):
            u = x[:, :h].reshape(R, m, half)
            t = mul_mod_shoup(x[:, h:], w[:, :h], wsh[:, :h], q)
            x = torch.stack([u, t.reshape(R, m, half)], dim=2).reshape(R, n)
        return x
    if variant not in ("stage", "stage_c", "stage_c64", "stage_r"):
        raise ValueError(f"unknown P1 variant {variant!r}")
    q3 = q[:, :, None]
    wm, wshm = w[:, :m, None], wsh[:, :m, None]
    for _ in range(ROUNDS):
        xr = x.reshape(R, m, 2, half)
        t = mul_mod_shoup(xr[:, :, 1], wm, wshm, q3)
        a, b = add_mod(xr[:, :, 0], t, q3), sub_mod(xr[:, :, 0], t, q3)
        if variant == "stage_r":
            x = torch.cat([a.reshape(R, h), b.reshape(R, h)], dim=1)
        else:
            x = torch.stack([a, b], dim=2).reshape(R, n)
    return x


def p2_range(phase: str, log_n: int) -> tuple[int, int]:
    """The stages [lo, hi) a P2 phase runs each way."""
    if phase == "coarse":
        return 0, log_n - FINE
    if phase == "fine":
        return log_n - FINE, log_n
    if phase == "memory":
        return 0, 0
    raise ValueError(f"unknown P2 phase {phase!r}")


def p2_plain(phase: str, x, tw, tw_sh, q):
    """One application of P2 `phase` on x [R, n]: stages [lo, hi) forward,
    then their Gentleman-Sande butterflies with the same forward tables."""
    R, n = x.shape
    lo, hi = p2_range(phase, n.bit_length() - 1)
    rows = torch.arange(R, device=x.device) % tw.shape[0]
    w, wsh, qr = tw[rows], tw_sh[rows], q.reshape(-1, 1)[rows]
    q3 = qr[:, :, None]
    for s in range(lo, hi):
        m = 1 << s
        xr = x.reshape(R, m, 2, n // (2 * m))
        t = mul_mod_shoup(xr[:, :, 1], w[:, m:2 * m, None],
                          wsh[:, m:2 * m, None], q3)
        x = torch.stack([add_mod(xr[:, :, 0], t, q3),
                         sub_mod(xr[:, :, 0], t, q3)], dim=2).reshape(R, n)
    for s in reversed(range(lo, hi)):
        m = 1 << s
        xr = x.reshape(R, m, 2, n // (2 * m))
        a, b = xr[:, :, 0], xr[:, :, 1]
        v = mul_mod_shoup(sub_mod(a, b, q3), w[:, m:2 * m, None],
                          wsh[:, m:2 * m, None], q3)
        x = torch.stack([add_mod(a, b, q3), v], dim=2).reshape(R, n)
    return x.clone() if phase == "memory" else x


def _launch(probe: int, code: int, lo: int, hi: int, x, w, wsh, q):
    R, n = x.shape
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not lo <= log_n <= hi:
        raise ValueError(f"P{probe} kernel: n={n} is not a power of two in "
                         f"[2^{lo}, 2^{hi}]")
    T = w.shape[0]
    check_tensors(f"P{probe}", x.device,
                  [("x", x, (R, n)), ("w", w, (T, n)), ("wsh", wsh, (T, n)),
                   ("q", q, (T, 1))])
    # 16-byte vectors: x and out, and P1's twiddles
    for name, t in [("x", x)] + ([("w", w), ("wsh", wsh)] if probe == 1
                                 else []):
        if t.data_ptr() % 16:
            raise ValueError(f"P{probe} kernel: {name} must start on a "
                             f"16-byte boundary")
    out = torch.empty_like(x)
    launch("probes", x.device, ctypes.c_int(probe), ctypes.c_int(code), x,
           out, ctypes.c_longlong(R), ctypes.c_int(log_n), w, wsh, q,
           ctypes.c_int(T))
    return out


def p1_cuda(variant: str, x, w, wsh, q):
    """P1 `variant` on the GPU: x [R, N], w, wsh [T, N], q [T, 1] (int32,
    contiguous, x, w and wsh on 16-byte boundaries)."""
    if variant not in P1_VARIANTS:
        raise ValueError(f"unknown P1 variant {variant!r}")
    log_m = p1_blocks(variant).bit_length() - 1
    lo = log_m + 3 if variant.startswith("stage") else 3
    out = _launch(1, P1_VARIANTS.index(variant), lo, P1_MAX_LOG_N, x, w,
                  wsh, q)
    p1_cuda.launches += 1
    return out


p1_cuda.launches = 0


def p2_cuda(phase: str, x, tw, tw_sh, q):
    """P2 `phase` on the GPU: x [R, n], tables [T, n], q [T, 1]."""
    if phase not in P2_PHASES:
        raise ValueError(f"unknown P2 phase {phase!r}")
    out = _launch(2, P2_PHASES.index(phase), FINE, P2_MAX_LOG_N, x, tw, tw_sh,
                  q)
    p2_cuda.launches += 1
    return out


p2_cuda.launches = 0

