"""The v2 (block-list) schedule of the power-of-2 NTT and of the Bluestein
convolution: K4 and K5.

Ports of helib_tpu/ops/pallas_ntt2.py::pallas_ntt2 (K4, kernel
`_ntt2_kernel`, wrapper `apply_ntt2`) and ::pallas_conv2 (K5, kernel
`_conv2_kernel`, wrapper `apply_conv2`).  They compute what K2 (ntt_fused)
and K1 (conv) compute, bit for bit; what they add is the schedule.  The
log2(n) radix-2 stages are cut into composites (s0, k) -- stages
[s0, s0 + k) -- and a composite runs on 2^s0 blocks of 2^k sub-blocks of
L = n / 2^(s0 + k) words each: the group of word j0 < L of block b is the
2^k words b n / 2^s0 + t L + j0, t < 2^k, and level j < k of the composite
(global stage s0 + j) pairs t with t + 2^(k-1-j) under the twiddle
w[2^(s0+j) + b 2^j + (t >> (k - j))] of the flat table (the TPU's class
`p >> (k - j)`, pallas_ntt2.py:78-94).  The inverse runs the composites in
reverse order with their levels descending (Gentleman-Sande), then
multiplies by n^-1.  The convolution goes from its last forward composite
through the pointwise product by khat into its first inverse composite,
which covers the same stages, without leaving the group
(pallas_ntt2.py:186-202).

Schedule.  The TPU splits the stages into a coarse and a fine phase around
its lane transpose; Hopper has no such transpose, so the port has one phase:
`schedule(log_n, k) = phase_schedule(0, log_n, k)`.  `ntt_v2()` reads
HELIB_NTT_V2 and HELIB_NTT_V2_K at each call, with helib_tpu's names and
meaning (helib_tpu/ops/ntt.py `_ntt_v2`), with one difference: unset or 0
means the whole phase in one composite in helib_tpu, and means `K_MAX`
(the largest composite a CUDA thread holds in registers) here.  A value
above K_MAX raises ValueError.  The schedule changes with k; the output
does not.

Two versions of each function:

  * `ntt2_cuda` / `conv2_cuda` -- the hand-written CUDA kernels
    (csrc/ntt2.cu): K2's and K1's instantiations of the row template
    csrc/ntt_rows.cuh with composites of at most k levels (at k = 3 they
    are K2's and K1's code), the row in shared memory between composites,
    a composite's 2^k words in one thread's registers;
  * `ntt2_plain` / `conv2_plain` -- the same schedule in torch on the block
    list, with the fully reduced ops/modops arithmetic, so they equal
    ntt_fused.ntt_plain and conv.conv_plain bit for bit.

Both read the natural flat tables (Pow2NTT.flat(): stage s at
[2^s, 2^(s+1)), n^-1 at entry 0 of the inverse table); the TPU's
class-deinterleaved, lane-expanded V2Tables are TPU layouts and have no
counterpart.  ntt_fused.ntt and conv.conv launch these in place of K2 and
K1 when `ntt_v2()` is on; K3 (aux-major) never looks at it.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .modops import add_mod, sub_mod, mul_mod_shoup
from .rows import CTA_MAX_LOG_N, launch_ntt, launch_rows

# The largest composite: 2^3 words a thread.  The CUDA kernels are built for
# k = 1 .. K_MAX; on the H100, k = 3 beat k = 4 and 5 on both batched paths
# (PERF.md).
K_MAX = 3


def phase_schedule(start: int, stop: int, max_k: int | None = None):
    """Composites [(s0, k), ...] covering stages [start, stop): with
    max_k=None one composite, else greedy chunks of max_k with the
    remainder first (helib_tpu/ops/pallas_ntt2.py:55-71)."""
    count = stop - start
    if count <= 0:
        return []
    if max_k is None or count <= max_k:
        return [(start, count)]
    rem = count % max_k
    out = [(start, rem)] if rem else []
    s = start + rem
    while s < stop:
        out.append((s, max_k))
        s += max_k
    return out


def schedule(log_n: int, max_k: int) -> list:
    """The port's schedule: all log_n stages as one phase."""
    return phase_schedule(0, log_n, max_k)


def ntt_v2() -> tuple[bool, int]:
    """(enabled, k): HELIB_NTT_V2=1 (or true) enables the v2 kernels,
    HELIB_NTT_V2_K caps the composite size (unset or 0: K_MAX)."""
    if os.environ.get("HELIB_NTT_V2", "") not in ("1", "true"):
        return False, K_MAX
    k = os.environ.get("HELIB_NTT_V2_K", "")
    k = int(k) if k and k != "0" else K_MAX
    if not 1 <= k <= K_MAX:
        raise ValueError(f"HELIB_NTT_V2_K={k}: the v2 kernels hold at most "
                         f"2^{K_MAX} words a thread (1 <= k <= {K_MAX})")
    return True, k


# ---------------------------------------------------------------------------
# plain versions: the schedule on the block list
# ---------------------------------------------------------------------------

def _blocks(x, log_n: int, s0: int, k: int) -> list:
    """x [..., n] -> the 2^k sub-block tensors [..., 2^s0, L] of a
    composite (sub-block t of block b holds words b n/2^s0 + t L + j0)."""
    L = 1 << (log_n - s0 - k)
    return list(x.reshape(*x.shape[:-1], 1 << s0, 1 << k, L).unbind(-2))


def _unblocks(r: list, shape) -> torch.Tensor:
    return torch.stack(r, dim=-2).reshape(shape)


def _levels(r: list, w, wsh, q, s0: int, k: int, inverse: bool, view):
    """The k levels of composite (s0, k) on the block list r, in place;
    w/wsh are flat [T, n] tables, `view` shapes a [T, 2^s0] twiddle slice
    to broadcast against a block, q is already shaped so."""
    b = torch.arange(1 << s0, device=w.device)
    for j in (reversed(range(k)) if inverse else range(k)):
        stride = 1 << (k - 1 - j)
        for t in range(1 << k):
            if t & stride:
                continue
            idx = (1 << (s0 + j)) + (b << j) + (t >> (k - j))
            wv, wsv = view(w[:, idx]), view(wsh[:, idx])
            if inverse:
                a, c = r[t], r[t + stride]
                r[t] = add_mod(a, c, q)
                r[t + stride] = mul_mod_shoup(sub_mod(a, c, q), wv, wsv, q)
            else:
                u = r[t]
                v = mul_mod_shoup(r[t + stride], wv, wsv, q)
                r[t] = add_mod(u, v, q)
                r[t + stride] = sub_mod(u, v, q)
    return r


def _run(x, tw, itw, q, max_k: int, inverse: bool, extra: int,
         khat=None):
    """The v2 schedule on x [..., T, (extra axes), n] with flat tables
    (w, wsh) pairs tw/itw of shape [T, n] and q broadcastable as [T, 1...].
    Forward, inverse (n^-1 included), or with khat (khat, khat_sh) the
    convolution forward -> khat -> inverse fused in the last composite."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    T = tw[0].shape[0] if tw else itw[0].shape[0]
    view = lambda a: a.reshape(T, *([1] * extra), a.shape[-1], 1)  # noqa
    qb = q.reshape(T, *([1] * extra), 1, 1)
    sched = schedule(log_n, max_k)
    fwd = khat is not None or not inverse
    if fwd:
        last = len(sched) - 1
        for c, (s0, k) in enumerate(sched):
            r = _levels(_blocks(x, log_n, s0, k), *tw, qb, s0, k, False,
                        view)
            if khat is not None and c == last:
                kh = [_blocks(a, log_n, s0, k) for a in khat]
                r = [mul_mod_shoup(v, a, b, qb)
                     for v, a, b in zip(r, *kh)]
                r = _levels(r, *itw, qb, s0, k, True, view)
                sched = sched[:-1]
            x = _unblocks(r, x.shape)
        if khat is None:
            return x
    for s0, k in reversed(sched):
        x = _unblocks(_levels(_blocks(x, log_n, s0, k), *itw, qb, s0, k,
                              True, view), x.shape)
    ninv = view(itw[0][:, :1])[..., 0]
    ninv_sh = view(itw[1][:, :1])[..., 0]
    return mul_mod_shoup(x, ninv, ninv_sh, q.reshape(T, *([1] * extra), 1))


def ntt2_plain(x, flat, q, inverse: bool, max_k: int = K_MAX):
    """x [..., P, n]; flat: Pow2NTT.flat() of the P primes, q [P, 1]."""
    if inverse:
        return _run(x, None, (flat["itw_all"], flat["itw_all_sh"]), q,
                    max_k, True, 0)
    return _run(x, (flat["tw_all"], flat["tw_all_sh"]), None, q, max_k,
                False, 0)


def conv2_plain(x, aux, khat, khat_sh, max_k: int = K_MAX):
    """x [..., 3, P, n]; aux: the auxiliary-prime tables with their flat
    [3, n] form (ntt.aux_tree); khat/khat_sh [3, P, n]."""
    return _run(x, (aux["tw_all"], aux["tw_all_sh"]),
                (aux["itw_all"], aux["itw_all_sh"]), aux["q"], max_k, False,
                1, khat=(khat, khat_sh))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _check_k(kernel: str, max_k: int) -> None:
    if not 1 <= max_k <= K_MAX:
        raise ValueError(f"{kernel} kernel: k={max_k} outside 1..{K_MAX}")


def ntt2_cuda(x, flat, q, inverse: bool, max_k: int = K_MAX):
    """K4 on x [..., P, n] (int32, contiguous, on the GPU, n = 8 .. 65536);
    flat: Pow2NTT.flat() of the P primes as device tensors, q [P, 1]."""
    _check_k("ntt2", max_k)
    return launch_ntt("ntt2", x, flat, q, inverse, (ctypes.c_int(max_k),))


def conv2_cuda(x, aux, khat, khat_sh, max_k: int = K_MAX):
    """K5 on x [..., 3, P, n] (int32, contiguous, on the GPU,
    n = 8 .. 32768)."""
    if x.dim() < 3 or x.shape[-3] != 3:
        raise ValueError(f"conv2 kernel: x must be [..., 3, P, n], got "
                         f"{tuple(x.shape)}")
    _check_k("conv2", max_k)
    return launch_rows("ntt2", x, aux, khat, khat_sh, CTA_MAX_LOG_N,
                       entry="launch_conv", extra=(ctypes.c_int(max_k),))
