"""The wrappers' side of the row template csrc/ntt_rows.cuh: the checks and
the launch of its C entries, shared by K1 and K3 (conv.py), K2
(ntt_fused.py), K4 and K5 (ntt2.py).

Every entry takes x and out [rows, n] (the flattening of x's leading dims)
and the current stream; a CUDA error raises RuntimeError, a tensor the
kernel does not take raises ValueError before anything launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_tensors, launch

MIN_LOG_N = 3        # B = 8 serves the smallest odd m (m = 3)
CTA_MAX_LOG_N = 15   # 2^15 words = 128 KB of shared memory, within one CTA
MAX_LOG_N = 16       # 2^16 words: a cluster of 4 CTAs a row (ntt_rows.cuh)


def _log2_of(name: str, n: int, max_log_n: int) -> int:
    """log2 n, or ValueError unless n is a power of two in
    [2^MIN_LOG_N, 2^max_log_n]."""
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not MIN_LOG_N <= log_n <= max_log_n:
        raise ValueError(f"{name} kernel: n={n} is not a power of two in "
                         f"[2^{MIN_LOG_N}, 2^{max_log_n}]")
    return log_n


def _aligned(name: str, x) -> None:
    # a thread moves its last composite's consecutive words as 16-byte
    # vectors (composite.cuh GlobalIO)
    if x.data_ptr() % 16:
        raise ValueError(f"{name} kernel: x must start on a 16-byte "
                         f"boundary")


def launch_rows(name: str, x, aux, khat, khat_sh, max_log_n: int,
                entry: str = "launch", extra: tuple = ()):
    """The convolution: checks the tensors and launches
    helib_<name>_<entry> of csrc/<name>.cu on x [..., n] (int32,
    contiguous, on the GPU), `extra` ctypes scalars after the tables;
    returns the output.  The layout check is the caller's."""
    n, P = x.shape[-1], x.shape[-2]
    log_n = _log2_of(name, n, max_log_n)
    tabs = [aux["tw_all"], aux["tw_all_sh"], aux["itw_all"],
            aux["itw_all_sh"]]
    check_tensors(name, x.device,
                  [("x", x, x.shape), ("khat", khat, (3, P, n)),
                   ("khat_sh", khat_sh, (3, P, n)),
                   ("aux q", aux["q"], (3, 1, 1))]
                  + [("table", t, (3, n)) for t in tabs])
    _aligned(name, x)
    out = torch.empty_like(x)
    launch(name, x.device, x, out, ctypes.c_longlong(x.numel() // n),
           ctypes.c_int(log_n), ctypes.c_int(P), *tabs, khat, khat_sh,
           aux["q"], *extra, entry=entry)
    return out


def launch_ntt(name: str, x, flat, q, inverse: bool, extra: tuple = ()):
    """The forward or inverse power-of-2 NTT: checks the tensors and
    launches helib_<name>_launch of csrc/<name>.cu on x [..., P, n] (int32,
    contiguous, on the GPU); flat: Pow2NTT.flat() of the P primes as device
    tensors, q [P, 1], `extra` ctypes scalars after `inverse`.  Returns the
    output."""
    if x.dim() < 2:
        raise ValueError(f"{name} kernel: x must be [..., P, n], got "
                         f"{tuple(x.shape)}")
    n, P = x.shape[-1], x.shape[-2]
    log_n = _log2_of(name, n, MAX_LOG_N)
    keys = ("itw_all", "itw_all_sh") if inverse else ("tw_all", "tw_all_sh")
    tabs = [flat[k] for k in keys]
    check_tensors(name, x.device,
                  [("x", x, x.shape), ("q", q, (P, 1))]
                  + [(k, t, (P, n)) for k, t in zip(keys, tabs)])
    _aligned(name, x)
    out = torch.empty_like(x)
    launch(name, x.device, x, out, ctypes.c_longlong(x.numel() // n),
           ctypes.c_int(log_n), ctypes.c_int(P), *tabs, q,
           ctypes.c_int(int(inverse)), *extra)
    return out

