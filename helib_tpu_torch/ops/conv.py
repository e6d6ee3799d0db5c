"""Fused spectral convolution mod the Bluestein auxiliary primes.

For each row it computes iNTT(NTT(x) * khat) * n^-1 mod the row's auxiliary
prime, fully reduced, on one of two layouts:

  * row-major x [..., 3, P, n] -- port of helib_tpu/ops/pallas_ntt.py::
    pallas_conv (K1, kernel `_conv_kernel`), the B = 16384 transforms;
  * aux-major x [3, ..., P, n] -- port of pallas_conv_shared (K3, kernel
    `_conv_kernel_shared`, wrapper `apply_conv_aux`), every other B.

Each has two versions of one function:

  * `conv_cuda` / `conv_aux_cuda` -- the hand-written CUDA kernels
    (csrc/conv.cu, csrc/conv_aux.cu): one CTA per row with the row in shared
    memory, and for K3 at n = 65536 a cluster of two CTAs per row;
  * `conv_plain` / `conv_aux_plain` -- the staged torch composition
    ntt_pow2_fwd -> Shoup multiply by khat -> ntt_pow2_inv
    (helib_tpu/ops/ntt.py:535-537), the reference each kernel is held to
    bit for bit.

`conv` / `conv_aux` dispatch on where the tensor lies: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_tensors, launch, load
from .modops import mul_mod_shoup
from .ntt import ntt_pow2_fwd, ntt_pow2_inv

MIN_LOG_N = 3    # B = 8 serves the smallest odd m (m = 3)
MAX_LOG_N = 15    # 2^15 words = 128 KB of shared memory, within one CTA
AUX_MAX_LOG_N = 16   # 2^16 words: two CTAs of a cluster, 128 KB each


def conv_plain(x, aux, khat, khat_sh):
    """x [..., 3, P, n]; aux: the auxiliary-prime NTT tables (ntt.aux_tree);
    khat/khat_sh [3, P, n]."""
    A = ntt_pow2_fwd(x, aux)
    Pr = mul_mod_shoup(A, khat, khat_sh, aux["q"])
    return ntt_pow2_inv(Pr, aux)


def conv_cuda(x, aux, khat, khat_sh):
    """The CUDA kernel on x [..., 3, P, n] (int32, contiguous, on the GPU)."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if x.dim() < 3 or x.shape[-3] != 3:
        raise ValueError(f"conv kernel: x must be [..., 3, P, n], got "
                         f"{tuple(x.shape)}")
    P = x.shape[-2]
    if n != 1 << log_n or not MIN_LOG_N <= log_n <= MAX_LOG_N:
        raise ValueError(f"conv kernel: n={n} is not a power of two in "
                         f"[2^{MIN_LOG_N}, 2^{MAX_LOG_N}]")
    tabs = [aux["tw_all"], aux["tw_all_sh"], aux["itw_all"],
            aux["itw_all_sh"]]
    check_tensors("conv", x.device,
                  [("x", x, x.shape), ("khat", khat, (3, P, n)),
                   ("khat_sh", khat_sh, (3, P, n)),
                   ("aux q", aux["q"], (3, 1, 1))]
                  + [("table", t, (3, n)) for t in tabs])
    out = torch.empty_like(x)
    launch("conv", x.device, x, out, ctypes.c_longlong(x.numel() // n),
           ctypes.c_int(log_n), ctypes.c_int(P), *tabs, khat, khat_sh,
           aux["q"])
    conv_cuda.launches += 1
    return out


conv_cuda.launches = 0


def conv(x, aux, khat, khat_sh):
    """The convolution on x's device: the CUDA kernel for a CUDA tensor, the
    plain torch version for a CPU tensor."""
    if x.is_cuda:
        return conv_cuda(x, aux, khat, khat_sh)
    return conv_plain(x, aux, khat, khat_sh)


def conv_aux_plain(x, aux, khat, khat_sh):
    """x [3, ..., P, n] aux-major; the same tables as conv_plain."""
    return conv_plain(x.movedim(0, -3), aux, khat, khat_sh).movedim(-3, 0)


def conv_aux_cuda(x, aux, khat, khat_sh):
    """The K3 CUDA kernel on x [3, ..., P, n] (int32, contiguous, on the
    GPU)."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if x.dim() < 3 or x.shape[0] != 3:
        raise ValueError(f"conv_aux kernel: x must be [3, ..., P, n], got "
                         f"{tuple(x.shape)}")
    P = x.shape[-2]
    if n != 1 << log_n or not MIN_LOG_N <= log_n <= AUX_MAX_LOG_N:
        raise ValueError(f"conv_aux kernel: n={n} is not a power of two in "
                         f"[2^{MIN_LOG_N}, 2^{AUX_MAX_LOG_N}]")
    tabs = [aux["tw_all"], aux["tw_all_sh"], aux["itw_all"],
            aux["itw_all_sh"]]
    check_tensors("conv_aux", x.device,
                  [("x", x, x.shape), ("khat", khat, (3, P, n)),
                   ("khat_sh", khat_sh, (3, P, n)),
                   ("aux q", aux["q"], (3, 1, 1))]
                  + [("table", t, (3, n)) for t in tabs])
    out = torch.empty_like(x)
    launch("conv_aux", x.device, x, out, ctypes.c_longlong(x.numel() // n),
           ctypes.c_int(log_n), ctypes.c_int(P), *tabs, khat, khat_sh,
           aux["q"])
    conv_aux_cuda.launches += 1
    return out


conv_aux_cuda.launches = 0


def conv_aux(x, aux, khat, khat_sh):
    """K3's convolution on x's device: the CUDA kernel for a CUDA tensor,
    the plain torch version for a CPU tensor."""
    if x.is_cuda:
        return conv_aux_cuda(x, aux, khat, khat_sh)
    return conv_aux_plain(x, aux, khat, khat_sh)


def conv_aux_max_clusters(device) -> int:
    """How many 2-CTA clusters of K3's n = 65536 kernel the card holds at
    once (cudaOccupancyMaxActiveClusters); 0 means it cannot launch."""
    lib = load("conv_aux")
    clusters = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.helib_conv_aux_max_clusters(ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError("conv_aux occupancy query failed: "
                           + lib.helib_cuda_error_string(err).decode())
    return clusters.value
