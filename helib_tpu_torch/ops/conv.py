"""Fused spectral convolution mod the Bluestein auxiliary primes.

Port of helib_tpu/ops/pallas_ntt.py::pallas_conv (K1, kernel `_conv_kernel`):
for each row of x [..., 3, P, n] it computes iNTT(NTT(x) * khat) * n^-1 mod
the row's auxiliary prime, fully reduced.  Two versions of one function:

  * `conv_cuda`  -- the hand-written CUDA kernel (csrc/conv.cu), one CTA per
                    row with the row in shared memory;
  * `conv_plain` -- the staged torch composition ntt_pow2_fwd -> Shoup
                    multiply by khat -> ntt_pow2_inv (helib_tpu/ops/ntt.py:
                    535-537), the reference the kernel is held to bit for bit.

`conv` dispatches on where the tensor lies: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version.  There is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .modops import mul_mod_shoup
from .ntt import ntt_pow2_fwd, ntt_pow2_inv

MIN_LOG_N = 3    # B = 8 serves the smallest odd m (m = 3)
MAX_LOG_N = 15    # 2^15 words = 128 KB of shared memory, within one CTA


def conv_plain(x, aux, khat, khat_sh):
    """x [..., 3, P, n]; aux: the auxiliary-prime NTT tables (ntt.aux_tree);
    khat/khat_sh [3, P, n]."""
    A = ntt_pow2_fwd(x, aux)
    Pr = mul_mod_shoup(A, khat, khat_sh, aux["q"])
    return ntt_pow2_inv(Pr, aux)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _lib():
    from ._build import load
    lib = load("conv")
    if not getattr(lib, "_typed", False):
        lib.helib_conv_launch.restype = ctypes.c_int
        lib.helib_conv_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8)
        lib.helib_cuda_error_string.restype = ctypes.c_char_p
        lib.helib_cuda_error_string.argtypes = [ctypes.c_int]
        lib._typed = True
    return lib


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
    for name, t, shape in ([("x", x, tuple(x.shape)),
                            ("khat", khat, (3, P, n)),
                            ("khat_sh", khat_sh, (3, P, n)),
                            ("aux q", aux["q"], (3, 1, 1))]
                           + [("table", t, (3, n)) for t in tabs]):
        if (not t.is_cuda or t.device != x.device or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"conv kernel: {name} must be a contiguous int32 "
                             f"CUDA tensor of shape {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.helib_conv_launch(
            _ptr(x), _ptr(out), x.numel() // n, log_n, P,
            *[_ptr(t) for t in tabs], _ptr(khat), _ptr(khat_sh),
            _ptr(aux["q"]), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("conv kernel launch failed: "
                           + lib.helib_cuda_error_string(err).decode())
    conv_cuda.launches += 1
    return out


conv_cuda.launches = 0


def conv(x, aux, khat, khat_sh):
    """The convolution on x's device: the CUDA kernel for a CUDA tensor, the
    plain torch version for a CPU tensor."""
    if x.is_cuda:
        return conv_cuda(x, aux, khat, khat_sh)
    return conv_plain(x, aux, khat, khat_sh)
