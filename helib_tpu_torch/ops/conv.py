"""Fused spectral convolution mod the Bluestein auxiliary primes.

For each row it computes iNTT(NTT(x) * khat) * n^-1 mod the row's auxiliary
prime, fully reduced, on one of two layouts:

  * row-major x [..., 3, P, n] -- port of helib_tpu/ops/pallas_ntt.py::
    pallas_conv (K1, kernel `_conv_kernel`), the B = 16384 transforms;
  * aux-major x [3, ..., P, n] -- port of pallas_conv_shared (K3, kernel
    `_conv_kernel_shared`, wrapper `apply_conv_aux`), every other B.

Each has two versions of one function:

  * `conv_cuda` / `conv_aux_cuda` -- the hand-written CUDA kernels
    (csrc/conv.cu, csrc/conv_aux.cu), two instantiations of the device
    template of the NTT family (csrc/ntt_rows.cuh): register composites
    under ops/ntt2.py's schedule, one CTA a row with the row in shared
    memory, and for K3 at n = 65536 a thread-block cluster a row;
  * `conv_plain` / `conv_aux_plain` -- the staged torch composition
    ntt_pow2_fwd -> Shoup multiply by khat -> ntt_pow2_inv
    (helib_tpu/ops/ntt.py:535-537), the reference each kernel is held to
    bit for bit.

`conv` / `conv_aux` dispatch on where the tensor lies: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version.  There is no
fallback from one to the other.  With HELIB_NTT_V2=1 (ops/ntt2.py `ntt_v2`)
`conv` takes K5, K1's function under the block-list schedule: `conv2_cuda`
or `conv2_plain`.  `conv_aux` does not look at it, as helib_tpu's aux-major
branch is taken before v2 is read.
"""

from __future__ import annotations

from .modops import mul_mod_shoup
from .ntt import ntt_pow2_fwd, ntt_pow2_inv
from .ntt2 import ntt_v2, conv2_cuda, conv2_plain
from .rows import CTA_MAX_LOG_N, MAX_LOG_N as AUX_MAX_LOG_N, launch_rows


def conv_plain(x, aux, khat, khat_sh):
    """x [..., 3, P, n]; aux: the auxiliary-prime NTT tables (ntt.aux_tree);
    khat/khat_sh [3, P, n]."""
    A = ntt_pow2_fwd(x, aux)
    Pr = mul_mod_shoup(A, khat, khat_sh, aux["q"])
    return ntt_pow2_inv(Pr, aux)


def conv_cuda(x, aux, khat, khat_sh):
    """K1 on x [..., 3, P, n] (int32, contiguous, on the GPU)."""
    if x.dim() < 3 or x.shape[-3] != 3:
        raise ValueError(f"conv kernel: x must be [..., 3, P, n], got "
                         f"{tuple(x.shape)}")
    return launch_rows("conv", x, aux, khat, khat_sh, CTA_MAX_LOG_N)


def conv(x, aux, khat, khat_sh):
    """The convolution on x's device: the CUDA kernel for a CUDA tensor, the
    plain torch version for a CPU tensor; K5's pair under HELIB_NTT_V2=1."""
    v2, k = ntt_v2()
    if v2:
        if x.is_cuda:
            return conv2_cuda(x, aux, khat, khat_sh, k)
        return conv2_plain(x, aux, khat, khat_sh, k)
    if x.is_cuda:
        return conv_cuda(x, aux, khat, khat_sh)
    return conv_plain(x, aux, khat, khat_sh)


def conv_aux_plain(x, aux, khat, khat_sh):
    """x [3, ..., P, n] aux-major; the same tables as conv_plain."""
    return conv_plain(x.movedim(0, -3), aux, khat, khat_sh).movedim(-3, 0)


def conv_aux_cuda(x, aux, khat, khat_sh):
    """K3 on x [3, ..., P, n] (int32, contiguous, on the GPU)."""
    if x.dim() < 3 or x.shape[0] != 3:
        raise ValueError(f"conv_aux kernel: x must be [3, ..., P, n], got "
                         f"{tuple(x.shape)}")
    return launch_rows("conv_aux", x, aux, khat, khat_sh, AUX_MAX_LOG_N)


def conv_aux(x, aux, khat, khat_sh):
    """K3's convolution on x's device: the CUDA kernel for a CUDA tensor,
    the plain torch version for a CPU tensor."""
    if x.is_cuda:
        return conv_aux_cuda(x, aux, khat, khat_sh)
    return conv_aux_plain(x, aux, khat, khat_sh)
