"""Fused negacyclic power-of-2 NTT over the RNS rows of a ring element.

Port of helib_tpu/ops/pallas_ntt.py::pallas_ntt (K2, kernel `_ntt_kernel`,
wrapper `apply_ntt`): for each row of x [..., P, n] the forward transform
(coefficients -> evaluations in `eval_exponents` order) or the inverse
(n^-1 included) mod the row's prime, fully reduced.  Two versions of one
function:

  * `ntt_cuda`  -- the hand-written CUDA kernel (csrc/ntt.cu), the
                   forward and inverse modes of the row template
                   csrc/ntt_rows.cuh (register composites of 3 levels, one
                   CTA a row up to n = 32768, a cluster of 4 CTAs at
                   n = 65536), reading the flat [P, n] tables of
                   Pow2NTT.flat();
  * `ntt_plain` -- the staged torch transforms ntt_pow2_fwd / ntt_pow2_inv
                   (helib_tpu/ops/ntt.py), the reference the kernel is held
                   to bit for bit, reading the [P, 2^s] stage tables.

`ntt` dispatches on where the tensor lies: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version.  There is no fallback from
one to the other.  With HELIB_NTT_V2=1 (ops/ntt2.py `ntt_v2`) it takes K4,
the same function under the block-list schedule, in place of K2: `ntt2_cuda`
or `ntt2_plain`.  Its table dict `t` holds both forms for one prime-row set
(Context.ntt_tree): the stage tables and `t["flat"]`.
"""

from __future__ import annotations

from .ntt import ntt_pow2_fwd, ntt_pow2_inv
from .ntt2 import ntt_v2, ntt2_cuda, ntt2_plain
from .rows import launch_ntt


def ntt_plain(x, t, inverse: bool):
    """x [..., P, n]; t: the stage tables of the P primes (Pow2NTT.tree)."""
    return ntt_pow2_inv(x, t) if inverse else ntt_pow2_fwd(x, t)


def ntt_cuda(x, flat, q, inverse: bool):
    """The CUDA kernel on x [..., P, n] (int32, contiguous, on the GPU,
    n = 8 .. 65536); flat: Pow2NTT.flat() of the P primes as device
    tensors, q [P, 1]."""
    return launch_ntt("ntt", x, flat, q, inverse)


def ntt(x, t, inverse: bool):
    """The transform on x's device: the CUDA kernel for a CUDA tensor, the
    plain torch version for a CPU tensor; K4's pair under HELIB_NTT_V2=1."""
    v2, k = ntt_v2()
    if v2:
        if x.is_cuda:
            return ntt2_cuda(x.contiguous(), t["flat"], t["q"], inverse, k)
        return ntt2_plain(x, t["flat"], t["q"], inverse, k)
    if x.is_cuda:
        return ntt_cuda(x.contiguous(), t["flat"], t["q"], inverse)
    return ntt_plain(x, t, inverse)
