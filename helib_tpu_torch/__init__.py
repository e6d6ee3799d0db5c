"""helib_tpu_torch — the PyTorch/CUDA port of helib_tpu.

Runs helib_tpu's BGV and CKKS paths (keys, encryption, relinearization,
modulus switching, rotations, the slot layer, bootstrapping, the circuit
library, noise measurement, I/O and the command-line utilities) on an
NVIDIA GPU.  Its hand-written CUDA kernels are the five NTT-family kernels
of helib_tpu's Pallas set -- the Bluestein convolutions of odd-m transforms
(row-major ops/csrc/conv.cu, aux-major ops/csrc/conv_aux.cu), the fused
negacyclic NTT of power-of-2 m (ops/csrc/ntt.cu) and their v2-schedule
twins (ops/csrc/ntt2.cu), all instantiations of ops/csrc/ntt_rows.cuh --
plus the two cost probes (ops/csrc/probes.cu) and two kernels of its own:
the canonical-embedding max of the measured mod-switch noise
(ops/csrc/embed_max.cu), which helib_tpu computes on the host, and the RNS
basis extension of the key switch's digits and the scaled mod-down
(ops/csrc/basis_ext.cu), which helib_tpu leaves to XLA.  Transforms
above 2^16 run the staged torch transforms, as helib_tpu's do above its
kernels.  Module names mirror helib_tpu's so each counterpart is easy to
find; nothing here imports JAX or helib_tpu.

Residues are kept at rest as int32 tensors holding the uint32 bit pattern
(every prime is below 2^30); modular products upcast to int64 inside the op.
Entry points (`Context`, the pipeline builders, the CLI) run on
`device="cuda"` unless the caller asks for `device="cpu"`, where every
kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"

from .nt.numbth import factorize, phi_n, mult_order, find_generators  # noqa: E402,F401
