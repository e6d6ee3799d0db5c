"""helib_tpu_torch — the PyTorch/CUDA port of helib_tpu.

Runs the BGV and CKKS ciphertext paths (keys, encryption, tensor product,
relinearization, modulus switching, CKKS encoding and rescaling) on an
NVIDIA GPU, with two hand-written CUDA kernels: the Bluestein convolution
of odd-m transforms (ops/csrc/conv.cu) and the fused negacyclic NTT of
power-of-2 m (ops/csrc/ntt.cu).  Module names mirror helib_tpu's so each
counterpart is easy to find; nothing here imports JAX or helib_tpu.

Residues are kept at rest as int32 tensors holding the uint32 bit pattern
(every prime is below 2^30); modular products upcast to int64 inside the op.
Entry points (`Context`, the pipeline builders) run on `device="cuda"` unless
the caller asks for `device="cpu"`, where every kernel is replaced by its
plain PyTorch version.
"""

__version__ = "0.1.0"
