"""helib_tpu_torch — the PyTorch/CUDA port of helib_tpu.

Runs the BGV ciphertext path (keys, tensor product, relinearization,
modulus switching) on an NVIDIA GPU, with the Bluestein convolution of odd-m
transforms in a hand-written CUDA kernel (ops/csrc/conv.cu).  Module names
mirror helib_tpu's so each counterpart is easy to find; nothing here imports
JAX or helib_tpu.

Residues are kept at rest as int32 tensors holding the uint32 bit pattern
(every prime is below 2^30); modular products upcast to int64 inside the op.
Entry points (`Context`, the pipeline builders) run on `device="cuda"` unless
the caller asks for `device="cpu"`, where every kernel is replaced by its
plain PyTorch version.
"""

__version__ = "0.1.0"
