"""Vectorized modular arithmetic on residue tensors (helib_tpu.ops.modops).

Every device prime is a ~30-bit prime q in (2^29, 2^30), so a residue fits a
non-negative int32 with the same bits as helib_tpu's uint32.  Tensors stay
int32 at rest; sums stay int32 (a + b < 2^31), products upcast to int64
inside the op.  Host tables (Shoup companions, Barrett mu) are uint32 values
up to 2^32 - 1 and are shipped as int32 bit patterns (`to_device`), so every
op that reads one masks it back to its unsigned value.

Two invariants keep the int64 arithmetic exact (torch has no uint64):
  * Shoup: a * w' < 2^63 needs a < 2^31, so every input must be a reduced
    residue (a < q < 2^30) -- true of every tensor on the ring path;
  * Barrett: (x >> 29) * mu < 2^63 because x = a * b < 2^60.

Shapes: residue tensors are [..., L, N] with per-limb primes as [L, 1].
"""

from __future__ import annotations

import numpy as np
import torch

BARRETT_S1 = 29
BARRETT_S2 = 32
MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host-side precomputation (numpy, identical to helib_tpu)
# ---------------------------------------------------------------------------

def barrett_mu(q) -> np.ndarray:
    """mu = floor(2^(s1+s2) / q) per prime; q may be scalar or array."""
    q = np.asarray(q, dtype=np.uint64)
    return ((np.uint64(1) << np.uint64(BARRETT_S1 + BARRETT_S2)) // q
            ).astype(np.uint32)


def shoup(w, q) -> np.ndarray:
    """Shoup companion floor(w * 2^32 / q) for fixed multiplicands w mod q."""
    w = np.asarray(w, dtype=np.uint64)
    q = np.asarray(q, dtype=np.uint64)
    return ((w << np.uint64(32)) // q).astype(np.uint32)


def to_device(a, device) -> torch.Tensor:
    """Host uint32 array -> int32 tensor with the same bits on `device`,
    sharing no memory with `a` (the upload to a card is the one copy)."""
    a = np.require(a, np.uint32, ("C", "W")).view(np.int32)
    t = torch.from_numpy(a)
    return t.clone() if torch.device(device).type == "cpu" else t.to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """int32 residue tensor -> host uint32 array with the same bits."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)


def _u(t: torch.Tensor) -> torch.Tensor:
    """Unsigned value of a uint32 bit pattern, as int64."""
    return t.to(torch.int64) & MASK32


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------

def add_mod(a, b, q):
    r = a + b
    return torch.where(r >= q, r - q, r)


def sub_mod(a, b, q):
    r = a + q - b
    return torch.where(r >= q, r - q, r)


def neg_mod(a, q):
    return torch.where(a == 0, a, q - a)


def mul_mod(a, b, q, mu):
    """General modular multiply, Barrett.  a, b reduced residues; q, mu
    [L, 1]."""
    x = a.to(torch.int64) * b.to(torch.int64)
    q64 = q.to(torch.int64)
    t = ((x >> BARRETT_S1) * _u(mu)) >> BARRETT_S2
    r = x - t * q64
    r = torch.where(r >= q64, r - q64, r)
    r = torch.where(r >= q64, r - q64, r)
    return r.to(torch.int32)


def mul_mod_shoup(a, w, w_shoup, q):
    """a * w mod q with the precomputed Shoup companion of w (a < 2^31)."""
    a64 = a.to(torch.int64)
    hi = (a64 * _u(w_shoup)) >> 32
    r = (a64 * w.to(torch.int64) - hi * q.to(torch.int64)) & MASK32
    r = r.to(torch.int32)
    return torch.where(r >= q, r - q, r)


def reduce_u32(a, q):
    """Reduce a value < 2*q into [0, q) (cross-prime re-reduction when
    residues < 2^30 meet primes > 2^29)."""
    return torch.where(a >= q, a - q, a)
