"""Random matrix-instance generators for tests and benchmarks.

Mirrors HElib's header-only generators (randomMatrices.h:
buildRandomMatrix / buildRandomBlockMatrix / buildRandomFullMatrix /
buildRandomFullBlockMatrix) which return MatMul instances filled with
uniform entries; used by GTestMatmul-style suites to exercise every
strategy on arbitrary instances.
"""

from __future__ import annotations

import numpy as np

from .matmul import MatMul1D, BlockMatMul1D, MatMulFull, BlockMatMulFull


def random_matmul1d(ea, dim: int, rng=None, zero_frac: float = 0.0):
    """Random D x D scalar matrix along `dim` (randomMatrices.h
    RandomMatrix); zero_frac entries forced to 0 to exercise the
    skip-empty-diagonal path."""
    rng = rng or np.random.default_rng(0)
    D = ea.ctx.pal.orders[dim]
    M = rng.integers(0, ea.pr, (D, D))
    if zero_frac > 0:
        M[rng.random((D, D)) < zero_frac] = 0
    return MatMul1D(ea, dim, lambda i, j: int(M[i, j])), M


def random_block_matmul1d(ea, dim: int, rng=None):
    """Random D x D matrix of d x d blocks over Z_{p^r} (randomMatrices.h
    RandomBlockMatrix)."""
    rng = rng or np.random.default_rng(0)
    D = ea.ctx.pal.orders[dim]
    d = ea.d
    B = rng.integers(0, ea.pr, (D, D, d, d))
    return BlockMatMul1D(ea, dim, lambda i, j: np.asarray(B[i, j])), B


def random_matmul_full(ea, rng=None):
    """Random nslots x nslots scalar matrix (randomMatrices.h
    RandomFullMatrix)."""
    rng = rng or np.random.default_rng(0)
    n = ea.nslots
    M = rng.integers(0, ea.pr, (n, n))
    return MatMulFull(ea, lambda i, j: int(M[i, j])), M


def random_block_matmul_full(ea, rng=None):
    """Random nslots x nslots matrix of d x d blocks (randomMatrices.h
    RandomFullBlockMatrix)."""
    rng = rng or np.random.default_rng(0)
    n, d = ea.nslots, ea.d
    B = rng.integers(0, ea.pr, (n, n, d, d))
    return BlockMatMulFull(ea, lambda i, j: np.asarray(B[i, j])), B
