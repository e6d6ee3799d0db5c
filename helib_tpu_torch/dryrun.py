"""Automorphism recording (planning mode), helib_tpu.dryrun.

The role of HElib's FHEglobals::dryRun / setAutomorphVals: run a circuit
once (typically at tiny parameters) while recording which X -> X^k
automorphisms it performs, then pre-generate exactly those key-switching
matrices with `add_these_matrices` (HElib's addTheseMatrices).
`Ctxt.smart_automorph` calls `note_automorph`.
"""

from __future__ import annotations

from contextlib import contextmanager

_recording: set | None = None


@contextmanager
def record_automorphs():
    """with record_automorphs() as vals: ... ; vals = {kexp, ...}"""
    global _recording
    prev = _recording
    _recording = set()
    try:
        yield _recording
    finally:
        _recording = prev


def note_automorph(kexp: int):
    if _recording is not None:
        _recording.add(int(kexp))


def is_recording() -> bool:
    return _recording is not None


def add_these_matrices(key, vals):
    """Pre-generate KS matrices for exactly the recorded automorphisms."""
    from .keys import SKHandle
    for k in sorted(vals):
        if k != 1:
            key.gen_ks_matrix(SKHandle(1, int(k), 0))
