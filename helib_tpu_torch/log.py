"""Soft-warning channel (helib_tpu.log; role of HElib's log.h Warning())."""

from __future__ import annotations

import sys

_warnings_seen: set = set()


def warning(msg: str, once: bool = False):
    """Soft failure path: print to stderr (once per message if `once`)."""
    if once and msg in _warnings_seen:
        return
    _warnings_seen.add(msg)
    print(f"[helib_tpu_torch] WARNING: {msg}", file=sys.stderr)
