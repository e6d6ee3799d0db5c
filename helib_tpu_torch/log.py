"""Logger + soft-warning channel (helib_tpu.log; role of HElib's log.h:
the log file and Warning())."""

from __future__ import annotations

import sys

_warnings_seen: set = set()
_log_file = None           # None: the sys.stderr of the moment


def set_log_file(f):
    global _log_file
    _log_file = f


def helog(msg: str):
    print(f"[helib_tpu_torch] {msg}",
          file=sys.stderr if _log_file is None else _log_file)


def warning(msg: str, once: bool = False):
    """Soft failure path: log a warning (once per message if `once`)."""
    if once and msg in _warnings_seen:
        return
    _warnings_seen.add(msg)
    helog(f"WARNING: {msg}")
