"""Statistics counters (helib_tpu.timing; role of HElib's fhe_stats,
src/fhe_stats.cpp, fhe_stats.h:38-53: HELIB_STATS_UPDATE).

Off unless `fhe_stats` is set to True, as in HElib.  Device timing is done
with CUDA events and torch.profiler (chip_smoke.py), not here.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field

fhe_stats = False     # opt-in global, like reference `fhe_stats`


@dataclass
class _Stat:
    name: str
    count: int = 0
    total: float = 0.0
    max: float = float("-inf")
    saved: list = field(default_factory=list)


_stats: dict[str, _Stat] = {}
_lock = threading.Lock()


def stats_update(name: str, value: float, save: bool = False):
    """HELIB_STATS_UPDATE equivalent — gated on the fhe_stats global."""
    if not fhe_stats:
        return
    with _lock:
        s = _stats.setdefault(name, _Stat(name))
        s.count += 1
        s.total += value
        s.max = max(s.max, value)
        if save:
            s.saved.append(value)


def print_stats(file=None):
    file = file or sys.stderr
    for s in sorted(_stats.values(), key=lambda x: x.name):
        mean = s.total / s.count if s.count else 0.0
        print(f"  {s.name}: mean={mean:.4g} max={s.max:.4g} n={s.count}",
              file=file)


def reset_stats():
    _stats.clear()
