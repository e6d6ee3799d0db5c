"""Accumulating timers + statistics counters (helib_tpu.timing; role of
HElib's timing.h:45-128, HELIB_TIMER_START / printAllTimers, and fhe_stats,
fhe_stats.h:38-53, HELIB_STATS_UPDATE).

The timers read the host's wall clock around the call, as helib_tpu's do:
they do not synchronize the device, so on a GPU a timer closes when the
host has queued the work, not when the card has done it.  Device time is
taken with CUDA events and torch.profiler (chip_smoke.py), not here.  The
statistics are off unless `fhe_stats` is set to True, as in HElib.
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class _Timer:
    name: str
    count: int = 0
    total: float = 0.0


_timers: dict[str, _Timer] = {}
_lock = threading.Lock()


@contextmanager
def timer(name: str):
    """with timer("KS_loop"): ...  (role of HELIB_NTIMER_START)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            t = _timers.setdefault(name, _Timer(name))
            t.count += 1
            t.total += dt


def timed(fn):
    """Decorator form (role of HELIB_TIMER_START on function scope)."""
    name = fn.__qualname__

    def wrapper(*a, **kw):
        with timer(name):
            return fn(*a, **kw)
    wrapper.__name__ = fn.__name__
    return wrapper


def get_timer(name: str) -> tuple[int, float]:
    t = _timers.get(name)
    return (t.count, t.total) if t else (0, 0.0)


def reset_all_timers():
    _timers.clear()


def print_all_timers(file=None):
    file = file or sys.stderr
    for t in sorted(_timers.values(), key=lambda x: -x.total):
        avg = t.total / t.count if t.count else 0.0
        print(f"  {t.name}: {t.total:.4f}s / {t.count} calls = {avg*1e3:.3f}ms",
              file=file)


# ---------------------------------------------------------------------------
# statistics records (reference fhe_stats.h: count/sum/max + saved values)
# ---------------------------------------------------------------------------

fhe_stats = False     # opt-in global, like reference `fhe_stats`


@dataclass
class _Stat:
    name: str
    count: int = 0
    total: float = 0.0
    max: float = float("-inf")
    saved: list = field(default_factory=list)


_stats: dict[str, _Stat] = {}


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
