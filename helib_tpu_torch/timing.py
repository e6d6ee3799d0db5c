"""Spans with HElib's accumulating timers, and statistics counters
(helib_tpu.timing; role of HElib's timing.h:45-128, HELIB_TIMER_START /
printAllTimers, and fhe_stats, fhe_stats.h:38-53, HELIB_STATS_UPDATE).

`timer(name)` around a block and `timed(fn)` around a function (named by
its `__qualname__`) record one span each: its name, its start and end from
`time.time_ns()` -- the clock torch.profiler stamps its host events with,
so the spans lie on the same time line as a device trace -- the index of
the enclosing open span of the same thread (`parent`) and that of the
thread's outermost open span (`request`: every span of one call into the
port shares it).  A span is host time: it does not synchronize the device,
so on a GPU it closes when the host has queued its work, not when the card
has done it; device time comes from the device trace.  Each closed span
also adds to its name's timer, which `get_timer` and `print_all_timers`
read.

Spans are recorded only while `tracing` is True or a torch profiler is
recording.  Otherwise `timer` returns one shared no-op context and reads no
clock, and `timed` calls its function after that one check.  `spans()`
returns the recorded spans and `reset_spans()` clears them.  The
statistics are off unless `fhe_stats` is set to True, as in HElib.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time
from dataclasses import dataclass, field

import torch

tracing = False       # the operator's switch for spans, like `fhe_stats`
_profiling = torch._C._autograd._profiler_enabled


@dataclass
class _Timer:
    name: str
    count: int = 0
    total: float = 0.0


_timers: dict[str, _Timer] = {}
_spans: list[dict] = []
_lock = threading.Lock()
_local = threading.local()     # .stack: this thread's open spans' indices


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "stack")

    def __init__(self, name: str):
        self.rec = {"name": name, "start": 0, "end": None, "parent": None,
                    "request": None}

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec, self.stack = self.rec, stack
        with _lock:
            i = len(_spans)
            _spans.append(rec)
        rec["parent"] = stack[-1] if stack else None
        rec["request"] = stack[0] if stack else i
        stack.append(i)
        rec["start"] = time.time_ns()
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec["end"] = end
        self.stack.pop()
        with _lock:
            t = _timers.setdefault(rec["name"], _Timer(rec["name"]))
            t.count += 1
            t.total += (end - rec["start"]) / 1e9
        return False


def timer(name: str):
    """with timer("KS_loop"): ...  (role of HELIB_NTIMER_START)."""
    return _Span(name) if tracing or _profiling() else _OFF


def timed(fn):
    """Decorator form (role of HELIB_TIMER_START on function scope)."""
    name = fn.__qualname__

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if not (tracing or _profiling()):
            return fn(*a, **kw)
        with _Span(name):
            return fn(*a, **kw)
    return wrapper


def spans() -> list[dict]:
    """The recorded spans in the order they opened, each {'name', 'start',
    'end' (None while open), 'parent', 'request'}: times in ns since the
    epoch, `parent` and `request` indices into this list (`parent` None for
    a request's outermost span, whose `request` is its own index)."""
    with _lock:
        return list(_spans)


def reset_spans():
    """Forget the recorded spans (call it with no span open); the timers
    keep their totals."""
    with _lock:
        _spans.clear()


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
