"""Spans and the device trace of a `--trace 1` run.

Spans are recorded from the harness around each call into the program
(`span`): as torch.profiler ranges while a trace is open, and not at all
otherwise, so a `--trace 0` run pays nothing for them.  `Tracer` runs
torch.profiler over the traced window and turns its events into plain
records -- device activity (kernels, copies, fills) and host spans -- that
the metric readers take; the busy time and the breakdown are read here
once for all of them.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "hebench."
_active = False


def span(name: str):
    """A span named `name` around the block while a trace is open."""
    if not _active:
        return contextlib.nullcontext()
    return torch.profiler.record_function(PREFIX + name)


class Tracer:
    """torch.profiler over a window; `records()` after it closes."""

    def __init__(self, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        global _active
        self.prof.__enter__()
        _active = True
        return self

    def __exit__(self, *exc):
        global _active
        _active = False
        self.prof.__exit__(*exc)
        return False

    def records(self) -> dict:
        """{'device': [...], 'launches': [...], 'spans': [...]}, each
        record {'name', 'start', 'end'} in ns: device activity with its
        correlation id, the host's runtime calls that carry one (a launch,
        copy or fill shares its id with the device activity it caused),
        and the harness's spans."""
        dev, launches, spans = [], [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            name, start = e.name(), e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == cuda:
                if e.is_user_annotation() or name.startswith(PREFIX):
                    continue
                dev.append({"name": name, "start": start, "end": end,
                            "corr": e.correlation_id()})
            elif name.startswith(PREFIX):
                spans.append({"name": name[len(PREFIX):], "start": start,
                              "end": end})
            elif name.startswith("cu") and e.correlation_id():
                launches.append({"name": name, "start": start, "end": end,
                                 "corr": e.correlation_id()})
        return {"device": dev, "launches": launches, "spans": spans}


def window_of(rec: dict) -> tuple[int, int] | None:
    w = [s for s in rec["spans"] if s["name"] == "window"]
    return (w[0]["start"], w[0]["end"]) if w else None


def busy_intervals(device: list, lo: int, hi: int) -> list:
    """The union of device activity clipped to [lo, hi], sorted."""
    ivs = sorted((max(e["start"], lo), min(e["end"], hi)) for e in device
                 if e["end"] > lo and e["start"] < hi)
    out: list = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ns(device: list, lo: int, hi: int) -> int:
    return sum(b - a for a, b in busy_intervals(device, lo, hi))


class Innermost:
    """The innermost host span at each of a rising sequence of times (the
    spans of one thread nest); 'none' outside every span but the
    window."""

    def __init__(self, spans: list):
        self.spans = sorted((s for s in spans if s["name"] != "window"),
                            key=lambda s: (s["start"], -s["end"]))
        self.next, self.stack = 0, []

    def at(self, t: int) -> str:
        while (self.next < len(self.spans)
               and self.spans[self.next]["start"] <= t):
            self.stack.append(self.spans[self.next])
            self.next += 1
        while self.stack and self.stack[-1]["end"] <= t:
            self.stack.pop()
        while self.stack and not (self.stack[-1]["start"] <= t
                                  < self.stack[-1]["end"]):
            self.stack.pop()
        return self.stack[-1]["name"] if self.stack else "none"


def breakdown(rec: dict, lo: int, hi: int, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of the
    window by the host span it fell in, each [name, seconds], longest
    first."""
    by_op: dict = {}
    for e in rec["device"]:
        if e["end"] > lo and e["start"] < hi:
            by_op[e["name"]] = by_op.get(e["name"], 0) + (
                min(e["end"], hi) - max(e["start"], lo))
    gaps: dict = {}
    t, inner = lo, Innermost(rec["spans"])
    for a, b in busy_intervals(rec["device"], lo, hi) + [[hi, hi]]:
        if a > t:
            label = inner.at((a + t) // 2)
            gaps[label] = gaps.get(label, 0) + (a - t)
        t = max(t, b)
    top_of = lambda d: [[k, v / 1e9] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": top_of(by_op), "idle_gaps": top_of(gaps)}
