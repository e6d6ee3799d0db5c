"""Helpers the metric readers share (no metric of its own)."""

from __future__ import annotations

import bisect

from hebench.trace import busy_ns

# the device body of every NTT-family kernel (K1-K5): ops/csrc/ntt_rows.cuh
NTT_FAMILY = ("ntt_rows_kernel",)
# copies and fills: device activity, but no ring op
COPIES = ("Memcpy", "Memset")


def in_window(t: dict) -> list:
    lo, hi = t["window"]
    return [e for e in t["device"] if e["end"] > lo and e["start"] < hi]


def is_ntt(name: str) -> bool:
    return any(k in name for k in NTT_FAMILY)


def is_copy(name: str) -> bool:
    return name.startswith(COPIES)


def clipped_ns(e: dict, t: dict) -> int:
    lo, hi = t["window"]
    return min(e["end"], hi) - max(e["start"], lo)


def idle_share(t: dict):
    """100 * (1 - device-busy union / window), None without device
    activity."""
    lo, hi = t["window"]
    evs = in_window(t)
    if not evs or hi <= lo:
        return None
    return 100.0 * (1.0 - busy_ns(evs, lo, hi) / (hi - lo))


def requests_of(t: dict, op: str) -> list:
    """The [start, end] of each `request.<op>` span, sorted: an operation
    of a one-at-a-time window from its issue to the synchronize after it
    (the harness's own work, such as `keep`, lies outside)."""
    return sorted([s["start"], s["end"]] for s in t["spans"]
                  if s["name"] == "request." + op)


def activity_by_request(t: dict, spans: list) -> list:
    """The device activity each span caused: the activity whose runtime
    call (a launch, copy or fill with the same correlation id) the host
    made inside the span.  Matched by id, not by time, so a skew between
    the card's clock and the host's moves nothing to another request."""
    starts = [a for a, _ in spans]
    owner = {}
    for c in t.get("launches", []):
        i = bisect.bisect_right(starts, c["start"]) - 1
        if i >= 0 and c["start"] < spans[i][1]:
            owner[c["corr"]] = i
    out: list = [[] for _ in spans]
    for e in t["device"]:
        if e["corr"] in owner:
            out[owner[e["corr"]]].append(e)
    return out


def request_idle_share(t: dict, op: str):
    """100 * (1 - device-busy time / time) over the requests of `op`, each
    request's busy time the union of the activity it caused; None without
    device activity in them."""
    spans = requests_of(t, op)
    acts = activity_by_request(t, spans)
    total = sum(b - a for a, b in spans)
    if not any(acts) or not total:
        return None
    busy = sum(busy_ns(evs, min(e["start"] for e in evs),
                       max(e["end"] for e in evs)) for evs in acts if evs)
    return 100.0 * (1.0 - busy / total)


def launches_per_request(t: dict, op: str):
    """Launches the host issued a request of `op`: the distinct correlation
    ids of the device activity its requests caused (a CUDA-graph replay's
    kernels share its launch's id; an eager kernel, copy or fill has its
    own), over the requests; None without device activity in them."""
    spans = requests_of(t, op)
    ids = {e["corr"] for evs in activity_by_request(t, spans) for e in evs}
    if not ids:
        return None
    return len(ids) / len(spans)
