"""Host ms a `mult` request spends in the program's Python and kernel
launches: per request, the union of the program's outermost spans
(helib_tpu_torch.timing) less the union of its noise measurements
(`Ctxt.mod_down_to.measure`) and host encodes (`EncryptedArrayCKKS.encode`),
averaged over the `mult` requests whose spans were matched.

The program stamps its spans with `time.time_ns()`, the clock the
profiler stamps the harness's spans with.  A request's outermost spans
(those with no parent) and every span under them are given to the
`request.<op>` span that holds the outermost one's midpoint, which a few
µs of offset between the two clocks cannot move.  The other readers of
the program's spans take `program_requests` and `union_ns` from here."""

from __future__ import annotations

import bisect

from hebench.metrics._common import in_window, requests_of
from hebench.trace import busy_ns
from helib_tpu_torch import timing

HOST_ALGEBRA = ("Ctxt.mod_down_to.measure", "EncryptedArrayCKKS.encode")


def union_ns(spans: list) -> int:
    """The length of the union of `spans`' intervals, in ns."""
    if not spans:
        return 0
    return busy_ns(spans, min(s["start"] for s in spans),
                   max(s["end"] for s in spans))


def program_requests(t: dict, op: str):
    """The program's spans of each `op` request of the window that holds
    at least one of them, by the request's place in `requests_of(t, op)`:
    lists of spans, each clipped to the window and carrying its `index` in
    the recorder.  None where the program records no spans (no recorder),
    none matched, or the window saw no device activity (a run on the host
    CPU, with no device trace to set the host's time against)."""
    recorded = getattr(timing, "spans", None)
    if recorded is None or not in_window(t):
        return None
    lo, hi = t["window"]
    reqs = requests_of(t, op)
    starts = [a for a, _ in reqs]
    trees: dict = {}
    for i, s in enumerate(recorded()):
        if s["end"] is None or s["end"] <= lo or s["start"] >= hi:
            continue
        trees.setdefault(s["request"], []).append(
            {**s, "start": max(s["start"], lo), "end": min(s["end"], hi),
             "index": i})
    out: dict = {}
    for rid, tree in trees.items():
        root = [s for s in tree if s["index"] == rid]
        if not root:
            continue
        mid = (root[0]["start"] + root[0]["end"]) // 2
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid < reqs[k][1]:
            out.setdefault(k, []).extend(tree)
    return out or None


def dispatch_ms(t: dict, op: str):
    got = program_requests(t, op)
    if not got:
        return None
    ns = sum(union_ns([s for s in tree if s["parent"] is None])
             - union_ns([s for s in tree if s["name"] in HOST_ALGEBRA])
             for tree in got.values())
    return ns / 1e6 / len(got)


def read(t: dict):
    return dispatch_ms(t, "mult")
