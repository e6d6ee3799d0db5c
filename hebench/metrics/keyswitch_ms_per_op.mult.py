"""Device ms a `mult` request spends in its key switch: per request, the
union of the device activity whose runtime call the host made inside the
program's `Ctxt.relinearize` spans (the digits, the key-switching
multiply-accumulate and the special-prime add), averaged over the `mult`
requests whose spans were matched.

Span trees go to requests as in `dispatch_ms_per_op.mult`, and activity
to spans by correlation id, as `_common.activity_by_request` gives it to
requests.  None where the program records no `Ctxt.relinearize` span."""

from __future__ import annotations

from hebench import cells
from hebench.metrics._common import activity_by_request
from hebench.trace import busy_intervals, busy_ns

KEY_SWITCH = "Ctxt.relinearize"


def keyswitch_ms(t: dict, op: str):
    got = cells._module("metrics", "dispatch_ms_per_op.mult"
                        ).program_requests(t, op)
    if not got:
        return None
    lo, hi = t["window"]
    ns, seen = 0, False
    for tree in got.values():
        ks = [s for s in tree if s["name"] == KEY_SWITCH]
        seen = seen or bool(ks)
        evs = [e for acts in activity_by_request(
            t, busy_intervals(ks, lo, hi)) for e in acts]
        if evs:
            ns += busy_ns(evs, min(e["start"] for e in evs),
                          max(e["end"] for e in evs))
    return ns / 1e6 / len(got) if seen else None


def read(t: dict):
    return keyswitch_ms(t, "mult")
