"""Host ms a `mult` request spends measuring the noise of its mod-downs:
the program's `Ctxt.mod_down_to.measure` spans less their
`Ctxt.mod_down_to.to_host` children (the copies that wait for the card),
summed over the `mult` requests whose spans were matched and divided by
their count.  The copies have drained the card by then, so it is idle
throughout this time.  Spans are matched to requests as in
`dispatch_ms_per_op.mult`."""

from hebench import cells

MEASURE, TO_HOST = "Ctxt.mod_down_to.measure", "Ctxt.mod_down_to.to_host"


def read(t: dict):
    got = cells._module("metrics", "dispatch_ms_per_op.mult"
                        ).program_requests(t, "mult")
    if not got:
        return None
    ns = 0
    for tree in got.values():
        measures = {s["index"] for s in tree if s["name"] == MEASURE}
        ns += sum(s["end"] - s["start"] for s in tree
                  if s["name"] == MEASURE)
        ns -= sum(s["end"] - s["start"] for s in tree
                  if s["name"] == TO_HOST and s["parent"] in measures)
    return ns / 1e6 / len(got)
