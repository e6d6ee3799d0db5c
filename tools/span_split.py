"""The host time of a one-at-a-time cell's requests, split by the port's
own spans (helib_tpu_torch.timing), from one traced window run as
hebench/run.py runs it.

    python3 tools/span_split.py --workload bgv_m8009.ops_b1 --seed N \\
        [--seconds 20] [--out DIR]

For `mult` and `rotate`, each request is split into: `noise` (the
`Ctxt.mod_down_to.measure` spans less their `to_host` children), `to_host`
(the copies that wait for the card), `encode` (`EncryptedArrayCKKS.encode`),
`dispatch` (the union of the program's outermost spans less noise and
encode), `synchronize` (the harness's) and `outside` (the rest of the
request: time in no program span).  It prints the split of the median
request (by its latency) and the mean of each part, the measured
mod-downs and `jitutil.replay` spans a request, the share of the
harness's `op.<op>` time the program's outermost spans cover, the
`jitutil.capture` spans inside the window, the three readers of the
program's spans, and the skew of the card's clock against the host's (the
most negative kernel start less the start of its runtime call, by
correlation id).  One JSON line on standard output, and in DIR if given.

`--profiler 0` runs the window without torch.profiler, whose hooks slow
every eager launch: the program's spans are switched on with
`timing.tracing` and the harness's are stamped with `time.time_ns()` too,
so the split is that of an untraced run's requests (no device trace: no
skew, idle share or launch count).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from hebench import cells, port  # noqa: E402
from hebench import trace as tr  # noqa: E402
from hebench.metrics._common import requests_of  # noqa: E402
from helib_tpu_torch import timing  # noqa: E402

MEASURE, TO_HOST = "Ctxt.mod_down_to.measure", "Ctxt.mod_down_to.to_host"
ENCODE = "EncryptedArrayCKKS.encode"
READERS = ("noise_ms_per_op.mult", "dispatch_ms_per_op.mult",
           "dispatch_ms_per_op.rotate", "device_idle_share.mult",
           "device_idle_share.rotate", "launches_per_op.mult",
           "launches_per_op.rotate")


def _inside(spans: list, name: str, a: int, b: int) -> list:
    return [s for s in spans if s["name"] == name and a <= s["start"] < b]


def split(t: dict, op: str) -> dict:
    """The parts of each `op` request, their median request and means."""
    lib = cells._module("metrics", "dispatch_ms_per_op.mult")
    union = lib.union_ns
    reqs = requests_of(t, op)
    trees = lib.program_requests(t, op) or {}
    rows, op_ns, covered = [], 0, 0
    for k, (a, b) in enumerate(reqs):
        tree = trees.get(k, [])
        roots = [s for s in tree if s["parent"] is None]
        measures = [s for s in tree if s["name"] == MEASURE]
        ids = {s["index"] for s in measures}
        copies = [s for s in tree if s["name"] == TO_HOST]
        measured_copies = [s for s in copies if s["parent"] in ids]
        host = union([s for s in tree if s["name"] in (MEASURE, ENCODE)])
        sync = sum(s["end"] - s["start"]
                   for s in _inside(t["spans"], "synchronize", a, b))
        for s in _inside(t["spans"], "op." + op, a, b):
            op_ns += s["end"] - s["start"]
            covered += union([{"start": max(r["start"], s["start"]),
                               "end": min(r["end"], s["end"])}
                              for r in roots
                              if r["end"] > s["start"]
                              and r["start"] < s["end"]])
        rows.append({
            "request_ms": (b - a) / 1e6,
            "noise": (sum(s["end"] - s["start"] for s in measures)
                      - sum(s["end"] - s["start"]
                            for s in measured_copies)) / 1e6,
            "to_host": sum(s["end"] - s["start"] for s in copies) / 1e6,
            "encode": union([s for s in tree if s["name"] == ENCODE]) / 1e6,
            "dispatch": (union(roots) - host) / 1e6,
            "synchronize": sync / 1e6,
            "outside": (b - a - union(roots) - sync) / 1e6,
            "measures": len(measures),
            "replays": sum(s["name"] == "jitutil.replay" for s in tree),
            "matched": bool(tree)})
    if not rows:
        return {}
    order = sorted(rows, key=lambda r: r["request_ms"])
    return {"requests": len(rows),
            "matched": sum(r["matched"] for r in rows),
            "median_request": order[len(order) // 2],
            "mean": {key: statistics.fmean(r[key] for r in rows)
                     for key in rows[0] if key != "matched"},
            "root_cover_of_op_pct": 100.0 * covered / op_ns if op_ns
            else None}


def clock_skew_us(t: dict):
    """The most negative and the median device start less its runtime
    call's start, in µs (kernels, copies and fills with a launch)."""
    start = {c["corr"]: c["start"] for c in t["launches"]}
    d = [e["start"] - start[e["corr"]] for e in t["device"]
         if e["corr"] in start]
    if not d:
        return None
    return {"most_negative": min(d) / 1e3,
            "median": statistics.median(d) / 1e3}


def profiled_window(mix, seconds: float, count: int) -> dict:
    """The window under torch.profiler, as `hebench/run.py --trace 1`."""
    tracer = tr.Tracer(True)
    with tracer:
        with tr.span("window"):
            mix.window(seconds, count)
    return tracer.records()


def host_clock_window(mix, seconds: float, count: int) -> dict:
    """The window with the program's spans on and the harness's stamped
    with `time.time_ns()`, no profiler; the device trace is one stand-in
    interval over the window (the readers want some device activity)."""
    spans: list = []

    @contextlib.contextmanager
    def span(name):
        s = {"name": name, "start": time.time_ns()}
        try:
            yield
        finally:
            s["end"] = time.time_ns()
            spans.append(s)

    cells._module("kinds", "single").span = span
    timing.tracing = True
    try:
        with span("window"):
            mix.window(seconds, count)
    finally:
        timing.tracing = False
    lo, hi = tr.window_of({"spans": spans})
    return {"device": [{"name": "stand-in", "start": lo, "end": hi,
                        "corr": None}], "launches": [], "spans": spans}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    ap.add_argument("--profiler", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    cell = cells.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("span_split: needs a CUDA device", file=sys.stderr)
        return 2
    sch = port.scheme(cell.config, args.seed, "cuda")
    mix = cells.kind(cell.traffic["kind"])(sch, cell.traffic, args.seed)
    torch.cuda.synchronize()
    timing.reset_spans()
    window = profiled_window if args.profiler else host_clock_window
    rec = window(mix, args.seconds,
                 cell.traffic["trace_count"] if args.profiler else None)
    lo, hi = tr.window_of(rec)
    t = {**rec, "window": (lo, hi)}
    out = {"workload": cell.name, "seed": args.seed,
           "profiler": bool(args.profiler),
           "card": torch.cuda.get_device_name(0),
           "window_s": (hi - lo) / 1e9,
           "captures_in_window": sum(
               s["name"] == "jitutil.capture" and s["end"] is not None
               and s["end"] > lo and s["start"] < hi
               for s in timing.spans()),
           "readers": {n: cells.reader(n)(t) for n in READERS},
           "clock_skew_us": clock_skew_us(t),
           "split": {op: split(t, op) for op in ("mult", "rotate")}}
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"span_split_{cell.name}_"
                               f"{args.seed}_p{args.profiler}.json"),
                  "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
