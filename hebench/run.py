"""The benchmark of helib_tpu_torch: one cell of BENCHMARK.json a run.

    python3 hebench/run.py --workload <config>.<traffic> --seed N \\
        --seconds S --trace 0|1

Set-up (imports, the kernels' build into build/torch_ext/ on a checkout's
first run, context, keys, the input pool, graph capture and the warm-up of
the cell's own shapes) counts from the process's start to the window's.
The window then drives the program for S seconds (`--trace 1`: a
profiled window of the mix's `trace_count` calls or requests, at most S
seconds).  Once it closes, the peak memory is read, the program's state
freed, and the plain reference (hebench/reference/) judges a sample of the
window's outputs drawn from the seed.  The last line of standard output is
one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or its per-layer ones with --trace 1), device, the
breakdown of a traced run, and last `compared`, each number judged beside
its limit; the same numbers are the last lines of standard error.

Exits 2, printing no result, without a CUDA device (or fewer than the
cell asks for); exits 3 if JAX, Flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from hebench import cells, check, port  # noqa: E402
from hebench import trace as tr  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "helib_tpu"})


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that must not be there."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """Set-up, window and judgement of one cell; the result object."""
    t_start = T_START if t_start is None else t_start
    cuda = device == "cuda"
    marks = [("imports", time.time())]
    sch = port.scheme(cell.config, seed, device)
    marks.append(("context and keys", time.time()))
    mix = cells.kind(cell.traffic["kind"])(sch, cell.traffic, seed)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("pool and warm-up", time.time()))
    setup_s = marks[-1][1] - t_start
    if trace:
        tracer = tr.Tracer(cuda)
        with tracer:
            with tr.span("window"):
                res = mix.window(seconds, cell.traffic["trace_count"])
        rec = tracer.records()
    else:
        res = mix.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    items = mix.judged(res.pop("sample"))
    numbers = {"setup_s": setup_s, "peak_gib": peak / 2 ** 30}
    for m in cell.end_to_end:
        if m["name"] not in numbers:
            numbers[m["name"]] = mix.number(m["name"], res)
    side = mix.stderr_line(res)
    facts = mix.trace_facts(res)
    s_coeffs, cfg = sch.s, cell.config
    del mix, sch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.time()
    ok, compared = check.compare(check.judge(cfg, s_coeffs, items),
                                 cell.limits)
    t, steps = t_start, []
    for name, at in marks:
        steps.append(f"{name} {at - t:.2f}")
        t = at
    print(f"hebench: {cell.name}: set-up {setup_s:.2f} s ("
          f"{', '.join(steps)}), window {res['seconds']:.2f} s "
          f"({res['attempted']} ops; {side}), reference {len(items)} "
          f"outputs in {time.time() - t_ref:.2f} s", file=sys.stderr)
    result = {"correct": bool(ok and res["failed"] == 0 and items),
              "attempted": res["attempted"], "failed": res["failed"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        lo, hi = tr.window_of(rec)
        t = {**rec, "window": (lo, hi), **facts}
        metrics = {}
        for m in cell.per_layer:
            v = cells.reader(m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_ns(rec["device"], lo, hi) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        result["metrics"] = metrics
        result["device"] = dev
        result["breakdown"] = tr.breakdown(rec, lo, hi)
    else:
        result["metrics"] = {m["name"]: {"value": numbers[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end
                             if numbers[m["name"]] is not None}
        result["device"] = dev
    result["compared"] = compared
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cell = cells.Cell.load(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"hebench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"hebench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        print(f"{name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
