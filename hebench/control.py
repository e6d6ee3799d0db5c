"""The control of `correct`, and the readings its limits are set from.

    python3 hebench/control.py --workload W --seeds 11,12,13 \\
        --seconds 3 [--control]

Runs the cell once a seed in one process, with a short window at the
cell's own load, and prints each seed's compared numbers as a JSON line.
Without --control these are the program's readings (the lower end of each
limit).  With --control the ring's modular products run in float64
instead of exact 64-bit integers: the configuration states exact
arithmetic mod 30-bit primes, whose products need 60 bits, and float64
keeps 53 -- the nearest precision below, and the step a fused ring-op
kernel would be tempted to take.  Its readings are the upper end; every
one of them has to come out not correct.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from hebench import cells, run  # noqa: E402


def mul_mod_float64(a, b, q, mu):
    """a * b mod q with the product rounded to float64's 53 bits."""
    x = a.to(torch.float64) * b.to(torch.float64)
    return torch.remainder(x, q.to(torch.float64)).to(torch.int32)


@contextlib.contextmanager
def float64_products():
    """The program's general modular multiply, at every site that calls
    it, replaced by mul_mod_float64 while open."""
    from helib_tpu_torch import ctxt, dcrt
    from helib_tpu_torch.ops import modops
    saved = [(m, m.mul_mod) for m in (modops, dcrt, ctxt)]
    try:
        for m, _ in saved:
            m.mul_mod = mul_mod_float64
        yield
    finally:
        for m, f in saved:
            m.mul_mod = f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cell = cells.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        with float64_products() if args.control else contextlib.nullcontext():
            r = run.run_cell(cell, seed, args.seconds, False, t_start=t0)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": args.control, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "compared": r["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
