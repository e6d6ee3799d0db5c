"""The rate a batched mix reaches at each batch size, on one card.

    python3 hebench/sweep.py --workload bgv_m8009.mult_b16 \\
        --batches 1,4,16,64 --seconds 5 --seed N

Builds the cell's context and keys once, then for each batch size the
cell's own mix with that batch (its pool, capture and warm-up), and
measures it for the given seconds.  Prints one JSON line a batch: the
batch, ciphertext products a second, calls, and the card's peak memory in
GiB since that batch's pool was built.  The benchmark's runs never run
this: it is how the batch of a batched cell is chosen.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from hebench import cells, port  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.Cell.load(args.workload)
    sch = port.scheme(cell.config, args.seed, "cuda")
    for batch in (int(b) for b in args.batches.split(",")):
        torch.cuda.reset_peak_memory_stats()
        mix = cells.kind(cell.traffic["kind"])(
            sch, {**cell.traffic, "batch": batch}, args.seed)
        res = mix.window(args.seconds)
        print(json.dumps({"workload": cell.name, "batch": batch,
                          "ops_per_s": mix.number("ops_per_s", res),
                          "calls": res["calls"],
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30}), flush=True)
        del mix, res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
