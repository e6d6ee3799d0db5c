"""Times the cost probes P1 and P2, and K1, K5 and K3 a row, of one
checkout's port on the card with chip_smoke.py's own inputs, checks and
timer, so that two trees can be compared inside one run.

    python3 tools/probe_times.py [--root DIR] [--p2-sizes 16384,65536]

Imports helib_tpu_torch from DIR (default: the checkout holding this
script), which builds its own kernels under DIR/build/, and chip_smoke.py
from the checkout holding this script.  Each P1 variant at [160, 16384] and
each P2 phase at [160, n] for n in --p2-sizes is held to its plain version
bit for bit, alone and chained 3 times, then timed (chip_smoke.probe_us:
the median over 5 runs of 50 (P1) or 100 (P2) chained applications
queued behind a sleep kernel).  A checkout whose P2 stops at n = 2^15 is
given --p2-sizes 16384.  Prints one JSON line: microseconds an application
and a row, and the card's name and power limit (nvidia-smi).  Imports
nothing of JAX or helib_tpu.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--p2-sizes", default="16384,65536")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_times: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from helib_tpu_torch.ops import probes
    if not probes.__file__.startswith(root):
        raise SystemExit(f"imported {probes.__file__}, not {root}'s")

    dev = torch.device("cuda")
    sizes = tuple(int(n) for n in args.p2_sizes.split(","))
    cases = smoke.probe_cases(dev, sizes)
    smoke.check_probes(cases)
    print(json.dumps({"metric": "probe_us_per_application",
                      "root": args.root, "rows": smoke.PROBE_ROWS,
                      "us": smoke.probe_us(cases),
                      "us_per_row_k1_k5_k3": smoke.conv_rows_us(dev),
                      "card": smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
