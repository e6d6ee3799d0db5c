"""Tiny cells the CPU tests run: the shipped mixes on small rings."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hebench import cells  # noqa: E402

BGV = {"scheme": "bgv", "m": 127, "p": 2, "r": 1, "bits": 120, "c": 3,
       "rotations": [3]}
CKKS = {"scheme": "ckks", "m": 1024, "p": -1, "r": 30, "bits": 200, "c": 3,
        "rotations": [1, 2, 4, 8]}
# CKKS at m=1024 reads 1e-5 against exact slots; garbage reads ~1e+50
LIMITS = {"bgv": {"wrong_coeffs": 0, "bad_residues": 0},
          "ckks": {"max_err": 1e-3, "bad_residues": 0}}
SHIPPED = {"bgv": "bgv_m8009", "ckks": "ckks_m65536"}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(scheme: str, traffic: str) -> cells.Cell:
    """The shipped cell's mix and metrics on the tiny ring of `scheme`."""
    name = f"{SHIPPED[scheme]}.{traffic}"
    with open(os.path.join(cells.HERE, "traffic", traffic + ".json")) as f:
        tr = json.load(f)
    if tr["kind"] == "batched":
        tr.update(pool_min_bytes=1, trace_count=4)
    else:
        tr.update(trace_count=12)
    b = bench()
    return cells.Cell(name, 1, BGV if scheme == "bgv" else CKKS, tr,
                      LIMITS[scheme],
                      [m for m in b["end_to_end"] if cells._reports(m, name)],
                      [m for m in b["per_layer"] if cells._reports(m, name)])
