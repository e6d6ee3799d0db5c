"""The bgv_m32003 deployment's cell on a small ring of the same shape: its
mix (`ops_b1_s12`) through `run.run_cell` on the host CPU at m=1019, p=2,
c=3 (one slot, as at m=32003: 2 generates (Z/1019)^*), with three digits of
several primes each and the special primes, judged correct as it stands
and not correct with every operation's answer altered; and the cell's
files as `Cell.load` finds them."""

import contextlib

import torch

import _tiny  # noqa: F401
from hebench import cells, run
from hebench.reference.numbth import prime_chain
from test_hebench_harness import SEED, op_altered, patched

NAME = "bgv_m32003.ops_b1"
# 14 ciphertext primes in digits of 5/5/4 and 5 special primes
SMALL = {"scheme": "bgv", "m": 1019, "p": 2, "r": 1, "bits": 400, "c": 3,
         "rotations": [3]}


def run_small():
    torch.set_num_threads(1)
    cell = cells.Cell.load(NAME)
    cell.config = SMALL
    return run.run_cell(cell, SEED, 0.5, False, device="cpu", t_start=0.0)


def test_the_small_ring_has_the_deployments_shape():
    qs, sp = prime_chain(1019, 400, 3, "bgv", 2)
    assert (len(qs), len(sp)) == (14, 5)
    # 1018 = 2 * 509: 2 has order 1018 mod 1019, as it has 32002 mod 32003
    for m, factors in ((1019, (2, 509)), (32003, (2, 16001))):
        assert all(pow(2, (m - 1) // f, m) != 1 for f in factors)


def test_cell_on_a_small_ring_of_the_same_shape():
    r = run_small()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert {"mult_p50_ms", "rotate_p50_ms", "peak_gib",
            "setup_s"} <= set(r["metrics"])
    assert {k: v["value"] for k, v in r["compared"].items()} == {
        "wrong_coeffs": 0, "bad_residues": 0}


def test_cell_on_a_small_ring_sees_an_altered_answer():
    with contextlib.ExitStack() as st:
        for op in ("mult", "rotate", "mul_plain", "add"):
            st.enter_context(patched(cells.op("bgv", op), "run", op_altered))
        r = run_small()
    assert not r["correct"] and r["compared"]["wrong_coeffs"]["value"] > 0


def test_the_cell_finds_every_file():
    cell = cells.Cell.load(NAME)
    cfg = cell.config
    assert (cfg["m"], cfg["p"], cfg["r"], cfg["bits"], cfg["c"]) == (
        32003, 2, 1, 5800, 3)
    qs, sp = prime_chain(cfg["m"], cfg["bits"], cfg["c"], "bgv", cfg["p"])
    assert (len(qs), len(sp)) == (cfg["derived"]["ctxt_primes"],
                                  cfg["derived"]["special_primes"])
    assert sum(cfg["derived"]["digits"]) == len(qs)
    assert cell.traffic["kind"] == "single" and callable(
        cells.kind(cell.traffic["kind"]))
    assert (cell.traffic["sample"], cell.traffic["trace_count"]) == (12, 40)
    for op in cell.traffic["ops"]:
        assert callable(cells.op("bgv", op).run)
    assert cell.limits == {"wrong_coeffs": 0, "bad_residues": 0}
    assert {m["name"] for m in cell.end_to_end} == {
        "mult_p50_ms", "mult_p95_ms", "rotate_p50_ms", "rotate_p95_ms",
        "peak_gib", "setup_s"}
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))
    assert {"keyswitch_ms_per_op.mult", "keyswitch_ms_per_op.rotate"} <= {
        m["name"] for m in cell.per_layer}


def test_the_big_mix_is_ops_b1_with_its_sample_and_trace_count_cut():
    base, big = (cells._json(f"{cells.HERE}/traffic/{name}.json")
                 for name in ("ops_b1", "ops_b1_s12"))
    assert set(big) == set(base)
    assert {k for k in base if base[k] != big[k]} == {"sample", "trace_count"}
