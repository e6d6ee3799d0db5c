"""The traffic generator: the same seed gives the same inputs and order,
every seed the stated mix."""

import collections

import numpy as np
import pytest

import _tiny
from hebench import cells, inputs


def test_streams_deterministic_and_large_seeds():
    seed = 2 ** 33 + 5
    a = inputs.stream(seed, "plaintexts").integers(0, 1 << 30, 8)
    b = inputs.stream(seed, "plaintexts").integers(0, 1 << 30, 8)
    c = inputs.stream(seed, "constants").integers(0, 1 << 30, 8)
    d = inputs.stream(seed + 1, "plaintexts").integers(0, 1 << 30, 8)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)
    assert 0 <= inputs.torch_seed(seed, "encrypt") < 2 ** 63


def test_secret_key_distribution():
    s = inputs.secret_key(7, 40000)
    counts = collections.Counter(s.tolist())
    assert set(counts) == {-1, 0, 1}
    assert abs(counts[0] / 40000 - 0.5) < 0.02
    assert abs(counts[1] / 40000 - 0.25) < 0.02
    assert np.array_equal(s, inputs.secret_key(7, 40000))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9])
def test_plan_holds_each_operation_once_a_block(seed):
    ops = ["mult", "rotate", "mul_plain", "add"]
    p = inputs.cycle(inputs.stream(seed, "plan"), ops, 1000)
    assert p == inputs.cycle(inputs.stream(seed, "plan"), ops, 1000)
    for s in range(0, 1000, 4):
        assert sorted(p[s:s + 4]) == sorted(ops)
    other = inputs.cycle(inputs.stream(seed + 1, "plan"), ops, 1000)
    assert other != p and collections.Counter(other) == collections.Counter(p)


def test_shipped_mixes_name_existing_files():
    """Every kind and operation a shipped mix names has its file, for every
    configuration a cell runs it on."""
    b = _tiny.bench()
    conf = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cell = cells.Cell.load(w["name"])
        assert callable(cells.kind(cell.traffic["kind"]))
        scheme = cell.config["scheme"]
        for op in cell.traffic.get("ops", [cell.traffic.get("op")]):
            mod = cells.op(scheme, op)
            assert callable(mod.run) and callable(mod.expected)
        assert conf[w["config"]]["file"].endswith(".json")


def test_cycle_and_reservoir():
    c = inputs.cycle(inputs.stream(3, "plan"), list(range(14)), 28)
    assert sorted(c[:14]) == list(range(14)) == sorted(c[14:])
    r = inputs.Reservoir(3, inputs.stream(3, "sample"))
    for i in range(100):
        r.offer(i)
    assert len(r.items) == 3 and r.seen == 100
    r2 = inputs.Reservoir(3, inputs.stream(3, "sample"))
    for i in range(100):
        r2.offer(i)
    assert r.items == r2.items
