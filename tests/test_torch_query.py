"""Port vs helib_tpu, encrypted, on the host CPU: equality testing
(map_to_01, incremental_zero_test) and the encrypted database query --
Database.contains on an AND, on an OR with a NOT (the exact boolean branch
at p=2) and on an OR of an AND, and get_score -- at m=31, p=2, bits=500,
c=3, and the weighted-CNF branch at m=31, p=5, bits=600 (as
tests/test_apps.py runs both).  Each package runs the same seeded keys and
encryptions; every output ciphertext must be equal residue for residue and
decrypt to the numpy oracle."""

import types

import numpy as np
import pytest
import torch

from helib_tpu.algos import eqtesting as jeq, query as jq
from helib_tpu.context import Context as JContext
from helib_tpu.ea import EncryptedArray as JEA
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.ops import ntt as jntt

from helib_tpu_torch.algos import eqtesting as teq, query as tq
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ea import EncryptedArray as TEA
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.ops.modops import to_host

torch.set_num_threads(1)

JAX = types.SimpleNamespace(Context=JContext, EA=JEA, SecKey=JSecKey,
                            PubKey=JPubKey, eq=jeq, q=jq, kw={})
PORT = types.SimpleNamespace(Context=TContext, EA=TEA, SecKey=TSecKey,
                             PubKey=TPubKey, eq=teq, q=tq,
                             kw={"device": "cpu"})

P2 = dict(m=31, p=2, r=1, bits=500, c=3)
P5 = dict(m=31, p=5, r=1, bits=600, c=3)
QUERIES_P2 = {"and": "0 AND 1", "or_not": "0 OR NOT 1",
              "or_of_and": "(0 AND 1) OR 2"}


def _db(pkg, params, seed, values):
    """Context, keys, EA, the three encrypted columns and query values."""
    ctx = pkg.Context(**params, **pkg.kw)
    sk = pkg.SecKey(ctx, seed=seed)
    pk = pkg.PubKey(sk)
    ea = pkg.EA(ctx)
    rng = np.random.default_rng(seed + 2)
    n = ea.nslots
    cols = [rng.integers(0, values, n) for _ in range(3)]
    qv = [int(v) for v in rng.integers(0, values, 3)]
    db = pkg.q.Database(ea, sk, [ea.encrypt(list(c), pk, rng)
                                 for c in cols])
    qc = {i: ea.encrypt([qv[i]] * n, pk, rng) for i in range(3)}
    return ctx, sk, pk, ea, rng, db, qc, cols, qv


def _run_p2(pkg):
    ctx, sk, pk, ea, rng, db, qc, cols, qv = _db(pkg, P2, 71, 2)
    out = {name: db.contains(text, qc)
           for name, text in QUERIES_P2.items()}
    out["score_and"] = db.get_score("0 AND 1", qc)
    bits = [ea.encrypt(list(rng.integers(0, 2, ea.nslots)), pk, rng)
            for _ in range(3)]
    out["map_to_01"] = pkg.eq.map_to_01(ea, db.columns[0].copy().sub(qc[0]),
                                        sk)
    zt = pkg.eq.incremental_zero_test(ea, bits, sk)
    for i, ct in enumerate(zt):
        out[f"zero_test{i}"] = ct
    return out, (sk, ea, cols, qv, [ea.decrypt_ints(b, sk) for b in bits])


def _run_p5(pkg):
    ctx, sk, pk, ea, rng, db, qc, cols, qv = _db(pkg, P5, 101, 3)
    expr = (pkg.q.make_query(0) | ~pkg.q.make_query(1)) & pkg.q.make_query(2)
    qt = pkg.q.QueryBuilder(expr).build(3)
    assert qt.contains_or and ctx.p > 2
    out = {"weighted": db.contains(qt, qc), "score": db.get_score(qt, qc)}
    return out, (sk, ea, cols, qv)


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jntt, "USE_PALLAS", False)
        j2, _ = _run_p2(JAX)
        j5, _ = _run_p5(JAX)
    t2, held2 = _run_p2(PORT)
    t5, held5 = _run_p5(PORT)
    return {**j2, **j5}, {**t2, **t5}, held2, held5


def _same(j, t):
    """Equal residues, handles and noise metadata."""
    assert (t.k, t.special, t.ptxt_space, t.intFactor) == (
        j.k, j.special, j.ptxt_space, j.intFactor)
    assert abs(t.noise - j.noise) <= 1e-9
    assert [(h.powS, h.powX, h.keyID) for h, _ in t.parts] == [
        (h.powS, h.powX, h.keyID) for h, _ in j.parts]
    for (_, x), (_, y) in zip(t.parts, j.parts):
        np.testing.assert_array_equal(to_host(x), np.asarray(y))


NAMES = ["and", "or_not", "or_of_and", "score_and", "map_to_01",
         "zero_test0", "zero_test1", "zero_test2", "weighted", "score"]


@pytest.mark.parametrize("name", NAMES)
def test_query_residues_equal_reference(runs, name):
    jout, tout, _, _ = runs
    _same(jout[name], tout[name])


@pytest.mark.parametrize("name", NAMES)
def test_query_decrypts_to_oracle(runs, name):
    _, tout, held2, held5 = runs
    sk, ea, cols, qv = (held5 if name in ("weighted", "score")
                        else held2)[:4]
    m = [(c == v).astype(np.int64) for c, v in zip(cols, qv)]
    if name.startswith("zero_test"):
        bits = held2[4]
        i = int(name[-1])
        want = np.prod([1 - b for b in bits[:i + 1]], axis=0)
    else:
        want = {"and": m[0] & m[1], "or_not": m[0] | (1 - m[1]),
                "or_of_and": (m[0] & m[1]) | m[2], "score_and": m[0] * m[1],
                "map_to_01": 1 - m[0],
                "weighted": (m[0] | (1 - m[1])) & m[2],
                "score": (m[0] + (1 - m[1])) * m[2] % 5}[name]
    np.testing.assert_array_equal(ea.decrypt_ints(tout[name], sk), want)


def test_p2_or_queries_take_the_boolean_branch():
    """At p=2 a clause of two literals cannot hold its score: contains()
    evaluates such a CNF exactly through _contains_bool, and the AND through
    the weighted score."""
    for name, text in QUERIES_P2.items():
        qt = tq.QueryBuilder(text).build(3)
        widest = max(int(np.count_nonzero(t)) for t in qt.taus)
        assert (qt.contains_or and widest >= 2) == (name != "and")
