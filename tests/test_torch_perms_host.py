"""Port vs helib_tpu on the host: the cleartext algorithms behind the
permutation networks and the database query -- bipartite matching and
max-flow, Benes routing, the optimize_perms cost tables and dynamic
programs, the split trees optimal_upper picks, and a PermPrecomp's stages,
collapsed layers, needed_rotations() and apply_vector -- on the hypercubes
of m=31, 85, 255 and of HElib's binary-arithmetic size m=4095,
mvec=(7, 5, 9, 13) ([6, 4, 6], all native); and QueryBuilder's CNF and
parse_query.  No ciphertext: each case builds only a PAlgebra."""

import types

import numpy as np
import pytest
import torch

from helib_tpu.algos import benes as jbenes, matching as jmatch
from helib_tpu.algos import optimize_perms as jop, query as jq
from helib_tpu.algos import tablelookup as jtl
from helib_tpu.palgebra import PAlgebra as JPAlgebra

from helib_tpu_torch.algos import benes as tbenes, matching as tmatch
from helib_tpu_torch.algos import optimize_perms as top, query as tq
from helib_tpu_torch.algos import tablelookup as ttl
from helib_tpu_torch.palgebra import PAlgebra as TPAlgebra

torch.set_num_threads(1)

# (m, mvec, depth bounds to try, depth of the PermPrecomp checks)
CUBES = {31: (None, (2, 3, 4), 3), 85: (None, (3, 4, 5), 4),
         255: (None, (4, 6, 8), 6), 4095: ((7, 5, 9, 13), (5, 6, 8), 5)}


def _ea(pal_cls, m):
    """The two attributes optimize_perms reads of an EncryptedArray."""
    pal = pal_cls(m=m, p=2, mvec=CUBES[m][0])
    return types.SimpleNamespace(ctx=types.SimpleNamespace(pal=pal),
                                 nslots=pal.nslots)


def _tree(node):
    """A SplitNode as nested tuples, e-values included."""
    if node is None:
        return None
    return (node.order, node.good, node.mid, node.groups1, node.groups2,
            node.e, _tree(node.left), _tree(node.right))


# -- matching ----------------------------------------------------------------

def test_bipartite_matching_and_max_flow_equal_reference():
    rng = np.random.default_rng(5)
    for n in (3, 6, 10):
        edges = sorted({(int(u), int(v)) for u, v in
                        rng.integers(0, n, (3 * n, 2))})
        assert (tmatch.max_bipartite_matching(n, n, edges)
                == jmatch.max_bipartite_matching(n, n, edges))
        caps = {(int(u), int(v)): int(c) for u, v, c in
                zip(rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n),
                    rng.integers(1, 5, 4 * n)) if u != v}
        assert (tmatch.maximum_flow(n, 0, n - 1, caps)
                == jmatch.maximum_flow(n, 0, n - 1, caps))


@pytest.mark.parametrize("rows,cols", [(2, 3), (4, 4), (6, 24), (4, 6)])
def test_perm_to_column_perms_equal_reference(rows, cols):
    rng = np.random.default_rng(rows * 100 + cols)
    for _ in range(3):
        perm = rng.permutation(rows * cols)
        got = tmatch.perm_to_column_perms(perm, rows, cols)
        want = jmatch.perm_to_column_perms(perm, rows, cols)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        v = np.arange(rows * cols)
        np.testing.assert_array_equal(v[got[0]][got[1]][got[2]], v[perm])


# -- Benes routing -------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 5, 6, 13, 16, 33])
def test_benes_routing_equals_reference(n):
    rng = np.random.default_rng(n)
    for _ in range(3):
        perm = rng.permutation(n)
        t, j = tbenes.BenesNetwork(perm), jbenes.BenesNetwork(perm)
        assert len(t.levels) == len(j.levels)
        for lt, lj in zip(t.levels, j.levels):
            assert lt.keys() == lj.keys()
            for d in lt:
                np.testing.assert_array_equal(lt[d], lj[d])
        v = np.arange(100, 100 + n)
        np.testing.assert_array_equal(t.apply_vector(v), v[perm])


# -- the optimizer's tables and dynamic programs -------------------------------

@pytest.mark.parametrize("n", [2, 4, 6, 12, 13, 20, 30])
def test_cost_tables_and_optimal_benes_equal_reference(n):
    assert top.benes_level_deltas(n) == jop.benes_level_deltas(n)
    for good in (False, True):
        assert top.build_cost_table(n, good) == jop.build_cost_table(n, good)
        for budget in range(0, 2 * top.benes_depth(n) + 1):
            assert (top.optimal_benes(n, budget, good)
                    == jop.optimal_benes(n, budget, good))


@pytest.mark.parametrize("order,good", [(6, True), (4, True), (12, True),
                                        (12, False), (30, True), (20, False)])
def test_optimal_lower_trees_equal_reference(order, good):
    tm, jm = {}, {}
    for budget in range(1, 7):
        for mid in (0, 1):
            ct, st = top.optimal_lower(order, good, budget, mid, tm)
            cj, sj = jop.optimal_lower(order, good, budget, mid, jm)
            assert ct == cj
            assert _tree(st) == _tree(sj)
            if st is not None and mid == 1:
                st, sj = st.clone(), sj.clone()
                top.compute_e_values(st, order)
                jop.compute_e_values(sj, order)
                assert _tree(st) == _tree(sj)
                for x in range(order):
                    assert top.coord_split(st, x) == jop.coord_split(sj, x)


@pytest.mark.parametrize("m", sorted(CUBES))
def test_optimal_upper_and_indep_precomp_equal_reference(m):
    tea, jea = _ea(TPAlgebra, m), _ea(JPAlgebra, m)
    pal = tea.ctx.pal
    gens = [(o, bool(g)) for o, g in zip(pal.orders, pal.native)]
    for bound in CUBES[m][1]:
        ct, tt = top.optimal_upper(gens, bound)
        cj, tj = jop.optimal_upper(gens, bound)
        assert ct == cj
        assert [_tree(x) for x in tt] == [_tree(x) for x in tj]
        tp, jp = top.PermIndepPrecomp(tea, bound), jop.PermIndepPrecomp(
            jea, bound)
        assert (tp.get_cost(), tp.depth, tp.orders, tp.native) == (
            jp.get_cost(), jp.depth, jp.orders, jp.native)
        assert tp.depth <= bound
        assert ([(d, _tree(leaf)) for d, leaf in tp.expanded]
                == [(d, _tree(leaf)) for d, leaf in jp.expanded])


def test_no_network_below_depth_5_at_m4095():
    """[6, 4, 6] has no network within depth 4 in either package; at 5 it
    costs 21 rotations."""
    tea, jea = _ea(TPAlgebra, 4095), _ea(JPAlgebra, 4095)
    assert tea.ctx.pal.orders == [6, 4, 6] and all(tea.ctx.pal.native)
    for mod, ea in ((top, tea), (jop, jea)):
        with pytest.raises(ValueError):
            mod.PermIndepPrecomp(ea, 4)
        pip = mod.PermIndepPrecomp(ea, 5)
        assert (pip.get_cost(), pip.depth) == (21, 5)


@pytest.mark.parametrize("m", sorted(CUBES))
def test_perm_precomp_equals_reference(m):
    """Stages, each stage's collapsed layers, rotations() and
    needed_rotations() equal helib_tpu's; apply_vector routes v to
    v[perm]."""
    tea, jea = _ea(TPAlgebra, m), _ea(JPAlgebra, m)
    depth = CUBES[m][2]
    tpip, jpip = top.PermIndepPrecomp(tea, depth), jop.PermIndepPrecomp(
        jea, depth)
    rng = np.random.default_rng(1)
    for _ in range(2):
        perm = rng.permutation(tea.nslots)
        tp, jp = top.PermPrecomp(tpip, perm), jop.PermPrecomp(jpip, perm)
        np.testing.assert_array_equal(tp.flat, jp.flat)
        assert len(tp.stages) == len(jp.stages)
        occ = {}
        for (te, tc), (je, jc) in zip(tp.stages, jp.stages):
            assert te == je
            np.testing.assert_array_equal(tc, jc)
            o = occ.get(te, 0)
            occ[te] = o + 1
            leaf = tpip.expanded[te][1]
            groups = leaf.groups1 if (leaf.mid or o == 0) else leaf.groups2
            tl = tp._colperm_layers(te, tc, groups)
            jl = jp._colperm_layers(je, jc, groups)
            assert [sorted(x) for x in tl] == [sorted(x) for x in jl]
            for a, b in zip(tl, jl):
                for dsp in a:
                    np.testing.assert_array_equal(a[dsp], b[dsp])
        assert tp.rotations() == jp.rotations() <= tpip.get_cost()
        assert tp.needed_rotations() == jp.needed_rotations()
        v = np.arange(1000, 1000 + tea.nslots)
        np.testing.assert_array_equal(tp.apply_vector(v), v[perm])
        np.testing.assert_array_equal(jp.apply_vector(v), v[perm])


def test_m4095_network_of_default_rng_1():
    """The network test_torch_cuda.py drives: depth 5, a default_rng(1)
    permutation of the 144 slots, 21 rotations through 13 distinct
    (dimension, amount) pairs."""
    pip = top.PermIndepPrecomp(_ea(TPAlgebra, 4095), 5)
    perm = np.random.default_rng(1).permutation(144)
    pp = top.PermPrecomp(pip, perm)
    assert (pip.depth, pp.rotations(), len(pp.needed_rotations())) == (
        5, 21, 13)


# -- the query compiler ---------------------------------------------------------

QUERIES = ["0 AND 1", "0 OR NOT 1", "(0 AND 1) OR 2", "NOT (0 AND 1)",
           "(0 OR NOT 0) AND 1", "(0 OR 1) AND (NOT 2 OR 0)",
           "NOT (0 OR (1 AND NOT 2))", "((0))"]


def _ast(e):
    kind = type(e).__name__
    if kind == "Col":
        return (kind, e.index)
    return (kind,) + tuple(_ast(getattr(e, k)) for k in ("a", "b")
                           if hasattr(e, k))


@pytest.mark.parametrize("text", QUERIES)
def test_parse_query_and_cnf_equal_reference(text):
    assert _ast(tq.parse_query(text)) == _ast(jq.parse_query(text))
    tb, jb = tq.QueryBuilder(text), jq.QueryBuilder(text)
    tt, jt = tb.build(3), jb.build(3)
    assert (tt.Fs, tt.mus, tt.contains_or) == (jt.Fs, jt.mus,
                                               jt.contains_or)
    assert [list(x) for x in tt.taus] == [list(x) for x in jt.taus]
    assert _ast(tb.remove_or().expr) == _ast(jb.remove_or().expr)
    assert "Or" not in repr(_ast(tb.expr))


def test_query_operators_and_errors_equal_reference():
    e = (tq.make_query(0) | ~tq.make_query(1)) & tq.make_query(2)
    j = (jq.make_query(0) | ~jq.make_query(1)) & jq.make_query(2)
    assert _ast(e) == _ast(j)
    for bad in ("0 AND", "(0 OR 1", "0 1", "x AND 1"):
        with pytest.raises(tq.InvalidArgument):
            tq.parse_query(bad)
        with pytest.raises(jq.InvalidArgument):
            jq.parse_query(bad)
    with pytest.raises(tq.InvalidArgument):
        tq.QueryBuilder("0 AND 3").build(3)


def test_build_lookup_table_equals_reference():
    for f, k, r in ((lambda i: i * i + 1, 4, 16), (lambda i: 3 * i, 3, 5)):
        assert ttl.build_lookup_table(f, k, r) == jtl.build_lookup_table(
            f, k, r)
