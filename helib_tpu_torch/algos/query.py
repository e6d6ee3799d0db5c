"""Encrypted database lookup: Database / QueryExpr / QueryBuilder.

helib_tpu.algos.query: HElib's partialMatch/query
(include/helib/query.h:85-780,
 include/helib/partialMatch.h:120-420): an encrypted database of column
vectors, a query AST (And/Or/Not over columns), compilation of the AST to a
weighted CNF — an AND of OR-clauses where each clause is evaluated as a
*linear* combination of per-column match indicators (depth-free) and the
clauses are combined with a log-depth product — plus contains/getScore
(HElib's Database::contains / getScore, partialMatch.h:305-400).

Compilation pipeline (HElib's QueryBuilder::build, query.h:391-404):
  expand_or  — AST -> AND-of-ORs over signed 1-based column labels
  tidy       — drop duplicate literals and tautological clauses
  build_weights — QueryType{Fs, mus, taus, contains_or}: per clause, the
               score is sum_j taus[j]*mask[j] + mu = number of satisfied
               literals; the final score is the product over clauses.
contains() maps a nonzero score back to the 0/1 indicator with a
Fermat-little-theorem power (HElib's partialMatch.h:381: power(p^r - 1)),
which requires the plaintext prime p to exceed the largest clause size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .eqtesting import map_to_01
from ..exceptions import InvalidArgument, LogicError


# -- query AST (HElib's query.h:85-265) ------------------------------------

class QueryExpr:
    def __and__(self, other):
        return And(self, other)

    def __or__(self, other):
        return Or(self, other)

    def __invert__(self):
        return Not(self)


class Col(QueryExpr):
    def __init__(self, index: int):
        self.index = index


class And(QueryExpr):
    def __init__(self, a, b):
        self.a, self.b = a, b


class Or(QueryExpr):
    def __init__(self, a, b):
        self.a, self.b = a, b


class Not(QueryExpr):
    def __init__(self, a):
        self.a = a


def make_query(index: int) -> Col:
    """HElib's makeQueryExpr (query.h:137)."""
    return Col(index)


def parse_query(s: str) -> QueryExpr:
    """Parse an infix query string with column numbers, AND, OR, NOT and
    parentheses (HElib's QueryBuilder::convertToPostFix, query.h:455-521,
    which accepts e.g. "0 AND (1 OR 2)")."""
    tokens = s.replace("(", " ( ").replace(")", " ) ").split()

    def parse_or(pos):
        node, pos = parse_and(pos)
        while pos < len(tokens) and tokens[pos] == "OR":
            rhs, pos = parse_and(pos + 1)
            node = Or(node, rhs)
        return node, pos

    def parse_and(pos):
        node, pos = parse_atom(pos)
        while pos < len(tokens) and tokens[pos] == "AND":
            rhs, pos = parse_atom(pos + 1)
            node = And(node, rhs)
        return node, pos

    def parse_atom(pos):
        if pos >= len(tokens):
            raise InvalidArgument("query ends with an operator")
        t = tokens[pos]
        if t == "NOT":
            node, pos = parse_atom(pos + 1)
            return Not(node), pos
        if t == "(":
            node, pos = parse_or(pos + 1)
            if pos >= len(tokens) or tokens[pos] != ")":
                raise InvalidArgument("unbalanced brackets in query")
            return node, pos + 1
        if not t.isdigit():
            raise InvalidArgument(f"not a column number: {t!r}")
        return Col(int(t)), pos + 1

    node, pos = parse_or(0)
    if pos != len(tokens):
        raise InvalidArgument(f"trailing tokens in query: {tokens[pos:]}")
    return node


# -- weighted-CNF compilation (HElib's QueryBuilder, query.h:363-745) -------

@dataclass
class QueryType:
    """HElib's QueryType (query.h:300-356)."""
    Fs: list          # per clause: column indices queried
    mus: list         # per clause: constant offset (= number of NOTs)
    taus: list        # per clause: weight per column (+1 literal, -1 negated)
    contains_or: bool


class QueryBuilder:
    """Compile a QueryExpr (or infix string) to a weighted CNF
    (HElib's QueryBuilder, query.h:363)."""

    def __init__(self, expr: QueryExpr | str):
        self.expr = parse_query(expr) if isinstance(expr, str) else expr

    # vecvec representation: list of clauses; each clause is a list of
    # signed 1-based labels, +(i+1) for column i, -(i+1) for NOT column i.
    def _expand_or(self, e) -> list[list[int]]:
        """AST -> AND of ORs (HElib's expandOr, query.h:545-604)."""
        if isinstance(e, Col):
            return [[e.index + 1]]
        if isinstance(e, And):
            return self._expand_or(e.a) + self._expand_or(e.b)
        if isinstance(e, Or):
            a, b = self._expand_or(e.a), self._expand_or(e.b)
            return [ci + cj for ci in a for cj in b]
        if isinstance(e, Not):
            return self._negate(self._expand_or(e.a))
        raise TypeError(type(e))

    @staticmethod
    def _negate(clauses: list[list[int]]) -> list[list[int]]:
        """De-Morgan of an AND-of-ORs (HElib's negate, query.h:677-705)."""
        out = [[]]
        for clause in clauses:
            out = [acc + [-lit] for acc in out for lit in clause]
        return out

    @staticmethod
    def _tidy(clauses: list[list[int]]) -> list[list[int]]:
        """Drop duplicate literals; a clause containing both a literal and
        its negation is a tautology and is dropped whole (HElib's tidy /
        tidyClause, query.h:612-745 — HElib instead strips the
        paired literals, which is not an equivalence; we keep the sound
        form)."""
        out = []
        for clause in clauses:
            seen: list[int] = []
            taut = False
            for lit in clause:
                if -lit in seen:
                    taut = True
                    break
                if lit not in seen:
                    seen.append(lit)
            if not taut and seen:
                out.append(seen)
        return out

    def build(self, columns: int) -> QueryType:
        """HElib's QueryBuilder::build (query.h:391-404)."""
        clauses = self._tidy(self._expand_or(self.expr))
        if not clauses:
            # tautology: HElib asserts non-empty; represent as a
            # single always-true clause (mu=1, no columns)
            return QueryType([[]], [1], [np.zeros(columns, np.int64)], False)
        Fs, mus, taus = [], [], []
        contains_or = False
        for clause in clauses:
            tau = np.zeros(columns, dtype=np.int64)
            mu = 0
            for lit in clause:
                idx = abs(lit) - 1
                if idx >= columns:
                    raise InvalidArgument(f"column {idx} out of range")
                if tau[idx] != 0:
                    raise LogicError("duplicate column in tidied clause")
                if lit < 0:
                    mu += 1
                    tau[idx] = -1
                else:
                    tau[idx] = 1
            contains_or = contains_or or len(clause) > 1
            Fs.append(list(range(columns)))
            mus.append(mu)
            taus.append(tau)
        return QueryType(Fs, mus, taus, contains_or)

    def remove_or(self):
        """Rewrite to use only AND/NOT: a OR b == NOT(NOT a AND NOT b)
        (HElib's removeOr, query.h:410-439)."""
        def rw(e):
            if isinstance(e, Col):
                return e
            if isinstance(e, And):
                return And(rw(e.a), rw(e.b))
            if isinstance(e, Not):
                return Not(rw(e.a))
            if isinstance(e, Or):
                return Not(And(Not(rw(e.a)), Not(rw(e.b))))
            raise TypeError(type(e))
        self.expr = rw(self.expr)
        return self


# -- database ----------------------------------------------------------------

class Database:
    """Columns of encrypted slot vectors; one DB record per slot
    (HElib's Database<TXT>, partialMatch.h:213)."""

    def __init__(self, ea, key, columns: list):
        self.ea = ea
        self.key = key
        self.columns = columns          # list of Ctxt (or Ptxt arrays)

    def _match_column(self, col_ct, query_ct):
        """Slot-wise equality indicator: 1 - mapTo01(col - query)
        (HElib's calculateMasks, partialMatch.h:100-126)."""
        diff = col_ct.copy().sub(query_ct)
        nz = map_to_01(self.ea, diff, self.key)          # 1 iff different
        one = nz.copy()
        one.mul_constant_poly(np.zeros(1, dtype=np.int64))
        one.add_constant_poly(np.ones(1, dtype=np.int64))
        return one.sub(nz)                              # 1 iff equal

    def _masks(self, query_cols: dict) -> dict:
        """Equality masks for every column referenced by the query, computed
        once and shared across clauses."""
        return {i: self._match_column(self.columns[i], q)
                for i, q in query_cols.items()}

    def get_score(self, query, query_cols: dict):
        """Product over clauses of (sum_j tau_j*mask_j + mu) — slot i holds a
        nonzero score iff record i satisfies the query (HElib's getScore +
        calculateScores, partialMatch.h:142-185,386-397).

        `query` may be a QueryType, QueryExpr, or infix string."""
        qt = self._as_query_type(query)
        masks = self._masks(query_cols)
        factors = []
        for mu, tau in zip(qt.mus, qt.taus):
            acc = None
            for idx in np.nonzero(tau)[0]:
                t = masks[int(idx)].copy()
                if tau[idx] != 1:
                    t.mul_constant_poly(np.array([int(tau[idx])],
                                                 dtype=np.int64))
                acc = t if acc is None else acc.add(t)
            if acc is None:
                acc = next(iter(masks.values())).copy()
                acc.mul_constant_poly(np.zeros(1, dtype=np.int64))
            if mu:
                acc.add_constant_poly(np.array([mu], dtype=np.int64))
            factors.append(acc)
        from ..utils import total_product
        return total_product(factors, self.key)

    def contains(self, query, query_cols: dict):
        """Indicator ciphertext: slot i is 1 iff record i matches (HElib's
        Database::contains, partialMatch.h:366-383).  When the compiled query
        has OR clauses the score may exceed 1; it is mapped back to 0/1 with
        the FLT power, which requires clause sizes < p.  For plaintext primes
        too small to hold a clause score (e.g. p=2) the query is instead
        evaluated exactly in AND/NOT form (the removeOr() rewrite,
        query.h:410-439)."""
        qt = self._as_query_type(query)
        max_clause = max((int(np.count_nonzero(t)) for t in qt.taus),
                         default=0)
        if qt.contains_or and self.ea.ctx.p <= max_clause:
            return self._contains_bool(qt, query_cols)
        score = self.get_score(qt, query_cols)
        if qt.contains_or:
            score = map_to_01(self.ea, score, self.key)
        return score

    def _contains_bool(self, qt: QueryType, query_cols: dict):
        """Exact boolean evaluation of the CNF: each clause as
        1 - prod(1 - literal), clauses combined by a product tree.  Deeper
        than the weighted form but correct for every plaintext space."""
        from ..utils import total_product
        masks = self._masks(query_cols)
        one_vec = np.ones(1, dtype=np.int64)
        clause_cts = []
        for tau in qt.taus:
            lit_false = []          # indicator that each literal is false
            for idx in np.nonzero(tau)[0]:
                if tau[idx] == 1:                       # literal = mask
                    t = masks[int(idx)].copy().negate()
                    t.add_constant_poly(one_vec)        # 1 - mask
                else:                                   # literal = NOT mask
                    t = masks[int(idx)].copy()
                lit_false.append(t)
            if not lit_false:
                continue
            prod = total_product(lit_false, self.key)    # all literals false
            clause = prod.negate()
            clause.add_constant_poly(one_vec)           # 1 - prod
            clause_cts.append(clause)
        if not clause_cts:
            one = next(iter(masks.values())).copy()
            one.mul_constant_poly(np.zeros(1, dtype=np.int64))
            one.add_constant_poly(one_vec)
            return one
        return total_product(clause_cts, self.key)

    def _as_query_type(self, query) -> QueryType:
        if isinstance(query, QueryType):
            return query
        return QueryBuilder(query).build(len(self.columns))
