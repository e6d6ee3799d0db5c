"""Bipartite matching / max-flow, host-side graph utilities
(helib_tpu.algos.matching).

HElib's matching (src/matching.cpp, include/helib/matching.h:42
`maximum_flow`): used to decompose a general permutation of a
non-rectangular hypercube into column permutations (HElib's
permutations.cpp breakPermByDim).
"""

from __future__ import annotations

from collections import deque
from ..exceptions import assert_true


def max_bipartite_matching(n_left: int, n_right: int,
                           edges: list[tuple[int, int]]) -> dict[int, int]:
    """Maximum matching via augmenting paths (Hopcroft-Karp-lite).
    Returns {left: right} for matched pairs."""
    adj: list[list[int]] = [[] for _ in range(n_left)]
    for u, v in edges:
        adj[u].append(v)
    match_l = [-1] * n_left
    match_r = [-1] * n_right

    def try_augment(u, seen):
        for v in adj[u]:
            if seen[v]:
                continue
            seen[v] = True
            if match_r[v] == -1 or try_augment(match_r[v], seen):
                match_l[u] = v
                match_r[v] = u
                return True
        return False

    for u in range(n_left):
        try_augment(u, [False] * n_right)
    return {u: v for u, v in enumerate(match_l) if v != -1}


def maximum_flow(n: int, source: int, sink: int,
                 capacities: dict[tuple[int, int], int]) -> tuple[int, dict]:
    """Edmonds-Karp max flow (HElib's maximum_flow, matching.h:42).
    Returns (flow_value, flow dict on edges)."""
    cap = dict(capacities)
    adj: list[set[int]] = [set() for _ in range(n)]
    for (u, v) in capacities:
        adj[u].add(v)
        adj[v].add(u)
        cap.setdefault((v, u), 0)
    flow = {e: 0 for e in cap}
    total = 0
    while True:
        # BFS for augmenting path
        parent = {source: source}
        dq = deque([source])
        while dq and sink not in parent:
            u = dq.popleft()
            for v in adj[u]:
                if v not in parent and cap[(u, v)] - flow[(u, v)] > 0:
                    parent[v] = u
                    dq.append(v)
        if sink not in parent:
            break
        # bottleneck
        path = []
        v = sink
        while v != source:
            u = parent[v]
            path.append((u, v))
            v = u
        aug = min(cap[e] - flow[e] for e in path)
        for (u, v) in path:
            flow[(u, v)] += aug
            flow[(v, u)] -= aug
        total += aug
    return total, {e: f for e, f in flow.items()
                   if f > 0 and capacities.get(e, 0) > 0}


def perm_to_column_perms(perm, rows: int, cols: int):
    """Decompose a permutation of a rows x cols grid into (col-perm,
    row-perm, col-perm) stages via repeated perfect matchings — the
    Birkhoff-von-Neumann-style routing behind HElib's breakPermByDim.

    Returns (pre, mid, post): pre/post permute within each column (length
    rows*cols arrays of target ROW per position), mid permutes within each
    row.  Guaranteed to exist by Hall's theorem."""
    import numpy as np
    n = rows * cols
    perm = np.asarray(perm)
    assert_true(len(perm) == n, 'invariant: len(perm) == n')
    # item at source cell s=(r,c) must reach dest cell d; build, for each of
    # `rows` rounds, a system of distinct representatives assigning one item
    # per source column to each dest column.
    remaining = [[] for _ in range(cols)]   # per source column: items (src, dst)
    for j in range(n):
        src = int(perm[j])
        remaining[src % cols].append((src, j))
    pre = np.arange(n)
    mid = np.arange(n)
    post = np.arange(n)
    for r in range(rows):
        # matching: source columns -> dest columns
        edges = []
        for c in range(cols):
            for (src, dst) in remaining[c]:
                edges.append((c, dst % cols))
        match = max_bipartite_matching(cols, cols, list(set(edges)))
        assert_true(len(match) == cols, "SDR must exist (Hall)")
        for c, dc in match.items():
            # pick one item in column c going to dest column dc
            k = next(i for i, (s, d) in enumerate(remaining[c])
                     if d % cols == dc)
            src, dst = remaining[c].pop(k)
            # route: within column c move src to row r (pre), across row r
            # move col c -> dc (mid), within column dc move row r to dest row
            pre[r * cols + c] = src
            mid[r * cols + dc] = r * cols + c
            post[dst] = r * cols + dc
    return pre, mid, post
