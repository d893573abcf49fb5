"""Real-world application DAGs (paper §7.2): Gaussian Elimination, FFT,
Molecular Dynamics, Epigenomics.  Structure only -- weights come from
``classic_workload`` / ``interval_workload`` (the paper re-weights these known
structures with varying CCR and beta)."""
from __future__ import annotations

import numpy as np

from ..core.taskgraph import TaskGraph, from_edges


def gaussian_elimination(m: int) -> TaskGraph:
    """GE task graph on an m x m matrix (Wu & Gajski; paper §7.2.2).

    (m-1) pivot tasks L_k and, per step k, update tasks U_{k,j} (j=k+1..m).
    Total (m^2 + m - 2)/2 tasks (m=5 -> 14, matching Fig. 3a).
    Edges: L_k -> U_{k,j}; U_{k,k+1} -> L_{k+1}; U_{k,j} -> U_{k+1,j} (j>k+1).
    """
    ids: dict[tuple, int] = {}
    nxt = 0

    def nid(key):
        nonlocal nxt
        if key not in ids:
            ids[key] = nxt
            nxt += 1
        return ids[key]

    edges = []
    for k in range(1, m):
        lk = nid(("L", k))
        for j in range(k + 1, m + 1):
            u = nid(("U", k, j))
            edges.append((lk, u, 1.0))
            if j == k + 1 and k + 1 < m:
                edges.append((u, nid(("L", k + 1)), 1.0))
            elif j > k + 1 and k + 1 < m:
                edges.append((u, nid(("U", k + 1, j)), 1.0))
    assert nxt == (m * m + m - 2) // 2
    return from_edges(nxt, edges, sort_topologically=True)


def fft_graph(m: int) -> TaskGraph:
    """FFT task graph on an m-point input (m a power of two; Fig. 3b).

    2m-1 recursive-call tasks (a binary tree) above the line, m*log2(m)
    butterfly tasks below; butterfly stage s pairs elements differing in one
    bit.  All source->sink paths have equal structure (every path is critical).
    """
    assert m >= 2 and (m & (m - 1)) == 0, "m must be a power of two"
    lg = int(np.log2(m))
    edges = []
    # recursion tree: node (d, i), d=0..lg, 2^d nodes per depth
    def rid(d, i):
        return (1 << d) - 1 + i

    for d in range(lg):
        for i in range(1 << d):
            edges.append((rid(d, i), rid(d + 1, 2 * i), 1.0))
            edges.append((rid(d, i), rid(d + 1, 2 * i + 1), 1.0))
    n_rec = 2 * m - 1
    # butterfly stages: stage s (1..lg), m tasks each
    def bid(s, i):
        return n_rec + (s - 1) * m + i

    for i in range(m):  # leaves feed stage 1
        for j in (i, i ^ (m >> 1)):
            edges.append((rid(lg, i), bid(1, j), 1.0))
    for s in range(1, lg):
        half = m >> (s + 1)
        for i in range(m):
            for j in (i, i ^ half):
                edges.append((bid(s, i), bid(s + 1, j), 1.0))
    n = n_rec + lg * m
    return from_edges(n, edges, sort_topologically=True)


def molecular_dynamics() -> TaskGraph:
    """The Kim & Browne modified molecular-dynamics DAG (paper Fig. 4,
    redrawn).  A fixed 41-task irregular graph; edges transcribed from the
    commonly reproduced figure (irregular fan-outs, depth 8)."""
    E = [
        (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6),
        (1, 7), (1, 8), (2, 8), (2, 9), (3, 9), (3, 10), (4, 10), (4, 11),
        (5, 11), (5, 12), (6, 12), (6, 13),
        (7, 14), (8, 14), (8, 15), (9, 15), (9, 16), (10, 16), (10, 17),
        (11, 17), (11, 18), (12, 18), (12, 19), (13, 19),
        (14, 20), (15, 20), (15, 21), (16, 21), (16, 22), (17, 22),
        (17, 23), (18, 23), (18, 24), (19, 24),
        (20, 25), (21, 25), (21, 26), (22, 26), (22, 27), (23, 27),
        (23, 28), (24, 28),
        (25, 29), (25, 30), (26, 30), (26, 31), (27, 31), (27, 32), (28, 32),
        (29, 33), (30, 33), (30, 34), (31, 34), (31, 35), (32, 35),
        (33, 36), (34, 36), (34, 37), (35, 37),
        (36, 38), (37, 38), (37, 39), (36, 39),
        (38, 40), (39, 40),
    ]
    return from_edges(41, [(a, b, 1.0) for a, b in E])


def epigenomics(B: int) -> TaskGraph:
    """Epigenomics workflow (USC Pegasus; paper §7.2.4): fastQSplit fans out to
    B parallel 4-stage chains (filterContams -> sol2sanger -> fast2bfq -> map),
    merged by mapMerge -> maqIndex -> pileup.  4B + 4 tasks; wide and shallow.
    """
    edges = []
    split = 0
    nxt = 1
    chain_ends = []
    for _ in range(B):
        prev = split
        for _stage in range(4):
            edges.append((prev, nxt, 1.0))
            prev = nxt
            nxt += 1
        chain_ends.append(prev)
    merge, index, pileup = nxt, nxt + 1, nxt + 2
    for e in chain_ends:
        edges.append((e, merge, 1.0))
    edges.append((merge, index, 1.0))
    edges.append((index, pileup, 1.0))
    return from_edges(pileup + 1, edges)


REALWORLD = {
    "GE": lambda size=8: gaussian_elimination(size),
    "FFT": lambda size=16: fft_graph(size),
    "MD": lambda size=None: molecular_dynamics(),
    "EW": lambda size=8: epigenomics(size),
}
