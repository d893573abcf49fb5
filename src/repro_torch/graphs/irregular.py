"""Irregular fan-in/fan-out DAG structures (benchmark shapes).

These are the shapes where the padded dense level tables degrade worst: the
(n_levels, Wmax, Dmax) padding is driven by the single widest level and the
single largest in-degree, so a star fan-in pads every task to in-degree n-1
and a heavy-tailed in-degree distribution pads the mean task to the tail.
The CSR sweep does O(e·P²) work regardless.
"""
from __future__ import annotations

import numpy as np

from ..core.taskgraph import TaskGraph, from_edge_arrays


def star_fan_in(n: int, data: float = 1.0) -> TaskGraph:
    """n-1 independent sources all feeding one sink: e = n-1, Dmax = n-1."""
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.full(n - 1, n - 1, np.int32)
    return from_edge_arrays(n, src, dst, np.full(n - 1, data))


def heavy_tail_fan_in(
    n: int, rng: np.random.Generator, *, tail: float = 1.0, data: float = 1.0
) -> TaskGraph:
    """Pareto(tail)-distributed in-degrees: most tasks have a few parents, a
    few tasks have hundreds (in-degree max >> mean, the re-planning-loop DAG
    shape from sched/straggler).  Connected by construction (every non-root
    vertex draws >= 1 parent among earlier ids)."""
    srcs: list[np.ndarray] = []
    dsts: list[np.ndarray] = []
    k = np.minimum(np.arange(n), 1 + rng.pareto(tail, size=n).astype(np.int64))
    for j in range(1, n):
        ps = rng.choice(j, size=int(k[j]), replace=False)
        srcs.append(ps)
        dsts.append(np.full(ps.shape[0], j, np.int64))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    return from_edge_arrays(n, src, dst, np.full(src.shape[0], data))
