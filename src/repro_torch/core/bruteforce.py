"""Exponential-time oracles used only in tests (small graphs).

CEFT's semantics (paper §4/§4.1): under task duplication, the critical path is
the source->sink path maximizing its *chain-optimal* cost, where the chain cost
of a path is minimized over all assignments of its tasks to classes (exact by
DP over the processor state along the chain).  The oracle enumerates every path
and runs the exact chain DP, giving:

    bf = max_{paths pi} min_{assignments} cost(pi)

Invariant (proved by induction on the recurrence): CEFT_cpl >= bf, with equality
in the common case (the recurrence computes min_l max_pi >= max_pi min_l).
"""
from __future__ import annotations

import numpy as np

from .machine import Machine
from .taskgraph import TaskGraph


def all_paths(g: TaskGraph) -> list[list[int]]:
    out: list[list[int]] = []
    stack: list[list[int]] = [[int(s)] for s in g.sources]
    while stack:
        p = stack.pop()
        ch = g.children(p[-1])
        if ch.size == 0:
            out.append(p)
        else:
            for c in ch:
                stack.append(p + [int(c)])
    return out


def chain_optimal_cost(path: list[int], g: TaskGraph, comp: np.ndarray, m: Machine) -> float:
    """Exact min over assignments of the chain cost (DP over the class of the
    current task -- optimal because a chain's cost is Markov in that class)."""
    P = comp.shape[1]
    dp = comp[path[0], :].astype(np.float64).copy()
    for a, b in zip(path[:-1], path[1:]):
        ps = g.parents(b)
        data = float(g.parent_data(b)[np.nonzero(ps == a)[0][0]])
        comm = (m.L[:, None] + data / m.bw) * (~np.eye(P, dtype=bool))
        dp = comp[b, :] + (dp[:, None] + comm).min(axis=0)
    return float(dp.min())


def bruteforce_cpl(g: TaskGraph, comp: np.ndarray, m: Machine) -> float:
    """max over all source->sink paths of the chain-optimal cost."""
    return max(chain_optimal_cost(p, g, comp, m) for p in all_paths(g))
