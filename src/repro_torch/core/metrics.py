"""Comparison metrics (paper §7.3): makespan, speedup, SLR, slack."""
from __future__ import annotations

import numpy as np

from .ceft import min_comp_critical_path
from .machine import Machine
from .schedule import Schedule, sequential_time
from .taskgraph import TaskGraph


def speedup(sched: Schedule, comp: np.ndarray, m: Machine) -> float:
    """eq. 8: sequential time (best single processor for the whole graph)
    over makespan."""
    return sequential_time(comp, m) / sched.makespan


def slr(sched: Schedule, g: TaskGraph, comp: np.ndarray) -> float:
    """eq. 9: makespan normalized by the sum of minimum computation costs of
    the CP_MIN tasks (communication ignored) -- identical denominator for every
    algorithm, >= 1 for any valid schedule."""
    denom, _ = min_comp_critical_path(g, comp)
    return sched.makespan / denom


def slack(sched: Schedule, g: TaskGraph, comp: np.ndarray, m: Machine) -> float:
    """eq. 10: mean over tasks of M - b_level - t_level, computed with the
    *scheduled* assignment's execution and communication costs (robustness)."""
    ic = m.inst_class
    v = g.n
    w = comp[np.arange(v), ic[sched.proc]]
    t_level = np.zeros(v, np.float64)
    for i in range(v):
        for j, d in zip(g.children(i), g.child_data(i)):
            c = m.comm_inst(float(d), int(sched.proc[i]), int(sched.proc[j]))
            t_level[j] = max(t_level[j], t_level[i] + w[i] + c)
    b_level = np.zeros(v, np.float64)
    for i in range(v - 1, -1, -1):
        best = 0.0
        for j, d in zip(g.children(i), g.child_data(i)):
            c = m.comm_inst(float(d), int(sched.proc[i]), int(sched.proc[j]))
            best = max(best, c + b_level[j])
        b_level[i] = w[i] + best
    M = sched.makespan
    return float(np.mean(M - b_level - t_level))
