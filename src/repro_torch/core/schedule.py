"""Schedules, the insertion-based list-scheduling core, and the validator.

All three schedulers (HEFT, CPOP, CEFT-CPOP) share one engine: a ready queue
ordered by a priority vector, and insertion-based earliest-finish-time placement
on processor *instances* (Topcuoglu et al. 2002 §3.1).  The engine takes a
``pin`` map (task -> instance) so CPOP can pin CP tasks to p_cp and CEFT-CPOP can
pin them to their CEFT-assigned classes.
"""
from __future__ import annotations

import dataclasses
import heapq
from bisect import insort
from typing import Callable

import numpy as np

from .machine import Machine
from .taskgraph import TaskGraph


@dataclasses.dataclass
class Schedule:
    proc: np.ndarray    # (v,) instance id per task
    start: np.ndarray   # (v,)
    finish: np.ndarray  # (v,)

    @property
    def makespan(self) -> float:
        return float(self.finish.max())


class Timeline:
    """Busy intervals per processor instance, with gap-insertion EFT search."""

    def __init__(self, n_proc: int):
        self.busy: list[list[tuple[float, float]]] = [[] for _ in range(n_proc)]

    def earliest_start(self, p: int, ready: float, dur: float) -> float:
        prev_end = 0.0
        for s, e in self.busy[p]:
            t = max(ready, prev_end)
            if t + dur <= s + 1e-12:
                return t
            prev_end = max(prev_end, e)
        return max(ready, prev_end)

    def insert(self, p: int, s: float, e: float) -> None:
        insort(self.busy[p], (s, e))


def list_schedule(
    g: TaskGraph,
    comp: np.ndarray,
    m: Machine,
    priority: np.ndarray,
    pin: dict[int, int] | None = None,
) -> Schedule:
    """Priority-driven insertion-based list scheduling on instances.

    At every step the highest-priority *ready* task is popped; it is placed on
    its pinned instance if pinned, else on the instance minimizing its EFT.
    """
    v = g.n
    pin = pin or {}
    ic = m.inst_class
    n_proc = m.n_proc
    tl = Timeline(n_proc)
    proc = np.full(v, -1, np.int64)
    start = np.zeros(v, np.float64)
    finish = np.zeros(v, np.float64)
    indeg = g.in_degree.copy()
    inv_bw = 1.0 / m.bw            # (P, P) class view
    heap: list[tuple[float, int]] = []
    for s in np.nonzero(indeg == 0)[0]:
        heapq.heappush(heap, (-float(priority[s]), int(s)))
    scheduled = 0
    while heap:
        _, t = heapq.heappop(heap)
        ps = g.parents(t)
        pd = g.parent_data(t)
        # vectorized over candidate processors: ready time per instance
        ready = np.zeros(n_proc)
        for k, d in zip(ps, pd):
            ck = int(ic[proc[k]])
            vec = m.L[ck] + d * inv_bw[ck, ic]
            vec[proc[k]] = 0.0  # same instance: no transfer
            np.maximum(ready, finish[k] + vec, out=ready)
        cand = (pin[t],) if t in pin else range(n_proc)
        dur = comp[t, ic]
        best_eft, best_p, best_st = np.inf, -1, 0.0
        for p in cand:
            st = tl.earliest_start(p, float(ready[p]), float(dur[p]))
            if st + dur[p] < best_eft - 1e-15:
                best_eft, best_p, best_st = st + float(dur[p]), p, st
        proc[t] = best_p
        start[t] = best_st
        finish[t] = best_eft
        tl.insert(best_p, best_st, best_eft)
        scheduled += 1
        for c in g.children(t):
            indeg[c] -= 1
            if indeg[c] == 0:
                heapq.heappush(heap, (-float(priority[c]), int(c)))
    if scheduled != v:
        raise RuntimeError("graph has a cycle or disconnected indegrees")
    return Schedule(proc, start, finish)


def validate_schedule(
    sched: Schedule, g: TaskGraph, comp: np.ndarray, m: Machine, tol: float = 1e-9
) -> None:
    """Raise AssertionError unless the schedule is legal: correct durations,
    precedence + communication respected, instances exclusive."""
    ic = m.inst_class
    v = g.n
    dur = comp[np.arange(v), ic[sched.proc]]
    assert np.allclose(sched.finish, sched.start + dur, atol=tol), "duration mismatch"
    assert (sched.start >= -tol).all(), "negative start"
    for i in range(v):
        for j, d in zip(g.children(i), g.child_data(i)):
            c = m.comm_inst(float(d), int(sched.proc[i]), int(sched.proc[j]))
            assert sched.start[j] + tol >= sched.finish[i] + c, (
                f"precedence violated on edge {i}->{j}"
            )
    for p in range(m.n_proc):
        ts = np.nonzero(sched.proc == p)[0]
        if ts.size < 2:
            continue
        order = ts[np.argsort(sched.start[ts])]
        ends = sched.finish[order][:-1]
        starts = sched.start[order][1:]
        assert (starts + tol >= ends).all(), f"overlap on processor {p}"


def sequential_time(comp: np.ndarray, m: Machine) -> float:
    """Numerator of speedup (eq. 8): all tasks on the single processor that
    minimizes total execution time."""
    return float(comp.sum(axis=0).min())
