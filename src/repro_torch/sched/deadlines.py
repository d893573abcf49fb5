"""Backward deadline propagation over a planned CEFT schedule.

The paper's plan is deliberately *partial*: CEFT assigns processor classes
only to the critical path, and the mutual-inclusivity claim is about that
path being consistent with its own partial schedule.  Serving needs the
complement.  Once every task is bound to a class — path tasks to the path's
own partial assignment, off-path tasks to their earliest-finish class, the
same completion rule ``Router._choose`` dispatches with — the plan implies a
full schedule, and a request SLO can be walked *backward* through it: every
task gets a latest start/finish such that the request can still meet its
deadline, and ``latest_start - planned_start`` is the task's **slack**, the
quantity the router spends deliberately (shed the most-slack work off a
degraded engine first; arm watchdog budgets from latest-finish instead of a
flat multiple of the planned span — the multi-criteria latency/throughput
trade of Benoit, Rehn-Sonigo & Robert run per-tick).

Both passes are classic CPM over the *mapped scalar graph*: fix the class
map ``a(t)``, weight each task ``w(t) = comp[t, a(t)]`` and each edge
``comm(data, a(parent), a(child))`` (zero when co-located, exactly the
DP's own comm rule), then

    planned_start(t) = max over parents k of planned_finish(k) + comm(k, t)
    latest_finish(t) = min over children c of latest_start(c) - comm(t, c)

with ``latest_finish(sink) = slo`` (default: the mapped makespan).

Consistency with the CEFT plan (the properties tests/test_deadlines.py
checks over the graph zoo, and
``tests/test_torch_serve.py`` holds this copy to):

* ``planned_finish(t) >= ceft[t, a(t)]`` for every task (induction: the DP's
  min over a parent's classes is never above the mapped parent's own class),
  hence ``makespan >= res.cpl``.
* With ``slo = makespan``, ``slack >= 0`` everywhere and the zero-slack set
  is exactly the mapped schedule's critical path (CPM duality).
* Whenever ``makespan == res.cpl`` — i.e. the partial schedule extends to a
  full one without any off-path parent pushing a path task — every task on
  ``res.path`` has zero slack: the paper's critical path IS the zero-slack
  chain.  A strictly larger makespan is the interesting diagnostic case: the
  *partial* schedule was self-consistent but binding the off-path tasks
  lengthened some other chain past it, and the propagation reports slack
  relative to what will actually run, not what the DP priced.

Latest times are affine in the horizon: ``latest_*(slo') = latest_*(slo) +
(slo' - slo)`` when every sink shares the horizon.  Callers with a cached
schedule therefore shift by ``rem - makespan`` (remaining SLO budget minus
the planned makespan) instead of re-propagating — ``Router._deadline_view``
memoizes one propagation per plan entry under ``PlanEntry.derived`` and the
watchdog budgets are the shifted latest-finish values.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.ceft import CeftResult
from ..core.machine import Machine
from ..core.taskgraph import TaskGraph


def plan_classes(res: CeftResult) -> np.ndarray:
    """Per-task class under the plan: critical-path tasks keep the path's own
    partial assignment, every other task takes its earliest-finish class
    (argmin of its DP row — the same rule the router's dispatch uses before
    load balancing)."""
    cls = np.argmin(res.ceft, axis=1).astype(np.int64)
    for t, p in res.assignment.items():
        cls[t] = p
    return cls


@dataclasses.dataclass(frozen=True)
class DeadlineSchedule:
    """Forward + backward CPM pass over the mapped scalar graph.

    All times are seconds on the plan's own clock (tick start = 0); absolute
    deadlines are obtained by shifting — see :meth:`latest_finish_for`.
    """
    classes: np.ndarray         # (v,) mapped class per task
    planned_start: np.ndarray   # (v,) earliest start under the mapping
    planned_finish: np.ndarray  # (v,) planned_start + mapped comp
    latest_start: np.ndarray    # (v,) latest start still meeting the slo
    latest_finish: np.ndarray   # (v,) latest_start + mapped comp
    slack: np.ndarray           # (v,) latest_start - planned_start
    makespan: float             # mapped-schedule makespan (max planned_finish)
    cpl: float                  # the CEFT plan's critical-path length
    slo: float                  # the horizon the backward pass used

    @property
    def feasible(self) -> bool:
        """True when the planned schedule meets the slo (no negative slack)."""
        return bool((self.slack >= -1e-9 * max(1.0, abs(self.slo))).all())

    def critical(self, eps: float = 1e-9) -> np.ndarray:
        """Zero-slack mask — the mapped schedule's critical path."""
        return self.slack <= eps * max(1.0, abs(self.makespan))

    def latest_finish_for(self, task: int, remaining: float) -> float:
        """Latest finish (seconds from now) for ``task`` when its request has
        ``remaining`` seconds of SLO budget left: the affine shift
        ``latest_finish + (remaining - slo)``, no re-propagation needed."""
        return float(self.latest_finish[task]) + (float(remaining) - self.slo)


def propagate_deadlines(g: TaskGraph, comp: np.ndarray, m: Machine,
                        res: CeftResult, *, slo: float | None = None,
                        sink_slos: dict[int, float] | None = None,
                        ) -> DeadlineSchedule:
    """Walk the CEFT schedule forward then backward on its mapped classes.

    ``slo`` is the latest-finish horizon handed to every sink (default: the
    mapped makespan, which makes ``slack`` the schedule's intrinsic slack);
    ``sink_slos`` overrides it per vertex (min-combined when a vertex gets
    both) — the router uses this for per-class decode deadlines.  Vertex ids
    must be a topological order (every TaskGraph guarantees this)."""
    v = g.n
    cls = plan_classes(res)
    if comp.shape[0] != v:
        raise ValueError(f"comp has {comp.shape[0]} rows for {v} tasks")
    w = np.asarray(comp, np.float64)[np.arange(v), cls]

    ps = np.zeros(v, np.float64)
    for t in range(v):
        parents = g.parents(t)
        if parents.size:
            pk = cls[parents]
            comm = np.where(pk == cls[t], 0.0,
                            m.L[pk] + g.parent_data(t) / m.bw[pk, cls[t]])
            ps[t] = float(np.max(ps[parents] + w[parents] + comm))
    pf = ps + w
    makespan = float(pf[g.sinks].max()) if v else 0.0

    horizon = makespan if slo is None else float(slo)
    lf = np.full(v, np.inf)
    lf[g.sinks] = horizon
    if sink_slos:
        for t, d in sink_slos.items():
            lf[int(t)] = min(lf[int(t)], float(d))
    for t in reversed(range(v)):
        children = g.children(t)
        if children.size:
            ck = cls[children]
            comm = np.where(ck == cls[t], 0.0,
                            m.L[cls[t]] + g.child_data(t) / m.bw[cls[t], ck])
            lf[t] = min(lf[t], float(np.min(lf[children] - w[children] - comm)))
    ls = lf - w

    return DeadlineSchedule(
        classes=cls, planned_start=ps, planned_finish=pf,
        latest_start=ls, latest_finish=lf, slack=ls - ps,
        makespan=makespan, cpl=float(res.cpl), slo=horizon)
