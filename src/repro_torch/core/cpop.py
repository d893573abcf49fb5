"""CPOP (Algorithm 2, Topcuoglu et al. 2002) and CEFT-CPOP (paper §6).

CPOP computes rank_u + rank_d priorities from *mean* costs, walks the
same-priority chain from the entry task to get SET_CP, pins the whole set to the
single processor minimizing the set's total execution time, and list-schedules
by priority with insertion-based EFT for the rest.

CEFT-CPOP replaces lines 2-13: SET_CP is the CEFT critical path *with its
partial assignment* -- each CP task is pinned to an instance of its CEFT-chosen
class (consecutive same-class CP tasks share one instance, realizing the zero
co-location cost the DP assumed).  Everything else is unchanged, so makespan
differences isolate the quality of the critical path (paper §6).
"""
from __future__ import annotations

import numpy as np

from .ceft import CeftResult, ceft
from .machine import Machine
from .ranks import rank_d, rank_u
from .schedule import Schedule, list_schedule
from .taskgraph import TaskGraph


def _cpop_cp_set(g: TaskGraph, priority: np.ndarray) -> list[int]:
    """Walk from the max-priority entry following max-priority children
    (equal to |CP| in exact arithmetic; max is the float-robust form)."""
    srcs = g.sources
    t = int(srcs[np.argmax(priority[srcs])])
    cp = [t]
    while g.children(t).size:
        ch = g.children(t)
        t = int(ch[np.argmax(priority[ch])])
        cp.append(t)
    return cp


def cpop(g: TaskGraph, comp: np.ndarray, m: Machine) -> Schedule:
    pri = rank_u(g, comp, m) + rank_d(g, comp, m)
    cp = _cpop_cp_set(g, pri)
    ic = m.inst_class
    # p_cp: instance minimizing total CP computation (line 13)
    totals = comp[cp, :].sum(axis=0)          # per class
    p_cp = int(np.nonzero(ic == int(np.argmin(totals)))[0][0])
    pin = {t: p_cp for t in cp}
    return list_schedule(g, comp, m, priority=pri, pin=pin)


def cpop_cpl(g: TaskGraph, comp: np.ndarray, m: Machine) -> float:
    """The length of CPOP's critical path *under its partial schedule* -- the
    quantity Table 3 compares against CEFT's CPL.  CPOP maps its (mean-value)
    CP onto the single processor minimizing the set's total computation, which
    zeroes intra-path communication, so the realized length is

        min_p  sum_{t in SET_CP} C_comp(t, p).

    (The mean-value estimate |CP| = rank_u + rank_d of the entry task is
    exposed separately as ``cpop_cp_estimate``.)"""
    pri = rank_u(g, comp, m) + rank_d(g, comp, m)
    cp = _cpop_cp_set(g, pri)
    return float(comp[cp, :].sum(axis=0).min())


def cpop_cp_estimate(g: TaskGraph, comp: np.ndarray, m: Machine) -> float:
    """|CP| as Algorithm 2 line 6 estimates it (mean-value entry priority)."""
    pri = rank_u(g, comp, m) + rank_d(g, comp, m)
    return float(pri[g.sources].max())


def ceft_cpop(
    g: TaskGraph, comp: np.ndarray, m: Machine, ceft_result: CeftResult | None = None
) -> Schedule:
    res = ceft_result if ceft_result is not None else ceft(g, comp, m)
    pri = rank_u(g, comp, m) + rank_d(g, comp, m)
    ic = m.inst_class
    first_inst = {c: int(np.nonzero(ic == c)[0][0]) for c in range(m.P)}
    pin = {t: first_inst[p] for t, p in res.path}
    return list_schedule(g, comp, m, priority=pri, pin=pin)
