"""Planner registry: every scheduler behind one name-keyed signature.

The serving stack used to hard-wire ``ceft_cpop``; the baselines in
``heft.py``/``cpop.py``/``bruteforce.py`` never touched the router, the plan
cache, or the bench trajectory.  This module makes the planner a first-class
*value*: a :class:`Plan` result type that carries both the realized schedule
(instance/start/finish, like :class:`~.schedule.Schedule`) and the planner's
critical-path view (cpl, path tasks + classes, a per-class finish surface,
like :class:`~.ceft.CeftResult`), plus a registry mapping planner names to
builders with the single signature

    plan(name, g, comp, m, ceft_result=None) -> Plan

Consumers downstream (``sched/plancache.py``, ``sched/straggler.py``,
``serve/router.py``, ``sched/partitioner.py``) select planners by name only
and never import the scheduler functions directly.

Duck-typing contract (what lets a Plan drop in anywhere):

* ``proc``/``start``/``finish``/``makespan`` — a valid :class:`Schedule`
  (``validate_schedule`` accepts every registered planner's Plan; property-
  tested over the graph zoo in ``tests/test_planners.py``).
* ``ceft``/``path``/``assignment``/``cpl`` — the :class:`CeftResult` surface
  ``Router._choose`` and ``sched/deadlines.py`` consume.  For list-scheduling
  planners ``ceft[t, c] = start[t] + comp[t, c]`` (the planned per-class
  finish given the realized start) and the path is the planner's own
  critical-path notion: CEFT's mapped path for ``ceft_cpop``, the mean-cost
  CPOP walk for ``cpop``, the averaging-based longest path for the HEFT
  family, and the exact chain-optimal path for the brute-force oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .bruteforce import all_paths, chain_optimal_cost
from .ceft import CeftResult, averaged_critical_path, ceft
from .cpop import _cpop_cp_set, ceft_cpop, cpop
from .heft import ceft_heft_down, ceft_heft_up, heft, heft_down
from .machine import Machine
from .ranks import rank_d, rank_u
from .schedule import Schedule, list_schedule
from .taskgraph import TaskGraph

# Brute force enumerates every source->sink path; refuse unbounded blowup.
_BRUTEFORCE_PATH_CAP = 20_000


@dataclasses.dataclass
class Plan:
    """A realized schedule plus the planner's critical-path view."""

    planner: str
    proc: np.ndarray        # (v,) instance id per task
    start: np.ndarray       # (v,)
    finish: np.ndarray      # (v,)
    eft: np.ndarray         # (v, P) per-class finish surface (CEFT's DP array
                            # for ceft_cpop; start + comp for list planners)
    cpl: float              # the planner's critical-path length
    cp_tasks: tuple[int, ...]    # critical-path vertices, entry -> exit
    cp_classes: tuple[int, ...]  # their processor classes under the plan

    @property
    def makespan(self) -> float:
        return float(self.finish.max())

    # ---------------------------------------------- CeftResult-shaped surface
    @property
    def ceft(self) -> np.ndarray:
        return self.eft

    @property
    def path(self) -> list[tuple[int, int]]:
        return list(zip(self.cp_tasks, self.cp_classes))

    @property
    def assignment(self) -> dict[int, int]:
        return dict(zip(self.cp_tasks, self.cp_classes))

    @property
    def schedule(self) -> Schedule:
        return Schedule(proc=self.proc, start=self.start, finish=self.finish)


@dataclasses.dataclass(frozen=True)
class PlannerSpec:
    """Registry entry: ``build(g, comp, m, ceft_result) -> Plan``."""

    name: str
    build: Callable[[TaskGraph, np.ndarray, Machine, CeftResult | None], Plan]
    uses_ceft: bool = False   # True: consumes a CeftResult (CSR fast path)
    exhaustive: bool = False  # True: exponential-time oracle, small graphs only


def _from_schedule(name: str, g: TaskGraph, comp: np.ndarray, m: Machine,
                   sched: Schedule, cpl: float, cp: list[int]) -> Plan:
    ic = m.inst_class
    return Plan(
        planner=name,
        proc=sched.proc, start=sched.start, finish=sched.finish,
        eft=sched.start[:, None] + comp,
        cpl=float(cpl),
        cp_tasks=tuple(int(t) for t in cp),
        cp_classes=tuple(int(ic[sched.proc[t]]) for t in cp),
    )


def _build_ceft_cpop(g, comp, m, res):
    if res is None:
        res = ceft(g, comp, m)
    sched = ceft_cpop(g, comp, m, res)
    ts, cs = zip(*res.path)
    return Plan(
        planner="ceft_cpop",
        proc=sched.proc, start=sched.start, finish=sched.finish,
        eft=np.asarray(res.ceft, np.float64),
        cpl=float(res.cpl),
        cp_tasks=tuple(int(t) for t in ts),
        cp_classes=tuple(int(c) for c in cs),
    )


def _build_cpop(g, comp, m, res):
    del res
    sched = cpop(g, comp, m)
    cp = _cpop_cp_set(g, rank_u(g, comp, m) + rank_d(g, comp, m))
    # CPOP's realized CP length: the whole set on the one class minimizing its
    # total computation (intra-path comm zeroed) — the Table-3 quantity.
    cpl = float(comp[cp, :].sum(axis=0).min())
    return _from_schedule("cpop", g, comp, m, sched, cpl, cp)


def _build_list(name: str, fn):
    def build(g, comp, m, res):
        del res
        sched = fn(g, comp, m)
        cost, cp = averaged_critical_path(g, comp, m)
        return _from_schedule(name, g, comp, m, sched, cost, cp)
    return build


def chain_optimal_assignment(
    path: list[int], g: TaskGraph, comp: np.ndarray, m: Machine
) -> tuple[float, list[int]]:
    """``bruteforce.chain_optimal_cost`` with argmin backtracking: the exact
    minimum chain cost *and* one class per path vertex achieving it."""
    P = comp.shape[1]
    off = ~np.eye(P, dtype=bool)
    dp = comp[path[0], :].astype(np.float64).copy()
    args: list[np.ndarray] = []
    for a, b in zip(path[:-1], path[1:]):
        ps = g.parents(b)
        data = float(g.parent_data(b)[np.nonzero(ps == a)[0][0]])
        comm = (m.L[:, None] + data / m.bw) * off
        cand = dp[:, None] + comm            # (class_from, class_to)
        args.append(cand.argmin(axis=0))
        dp = comp[b, :] + cand.min(axis=0)
    classes = [int(dp.argmin())]
    for arg in reversed(args):
        classes.append(int(arg[classes[-1]]))
    return float(dp.min()), classes[::-1]


def _build_bruteforce(g, comp, m, res):
    del res
    paths = all_paths(g)
    if len(paths) > _BRUTEFORCE_PATH_CAP:
        raise ValueError(
            f"bruteforce planner: {len(paths)} source->sink paths exceeds the "
            f"cap of {_BRUTEFORCE_PATH_CAP} (exponential oracle; small graphs "
            "only)")
    best_cost, best_path, best_classes = -np.inf, [], []
    for p in paths:
        cost, classes = chain_optimal_assignment(p, g, comp, m)
        if cost > best_cost:
            best_cost, best_path, best_classes = cost, p, classes
    ic = m.inst_class
    first_inst = {c: int(np.nonzero(ic == c)[0][0]) for c in range(m.P)}
    pin = {t: first_inst[c] for t, c in zip(best_path, best_classes)}
    pri = rank_u(g, comp, m) + rank_d(g, comp, m)
    sched = list_schedule(g, comp, m, priority=pri, pin=pin)
    return Plan(
        planner="bruteforce",
        proc=sched.proc, start=sched.start, finish=sched.finish,
        eft=sched.start[:, None] + comp,
        cpl=float(best_cost),
        cp_tasks=tuple(int(t) for t in best_path),
        cp_classes=tuple(int(c) for c in best_classes),
    )


PLANNERS: dict[str, PlannerSpec] = {
    "ceft_cpop": PlannerSpec("ceft_cpop", _build_ceft_cpop, uses_ceft=True),
    "cpop": PlannerSpec("cpop", _build_cpop),
    "heft": PlannerSpec("heft", _build_list("heft", heft)),
    "heft_down": PlannerSpec("heft_down", _build_list("heft_down", heft_down)),
    "ceft_heft_up": PlannerSpec(
        "ceft_heft_up", _build_list("ceft_heft_up", ceft_heft_up)),
    "ceft_heft_down": PlannerSpec(
        "ceft_heft_down", _build_list("ceft_heft_down", ceft_heft_down)),
    "bruteforce": PlannerSpec("bruteforce", _build_bruteforce, exhaustive=True),
}


def planner_names(*, include_exhaustive: bool = True) -> list[str]:
    return [n for n, s in PLANNERS.items()
            if include_exhaustive or not s.exhaustive]


def get_planner(name: str) -> PlannerSpec:
    try:
        return PLANNERS[name]
    except KeyError:
        raise KeyError(
            f"unknown planner {name!r}; registered: {sorted(PLANNERS)}"
        ) from None


def plan(name: str, g: TaskGraph, comp: np.ndarray, m: Machine, *,
         ceft_result: CeftResult | None = None) -> Plan:
    """Run the named planner.  ``ceft_result`` lets CEFT-consuming planners
    reuse a sweep already paid for (e.g. the plan cache's CSR fast path)."""
    return get_planner(name).build(g, comp, m, ceft_result)


def realize(name: str, g: TaskGraph, comp: np.ndarray, m: Machine,
            result: CeftResult | Plan) -> Plan:
    """Turn a cached planning result into a full Plan.

    The plan cache stores a :class:`CeftResult` for CEFT-consuming planners
    (the batched CSR sweep's native output) and a :class:`Plan` for host-path
    planners; callers that need the realized schedule go through here so both
    shapes work."""
    if isinstance(result, Plan):
        return result
    return plan(name, g, comp, m, ceft_result=result)


def averaged_path_misidentified(
    g: TaskGraph, comp: np.ndarray, m: Machine, *,
    ceft_result: CeftResult | None = None, tol: float = 1e-9,
) -> bool:
    """Does the averaging-based critical path misidentify the true one?

    The paper's headline comparison (§7.3, 83.99%): the mean-cost longest
    path (``averaged_critical_path`` — CPOP/HEFT's estimate) is *misidentified*
    when, under its own optimal chain assignment, it is strictly shorter than
    CEFT's critical-path length — i.e. some other path is the real constraint.
    Equal-cost alternate paths are NOT misidentified (oracle-aligned: this
    predicate agrees with comparing against ``bruteforce_cpl`` whenever CEFT
    is exact, which ``tests/test_planners.py`` checks on small graphs)."""
    res = ceft_result if ceft_result is not None else ceft(g, comp, m)
    _, avg_tasks = averaged_critical_path(g, comp, m)
    realized = chain_optimal_cost(avg_tasks, g, comp, m)
    return bool(realized < float(res.cpl) - tol * max(1.0, abs(float(res.cpl))))
