"""Straggler mitigation: observe per-class step times, detect degradation via
EWMA drift, feed degraded costs back into CEFT-CPOP and re-plan.

This is the paper's heterogeneity story running *online*: a fleet that was
homogeneous at launch becomes heterogeneous when a slice degrades (thermal
throttling, a flaky ICI link, a preempted host).  CEFT's class-view cost model
absorbs the measurement directly (scale the class's comp column), and the
re-planned CEFT-CPOP schedule routes critical-path work away from the slow
class.  The re-planning sweeps route through the unified plan cache
(``repro_torch.sched.plancache``): fused CSR sweeps at O(e·P²) device work — the
paper's §5 bound — with quiet steps served as pure cache hits and changed
cost planes re-swept from their dirty frontier only.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from ..core import planners
from ..core.machine import Machine
from ..core.taskgraph import TaskGraph
from .plancache import PlanCache


@dataclasses.dataclass
class StragglerEvent:
    step: int
    device_class: int
    slowdown: float
    old_makespan: float
    new_makespan: float


# A lost worker is a FULLY-degraded class column: large enough that CEFT
# never maps work onto it, small enough to stay finite in float32 cost
# planes (inf would poison the min-plus sweep with NaNs).
LOST_SLOWDOWN = 1e6


class EwmaCostTable:
    """Online per-(workload-class, processor-class) cost model.

    One EWMA row of ``n_classes`` entries per hashable key — the serving
    router keys by request workload class (per-token generate rates), the
    training loop keys by layer class.  Shared between the router and the
    straggler machinery: :meth:`StragglerMonitor.observe` slowdown factors
    multiply onto these rows via :meth:`comp_matrix`'s ``scale`` argument,
    so a degraded processor class sheds critical-path work on the very next
    plan.

    Unobserved entries inside a partially-observed row fall back to the row's
    observed mean (neutral: new engines get explored, not written off at the
    ``default``); fully-unobserved rows fall back to ``default``.

    Thread-safe: the router executes micro-batches on per-engine worker
    threads, each feeding measurements back concurrently.

    Elastic: the class count may GROW while the table lives (the engine pool
    launches workers).  An update or degradation report for a class index the
    table has never seen widens every row (new entries NaN -> fallback rules
    above) instead of raising — a just-launched worker must be explorable,
    and a just-lost one degradable, without resetting learned rates.
    """

    def __init__(self, n_classes: int, alpha: float = 0.3, default: float = 1.0):
        self.n_classes = int(n_classes)
        self.alpha = float(alpha)
        self.default = float(default)
        self._rows: dict = {}
        self._lock = threading.Lock()
        self._listeners: list = []

    def ensure_classes(self, n: int) -> None:
        """Widen the table to ``n`` processor classes (no-op when already
        that wide); existing rows are padded with NaN (the explore default)."""
        with self._lock:
            self._ensure_locked(int(n))

    def _ensure_locked(self, n: int) -> None:
        if n <= self.n_classes:
            return
        pad = n - self.n_classes
        for key, row in self._rows.items():
            self._rows[key] = np.concatenate([row, np.full(pad, np.nan)])
        self.n_classes = n

    def reset_class(self, cls: int) -> None:
        """Forget every rate measured for one class column (a freed pool slot
        was revived by a DIFFERENT worker: its predecessor's rates are not
        evidence about it)."""
        with self._lock:
            if cls < self.n_classes:
                for row in self._rows.values():
                    row[cls] = np.nan

    def add_listener(self, fn) -> None:
        """Register ``fn(key, cls)`` to run after every :meth:`update` — the
        plan cache's invalidation hook (a cost delta dirties exactly the
        plans whose DAG contains ``key``).  Listeners run OUTSIDE the table
        lock: they take their own locks (the plan cache's), and nesting
        foreign locks under this one invites ordering deadlocks."""
        self._listeners.append(fn)

    def update(self, key, cls: int, value: float) -> None:
        with self._lock:
            # a measurement for an engine this table has never seen (a
            # just-launched pool worker) widens the table instead of raising
            self._ensure_locked(int(cls) + 1)
            row = self._rows.get(key)
            if row is None:
                row = self._rows[key] = np.full(self.n_classes, np.nan)
            row[cls] = (value if np.isnan(row[cls])
                        else self.alpha * value + (1 - self.alpha) * row[cls])
        for fn in self._listeners:
            fn(key, cls)

    def row(self, key) -> np.ndarray:
        """The (n_classes,) cost row for ``key``, NaN-free (see class doc)."""
        with self._lock:
            row = self._rows.get(key)
            if row is None or np.isnan(row).all():
                return np.full(self.n_classes, self.default)
            return np.where(np.isnan(row), np.nanmean(row), row)

    def comp_matrix(self, keys, scale=None) -> np.ndarray:
        """(len(keys), n_classes) cost plane in CEFT's comp-matrix shape,
        optionally column-scaled by per-class slowdown factors."""
        out = np.stack([self.row(k) for k in keys])
        if scale is not None:
            out = out * np.asarray(scale, np.float64)[None, :]
        return out


class StragglerMonitor:
    """EWMA per device class; replan when a class drifts > threshold.

    Elastic (the engine-pool contract): the class count grows on demand —
    a slowdown report or loss mark for a class the monitor has never seen
    (a just-launched or just-lost worker) widens the arrays and registers a
    degraded column instead of raising.  A LOST class reports
    :data:`LOST_SLOWDOWN` until revived, so the batched nominal+degraded
    re-plan that already handles stragglers covers failover unchanged.
    """

    def __init__(self, n_classes: int, alpha: float = 0.2, threshold: float = 1.3,
                 plancache: PlanCache | None = None,
                 planner: str = "ceft_cpop", *, device="cuda"):
        self.alpha = alpha
        self.threshold = threshold
        # nominal + degraded re-planning is parameterized by registry name —
        # fail fast on typos, before the first maybe_replan
        self.planner = planners.get_planner(planner).name
        self.ewma = np.ones(n_classes) * np.nan
        self.baseline = np.ones(n_classes) * np.nan
        self.lost = np.zeros(n_classes, bool)
        self.events: list[StragglerEvent] = []
        # nominal-schedule caching is a thin view over the unified plan cache
        # (repro_torch.sched.plancache, sweeping on ``device`` unless a cache
        # is passed in): swept plans are content-keyed there by
        # (graph, cost plane, machine) value, so re-built but equal inputs
        # hit and in-place mutation of comp / m.L / m.bw cannot serve a
        # stale baseline (plan() byte-compares the stored plane).  The
        # CEFT-CPOP mapping is memoized on the plan entry (entry.derived),
        # which plan() resets whenever the plane actually changed.
        self.plancache = (plancache if plancache is not None
                          else PlanCache(device=device))
        self._nominal_sched = None

    def _cpop(self, g: TaskGraph, comp: np.ndarray, m: Machine, *, slot: str):
        """Swept plan + memoized realized mapping through the plan cache.

        For CEFT-consuming planners the cache returns the CSR sweep's
        CeftResult and the realized schedule is memoized per entry; for
        host-path planners the cached result already IS the full Plan."""
        res, _status, entry = self.plancache.plan(
            g, comp, m, slot=slot, planner=self.planner)
        sched = entry.derived.get("sched")
        if sched is None:
            sched = entry.derived["sched"] = planners.realize(
                self.planner, g, comp, m, res)
        return sched

    def ensure_classes(self, n: int) -> None:
        """Widen to ``n`` classes (never shrinks): new columns start
        unobserved (NaN EWMA/baseline) and healthy (not lost)."""
        n = int(n)
        if n <= len(self.ewma):
            return
        pad = n - len(self.ewma)
        self.ewma = np.concatenate([self.ewma, np.full(pad, np.nan)])
        self.baseline = np.concatenate([self.baseline, np.full(pad, np.nan)])
        self.lost = np.concatenate([self.lost, np.zeros(pad, bool)])

    def slowdowns(self) -> np.ndarray:
        """Current per-class slowdown factors (>= 1): unobserved columns are
        nominal (1.0), lost columns are :data:`LOST_SLOWDOWN`."""
        with np.errstate(invalid="ignore"):
            s = np.where(np.isnan(self.ewma) | np.isnan(self.baseline), 1.0,
                         np.maximum(self.ewma / self.baseline, 1.0))
        return np.where(self.lost, LOST_SLOWDOWN, s)

    def report(self, cls: int, slowdown: float) -> np.ndarray:
        """Register a degraded column directly — the path for slowdown
        reports about an engine the monitor has never seen (a just-launched
        or just-lost pool worker), which must grow the arrays instead of
        raising.  Returns the slowdown factors."""
        cls = int(cls)
        self.ensure_classes(cls + 1)
        if np.isnan(self.baseline[cls]):
            self.baseline[cls] = 1.0
        self.ewma[cls] = self.baseline[cls] * float(slowdown)
        return self.slowdowns()

    def report_overdue(self, cls: int,
                       observed_slowdown: float | None = None) -> np.ndarray:
        """A deadline-watchdog strike: the engine blew its plan-derived
        budget.  Registers at least a threshold-tripping slowdown — never
        *reducing* an already-degraded column, and leaving LOST columns
        alone — so the very next plan sheds critical-path work off the
        offender.  Returns the slowdown factors."""
        cls = int(cls)
        self.ensure_classes(cls + 1)
        if self.lost[cls]:
            return self.slowdowns()
        want = max(self.threshold, float(self.slowdowns()[cls]))
        if observed_slowdown is not None:
            want = max(want, float(observed_slowdown))
        return self.report(cls, want)

    def mark_lost(self, cls: int) -> np.ndarray:
        """A worker died: its class column becomes fully degraded (grows the
        arrays for never-observed classes).  Returns the slowdown factors."""
        cls = int(cls)
        self.ensure_classes(cls + 1)
        self.lost[cls] = True
        return self.slowdowns()

    def revive(self, cls: int) -> None:
        """A freed slot was relaunched: clear the lost flag and forget the
        previous worker's timing evidence for that column."""
        cls = int(cls)
        self.ensure_classes(cls + 1)
        self.lost[cls] = False
        self.ewma[cls] = np.nan
        self.baseline[cls] = np.nan

    def observe(self, class_times: np.ndarray) -> np.ndarray:
        """Update EWMAs; returns per-class slowdown factors (>= 1).

        ``class_times`` may be wider than the monitor (just-launched
        workers: the arrays grow) or narrower (times for a prefix of the
        classes: the unmeasured tail keeps its current estimate)."""
        class_times = np.asarray(class_times, np.float64)
        self.ensure_classes(len(class_times))
        if len(class_times) < len(self.ewma):
            tail = self.ewma[len(class_times):]
            class_times = np.concatenate(
                [class_times, np.where(np.isnan(tail), 1.0, tail)])
        new = np.isnan(self.ewma)
        self.ewma = np.where(new, class_times,
                             self.alpha * class_times + (1 - self.alpha) * self.ewma)
        self.baseline = np.where(np.isnan(self.baseline), self.ewma,
                                 np.minimum(self.baseline, self.ewma))
        return self.slowdowns()

    def maybe_replan(self, step: int, g: TaskGraph, comp: np.ndarray, m: Machine,
                     class_times: np.ndarray):
        """Returns (schedule, event|None).  Schedules with degraded costs when
        any class trips the threshold; otherwise schedules with nominal costs
        (the cached nominal schedule, computed on first call).

        Both the nominal baseline and the degraded scenario go through the
        unified plan cache: the graph's device-side segment tables are built
        once, a quiet step with unchanged costs is a pure cache hit (zero
        sweeps), and a changed plane re-sweeps only from its dirty frontier.
        """
        slow = self.observe(class_times)
        if (slow < self.threshold).all():
            # Below threshold: the *nominal* schedule, which also warms the
            # nominal cache so the first straggler event pays one sweep.
            self._nominal_sched = self._cpop(g, comp, m, slot="nominal")
            return self._nominal_sched, None
        base = self._nominal_sched = self._cpop(g, comp, m, slot="nominal")
        degraded = comp * slow[None, :]
        new = self._cpop(g, degraded, m, slot="degraded")
        worst = int(np.argmax(slow))
        ev = StragglerEvent(step, worst, float(slow[worst]),
                            float(base.makespan), float(new.makespan))
        self.events.append(ev)
        return new, ev
