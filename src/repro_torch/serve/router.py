"""CEFT-routed multi-tenant serving front-end (the paper's planner run
*online* as a dispatch policy).

The mutual-inclusivity claim, applied to serving: a useful critical path of
the pending work must carry its own mapping of tasks to processor classes.
Here the tasks are request *workload classes* (prompt-len/max-new buckets,
see repro_torch.serve.queue) and the processor classes are the pool's engines —
each pinned to its own sharding profile and/or architecture, made safe to
run concurrently by the scoped-profile substrate.  Every tick the router:

  1. admits the queue's arrivals into per-class *resident* FIFOs (incremental
     admission: residents persist across ticks; ``tick_budget`` bounds how
     many leave per tick),
  2. models the resident mix as a small task DAG (one prefill -> decode
     chain per class; edge data = the KV handoff volume),
  3. prices the DAG with an online EWMA cost table (per-token rates measured
     from real dispatches, shared machinery with repro_torch.sched.straggler) and
     the StragglerMonitor's per-engine slowdown factors,
  4. plans through the unified plan cache (repro_torch.sched.plancache): an
     unchanged mix with no cost/slowdown delta since the cached sweep is
     served straight from cache (a steady-state tick runs ZERO sweeps and
     costs O(classes + budget), independent of how many requests are
     resident); deltas invalidate only the affected plans through the
     cache's reverse index, and a changed plane re-sweeps from its dirty
     frontier, and
  5. dispatches: critical-path classes go to the path's own engine class,
     off-path classes to their earliest-finish class, and same-class
     requests coalesce into micro-batches whose added latency stays bounded
     by the CEFT path length (a micro-batch never grows past the point where
     it would itself become the critical path).

A degraded engine (StragglerMonitor threshold trip) therefore sheds
critical-path work automatically: its comp column inflates, CEFT maps the
path elsewhere, and the dispatch follows the path.

The SLO plane rides on the same plan: tenants may carry
:class:`~repro_torch.serve.queue.TenantTier`\\ s (weighted drain + latency SLOs
stamped at admission), each cached plan's backward deadline propagation
(repro_torch.sched.deadlines, memoized on the plan-cache entry) assigns every
class a latest start/finish and slack, watchdog budgets are armed from the
propagated latest-finish instead of the flat ``deadline_factor x span``,
and degraded engines shed their most-slack dispatches first — both at tick
time (``_slo_shed``) and on the overdue ladder (slack-rich work requeues at
strike 1, SLO-critical work hedges like critical-path work).

On the card (``device="cuda"``, the default) every plan of the tick — the
nominal and degraded planes, the moldable split candidates, the hedge's
transient re-plan — sweeps through the CUDA relaxation kernels; the host
keeps the DAG build, the realized schedules and the dispatch.  A tick's DAG
is tiny (two vertices per workload class and split chunk), so the card may
well lose to ``device="cpu"`` here; the router does not choose for the
caller.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Sequence

import numpy as np

from ..core import planners
from ..core.ceft import CeftResult
from ..core.ceft_torch import request_graph
from ..core.machine import Machine
from ..core.taskgraph import moldable_fork_join_arrays
from ..sched.deadlines import DeadlineSchedule, propagate_deadlines
from ..sched.plancache import PlanCache, machine_fingerprint
from ..sched.straggler import EwmaCostTable, StragglerMonitor
from .engine import ServeConfig
from .pool import EnginePool, EngineSlot, WorkerLost
from .queue import AdmissionQueue, Request, class_mix, moldable_class, next_seq
from .watchdog import DeadlineWatchdog, InflightEntry


@dataclasses.dataclass
class Dispatch:
    engine: int                  # slot index == CEFT processor class
    requests: list[Request]
    wclass: tuple[int, int]
    on_critical_path: bool
    node_prefill: int            # this class's vertex ids in the planned DAG
    node_decode: int             # (node_prefill = first chunk when split > 1)
    split: int = 1               # planner-chosen moldable prefill split degree
    # SLO plane: the tightest absolute deadline among the batch's
    # requests (None = best-effort) and the class's structural slack from the
    # backward deadline propagation (inf when no propagation is available)
    deadline: float | None = None
    slack: float = float("inf")


def router_machine(P: int, *, kv_bw: float = 1e4, latency: float = 1e-3) -> Machine:
    """The pool as a CEFT machine: one class per engine (count 1), uniform
    KV-handoff bandwidth (tokens/s) and dispatch latency between engines."""
    return Machine(
        L=np.full(P, latency, np.float64),
        bw=np.full((P, P), kv_bw, np.float64),
        counts=np.ones(P, np.int64),
    )


class Router:
    """Plans over the placement plane and owns the admission queue and cost
    model; turns each tick's pending requests into CEFT-planned dispatches.

    The router no longer constructs or holds engines: ``pool`` (an
    :class:`~repro_torch.serve.pool.EnginePool`, or a plain ``EngineSlot`` list
    wrapped into one) owns worker lifecycle and the measured comm plane, and
    every plan prices against ``pool.machine()`` — a snapshot that only
    changes when the pool's shape or a quantized measurement does, so the
    plan cache's machine fingerprints stay meaningful.

    ``device`` is where the plans sweep: the card unless the caller passes
    ``device="cpu"``; it goes to the :class:`PlanCache` the router builds
    (a ``plancache`` passed in keeps its own) and to its
    :class:`StragglerMonitor`."""

    def __init__(self, pool: EnginePool | Sequence[EngineSlot], *,
                 machine: Machine | None = None,
                 queue: AdmissionQueue | None = None, alpha: float = 0.3,
                 default_rate: float = 1e-3, max_batch: int = 8,
                 latency_slack: float = 1.0, straggler_threshold: float = 1.3,
                 plancache: PlanCache | None = None,
                 tick_budget: int | None = None,
                 deadline_factor: float | None = None, hedge: bool = True,
                 min_deadline: float = 0.05, wd_poll: float = 0.01,
                 watchdog: DeadlineWatchdog | None = None,
                 planner: str = "ceft_cpop", max_split: int = 1,
                 device="cuda"):
        if not isinstance(pool, EnginePool):
            if not pool:
                raise ValueError("router needs at least one engine slot")
            pool = EnginePool.from_slots(pool, machine=machine)
        elif machine is not None:
            raise ValueError("pass machine= to the pool, not past it")
        self.pool = pool
        if not self.pool.size:
            raise ValueError("router needs at least one pool worker")
        P = self.pool.size
        if self.machine.P != P:
            raise ValueError(f"machine has {self.machine.P} classes for {P} workers")
        self.queue = queue if queue is not None else AdmissionQueue()
        self.costs = EwmaCostTable(P, alpha=alpha, default=default_rate)
        self.monitor = StragglerMonitor(P, threshold=straggler_threshold,
                                        device=device)
        self.plancache = (plancache if plancache is not None
                          else PlanCache(device=device))
        # a measured rate delta dirties exactly the cached plans whose DAG
        # contains that workload class (the cache's reverse index)
        self.costs.add_listener(self._on_cost_delta)
        # pool lifecycle deltas (loss, launch, drain) degrade/revive the
        # matching straggler column and dirty the cached plans
        self.pool.add_listener(self._on_pool_event)
        # tick_budget=None keeps the historical dispatch-everything tick;
        # an integer bounds dispatches per tick, split round-robin across
        # classes, with the remainder staying resident for later ticks
        self.tick_budget = None if tick_budget is None else max(1, int(tick_budget))
        self.resident: dict[tuple[int, int], deque[Request]] = {}
        self.max_batch = int(max_batch)
        self.latency_slack = float(latency_slack)
        # planner by registry name (fail fast on typos) + moldable split axis:
        # candidate degrees are the powers of two up to max_split, each priced
        # as its own fork-join plan; the tick keeps the degree whose realized
        # plan finishes first (ties -> smallest degree, so max_split=1 is
        # byte-identical to the historical unsplit router)
        self.planner = planners.get_planner(planner).name
        self.max_split = max(1, int(max_split))
        self._degrees = [d for d in (1, 2, 4, 8, 16, 32)
                         if d <= self.max_split]
        self._slow = np.ones(P)
        self._P = P
        self._m_snapshot = self.machine
        self.stats = {"plans": 0, "degraded_plans": 0, "dispatches": 0,
                      "coalesced": 0, "split": 0, "shed": 0, "ticks": 0,
                      "cache_hits": 0, "invalidations": 0,
                      "partial_sweeps": 0, "resident": 0, "requeued": 0,
                      "overdue": 0, "overdue_cp": 0, "hedges": 0,
                      "stale_replies": 0, "completions": 0,
                      "watchdog_lost": 0, "clamped_budgets": 0,
                      "slo_shed": 0, "slo_hedges": 0, "split_degree": 1,
                      "moldable_plans": 0}
        self.failures: list[tuple[str, BaseException]] = []
        # deadline watchdog (None = disarmed: serve() is the plain loop).
        # deadline_factor arms it: every dispatch carries a deadline derived
        # from its planned span under the current cost table x slowdowns, and
        # the monitor thread escalates overdue attempts (hedge / report /
        # requeue / mark_lost -- see _on_overdue).
        self.hedge = bool(hedge)
        self.watchdog = watchdog
        if self.watchdog is None and deadline_factor is not None:
            self.watchdog = DeadlineWatchdog(
                deadline_factor=float(deadline_factor),
                min_deadline=float(min_deadline), poll_interval=float(wd_poll))
        if self.watchdog is not None:
            self.watchdog.on_overdue = self._on_overdue
        self._serve_lock = threading.Lock()
        self._serve_done: dict[int, np.ndarray] | None = None
        self._wd_requeue: list[Dispatch] = []
        self._hedge_threads: list[threading.Thread] = []
        self.last_plan: CeftResult | None = None
        self.last_nominal: CeftResult | None = None
        self.last_dag: tuple | None = None
        self.last_groups: list | None = None
        self._plan_sig: tuple | None = None    # mix the cached plan priced
        self._plan_comp: np.ndarray | None = None
        self._chosen: dict | None = None       # class index -> (engine, on_path)
        self._entry = None                     # the cached plan's PlanEntry
        self._plan_split = 1                   # the cached plan's split degree

    @property
    def machine(self) -> Machine:
        """The pool's current Machine snapshot (the placement plane view)."""
        return self.pool.machine()

    @property
    def slots(self) -> list[EngineSlot]:
        """Engine-slot view of the pool (compat: slot index == CEFT class)."""
        return self.pool.slots

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> bool:
        return self.queue.submit(req)

    # ------------------------------------------------------------ cost model
    def observe(self, engine: int, wclass: tuple[int, int], seconds: float,
                tokens: int) -> None:
        """Fold one measured dispatch into the EWMA table as a per-token rate."""
        self.costs.update(wclass, engine, seconds / max(tokens, 1))

    def _on_cost_delta(self, wclass, engine: int) -> None:
        """EwmaCostTable listener: dirty the cached plans whose DAG contains
        the updated class.  Advisory only — the plan cache byte-compares the
        cost plane before serving anything, so over-invalidation costs a
        re-sweep and under-invalidation is impossible."""
        self.stats["invalidations"] += self.plancache.invalidate(wclass=wclass)

    def observe_step(self, engine_times: np.ndarray) -> np.ndarray:
        """Per-engine health signal (e.g. step times) through the straggler
        monitor; the returned slowdown factors (>= 1) scale the cost table's
        engine columns on every subsequent plan, so a degraded engine sheds
        critical-path work."""
        old = self._slow
        self._slow = self.monitor.observe(np.asarray(engine_times, np.float64))
        if not np.array_equal(old, self._slow):
            # a slowdown delta rescales whole comp columns: every cached plan
            # on this machine is affected, not just one workload class
            self.stats["invalidations"] += self.plancache.invalidate(
                engine=int(np.argmax(self._slow)))
        return self._slow

    # ----------------------------------------------------------- pool deltas
    def _on_pool_event(self, event: str, payload) -> None:
        """EnginePool listener.  Loss/drain fully degrade the worker's class
        column (the straggler plane routes the critical path around it — the
        batched nominal+degraded re-plan IS the failover path); launch
        revives the column and forgets the previous occupant's rates.  All
        three dirty the cached plans and drop the steady-state signature."""
        if event == "machine":
            # a measured comm-plane delta crossed a quantization bucket: the
            # superseded snapshot's plans can only be stale short-circuits
            self.stats["invalidations"] += self.plancache.invalidate(
                machine_fp=machine_fingerprint(payload))
        elif event in ("lost", "drain"):
            self._slow = self.monitor.mark_lost(int(payload))
            self.stats["invalidations"] += self.plancache.invalidate(
                engine=int(payload))
        elif event == "launch":
            self.monitor.revive(int(payload))
            self.costs.reset_class(int(payload))
            self._slow = self.monitor.slowdowns()
            self.stats["invalidations"] += self.plancache.invalidate()
        self._plan_sig = None

    def _sync_pool(self) -> None:
        """Re-align the planning state with the pool's current shape and
        Machine snapshot (workers may have launched, drained, or died since
        the last tick; probes may have moved the measured comm plane)."""
        P = self.pool.size
        if P != self._P:
            self._P = P
            self.costs.ensure_classes(P)
            self.monitor.ensure_classes(P)
            self._plan_sig = None
        slow = self.monitor.slowdowns()
        if len(slow) < P:
            self.monitor.ensure_classes(P)
            slow = self.monitor.slowdowns()
        self._slow = slow[:P]
        m = self.pool.machine()
        if m is not self._m_snapshot:
            self.stats["invalidations"] += self.plancache.invalidate(
                machine_fp=machine_fingerprint(self._m_snapshot))
            self._m_snapshot = m
            self._plan_sig = None

    # --------------------------------------------------------------- planning
    def build_dag(self, groups: list[tuple[tuple[int, int], list[Request]]],
                  split: int = 1):
        """The pending batch as a task DAG: per class a moldable fork-join —
        ``split`` parallel prefill chunks (vertices ``i*split ..``) joining
        into one decode (vertex ``G*split + i``), edge data = the chunk's
        prompt-token volume (the KV handoff volume if the decode lands on a
        different engine), comp from the EWMA per-token rates x token
        volumes.  ``split=1`` is the historical prefill (vertex i) -> decode
        (vertex G+i) chain, byte-for-byte.  The returned plane is *nominal*
        (unscaled): ``_plan`` applies the monitor's slowdown factors, so the
        nominal plane stays byte-stable across slowdown changes and the plan
        cache's nominal slot keeps hitting.

        Token volumes are *bucket-sized* (wclass bound x request count), not
        exact sums: the class is the task, and bucketing keeps the DAG
        content identical across ticks with the same class mix + counts, so
        the content-keyed graph store actually hits on real traffic
        (exact per-tick prompt sums would miss it every tick)."""
        G = len(groups)
        d = max(1, int(split))
        rates = self.costs.comp_matrix([wc for wc, _ in groups])
        volumes = np.array([float(wc[0] * len(reqs)) for wc, reqs in groups],
                           np.float64)
        n, src, dst, data = moldable_fork_join_arrays(volumes, d)
        comp = np.zeros((n, self.machine.P), np.float64)
        comp[:G * d] = np.repeat(rates, d, axis=0) * data[:G * d, None]
        for i, (wc, reqs) in enumerate(groups):
            comp[G * d + i] = rates[i] * float(wc[1] * len(reqs))
        return n, src, dst, data, comp

    def _plan(self, classes, n, src, dst, data, comp_nominal, *,
              split: int = 1):
        """One plan-cache pass over the tick's DAG; scenario-split (degraded
        + nominal planes, each through its own cache slot over the same
        graph) while any engine trips the monitor, so the shed critical-path
        work is observable against the nominal plan.  Split-degree plans get
        their own slots and additionally register under their moldable
        classes; the base classes stay on every plan so a cost delta keyed by
        the base class dirties all of a class's split variants.

        Returns ``(res, comp, nom, entry)`` — the caller owns publishing the
        winning candidate to ``last_plan``/``last_nominal``/``_entry``."""
        if split > 1:
            classes = list(classes) + [moldable_class(wc, split)
                                       for wc in classes]
            slot_nom, slot_deg = ("router", split), ("router-degraded", split)
        else:
            slot_nom, slot_deg = "router", "router-degraded"
        g = request_graph(n, src, dst, data)
        comp = comp_nominal * self._slow[None, :]
        degraded_mode = bool((self._slow >= self.monitor.threshold).any())
        if degraded_mode:
            res, status, entry = self.plancache.plan(
                g, comp, self.machine, slot=slot_deg, classes=classes,
                planner=self.planner)
            nom, _, _ = self.plancache.plan(
                g, comp_nominal, self.machine, slot=slot_nom, classes=classes,
                planner=self.planner)
            self.stats["degraded_plans"] += 1
            self.stats["shed"] += sum(
                1 for t, p in res.path if nom.assignment.get(t, p) != p)
        else:
            res, status, entry = self.plancache.plan(
                g, comp, self.machine, slot=slot_nom, classes=classes,
                planner=self.planner)
            nom = None
        self.stats["plans"] += 1
        if status == "hit":
            self.stats["cache_hits"] += 1
        elif status == "partial":
            self.stats["partial_sweeps"] += 1
        return res, comp, nom, entry

    def _realized_makespan(self, res, entry) -> float:
        """The candidate plan's realized finish time — the planner's full
        schedule (instances, contention included) over the entry's own cost
        plane, memoized per plan entry so steady traffic never re-schedules.
        This is the moldable degree-selection metric: the class-view DP alone
        always rewards more splitting (chunks never contend in the class
        view), the realized schedule prices the contention."""
        sched = entry.derived.get("sched")
        if sched is None:
            sched = entry.derived["sched"] = planners.realize(
                self.planner, entry.graph,
                entry.comp32.astype(np.float64), entry.machine, res)
        return float(sched.makespan)

    def _choose(self, G: int, res: CeftResult, comp: np.ndarray,
                split: int = 1) -> dict:
        """The ceft_cpop split, serving-side: critical-path classes are
        pinned to the path's own engine; everything else takes its earliest-
        finish class *given the load already placed this tick* (pure argmin
        over res.ceft would pile every tied class onto engine 0).  With a
        moldable split, a class is on-path when ANY of its chunks (or its
        decode) is, and its placed load sums over all its chunk vertices."""
        d = max(1, int(split))
        assign = res.assignment                    # critical path's own mapping
        load = np.zeros(self.machine.P)
        chosen: dict[int, tuple[int, bool]] = {}
        on_path = [i for i in range(G)
                   if G * d + i in assign
                   or any(i * d + j in assign for j in range(d))]
        for i in on_path + [i for i in range(G) if i not in on_path]:
            pres = range(i * d, i * d + d)
            dec = G * d + i
            if i in on_path:                       # shed to the path's class
                cls = int(assign.get(
                    dec, next((assign[p] for p in pres if p in assign), 0)))
            else:                                  # earliest finish incl. load
                cls = int(np.argmin(res.ceft[dec] + load))
            chosen[i] = (cls, i in on_path)
            load[cls] += comp[list(pres), cls].sum() + comp[dec, cls]
        return chosen

    # --------------------------------------------------------------- the tick
    def tick(self) -> list[Dispatch]:
        """Admit, plan (or serve the cached plan), and form micro-batches up
        to ``tick_budget``; returns the dispatch list (execution is separate
        -- see run_dispatch / serve).

        The steady-state guarantee (README "Incremental planning"): when the
        resident mix matches the cached plan's and no cost/slowdown delta
        has dirtied it, the tick serves the plan straight from cache — zero
        sweeps, no cost-plane build, cost O(classes + budget) independent of
        the resident count."""
        if self.pool.autoscale:
            backlog = len(self.queue) + sum(len(q) for q in self.resident.values())
            self.pool.maybe_autoscale(backlog)
        self._sync_pool()
        for r in self.queue.drain():
            self.resident.setdefault(r.wclass, deque()).append(r)
        self.stats["ticks"] += 1
        self.stats["resident"] = sum(len(q) for q in self.resident.values())
        if not self.resident:
            return []
        sig = class_mix(self.resident)
        entry = self._entry
        if sig == self._plan_sig and entry is not None and not entry.dirty:
            # steady state: same mix, no relevant delta since the cached
            # sweep (observe()/observe_step() dirty the entry through the
            # cache's reverse index, so staleness cannot be served)
            self.stats["cache_hits"] += 1
            res, comp, chosen = self.last_plan, self._plan_comp, self._chosen
            split = self._plan_split
        else:
            groups = [(wc, list(self.resident[wc]))
                      for wc in sorted(self.resident)]   # deterministic order
            wcs = [wc for wc, _ in groups]
            # moldable split-degree selection: price every candidate degree's
            # fork-join plan (each through its own cache slot) and keep the
            # one whose REALIZED schedule finishes first — strictly first, so
            # ties fall to the smallest degree and max_split=1 reproduces the
            # historical single-candidate tick exactly
            best = None
            for dgr in self._degrees:
                dag = self.build_dag(groups, split=dgr)
                n, src, dst, data, comp_nominal = dag
                cand_res, cand_comp, cand_nom, cand_entry = self._plan(
                    wcs, n, src, dst, data, comp_nominal, split=dgr)
                if dgr > 1:
                    self.stats["moldable_plans"] += 1
                fin = (self._realized_makespan(cand_res, cand_entry)
                       if len(self._degrees) > 1 else 0.0)
                if best is None or fin < best[0] - 1e-12 * max(1.0, best[0]):
                    best = (fin, dgr, dag, cand_res, cand_comp, cand_nom,
                            cand_entry)
            _, split, dag, res, comp, nom, entry = best
            self.last_dag = dag
            self.last_groups = groups
            self.last_plan, self.last_nominal = res, nom
            self._entry = entry
            self.stats["split_degree"] = split
            chosen = self._choose(len(groups), res, comp, split)
            self._plan_sig, self._plan_comp, self._chosen = sig, comp, chosen
            self._plan_split = split
        classes = sorted(self.resident)
        G = len(classes)
        # round-robin budget split across classes (same fairness idiom as
        # AdmissionQueue.drain): a bounded tick must not starve late classes
        takes = dict.fromkeys(classes, 0)
        if self.tick_budget is None:
            for wc in classes:
                takes[wc] = len(self.resident[wc])
        else:
            b = self.tick_budget
            while b > 0:
                progressed = False
                for wc in classes:
                    if b > 0 and takes[wc] < len(self.resident[wc]):
                        takes[wc] += 1
                        b -= 1
                        progressed = True
                if not progressed:
                    break
        degraded_mode = bool((self._slow >= self.monitor.threshold).any())
        out: list[Dispatch] = []
        for i, wc in enumerate(classes):
            if takes[wc] == 0:
                continue
            q = self.resident[wc]
            rs = [q.popleft() for _ in range(takes[wc])]
            pre, dec = i * split, G * split + i
            cls, on_cp = chosen[i]
            # micro-batch formation: coalesce class-mates while the batch's
            # estimated service time stays within latency_slack x the CEFT
            # path length -- growing past that would make the batch itself
            # the critical path, trading throughput for unbounded latency
            rate = float((self.costs.row(wc) * self._slow)[cls])
            per_req = max(rate * (wc[0] + wc[1]), 1e-12)
            bound = max(1, int(self.latency_slack * res.cpl / per_req))
            size = max(1, min(self.max_batch, bound))
            # micro-batches hold one *exact* prompt length each: the engines
            # have no padding mask, so mixing lengths inside one generate()
            # would condition shorter requests on filler tokens
            by_len: dict[int, list[Request]] = {}
            for r in rs:
                by_len.setdefault(int(r.prompt.shape[0]), []).append(r)
            chunks: list[list[Request]] = []
            for _, rl in sorted(by_len.items()):
                if size < len(rl):      # the latency bound itself partitioned
                    self.stats["split"] += 1
                chunks.extend(rl[k:k + size] for k in range(0, len(rl), size))
            for chunk in chunks:
                dl: float | None = None
                for r in chunk:
                    rd = r.deadline
                    if rd is not None:
                        dl = rd if dl is None else min(dl, rd)
                out.append(Dispatch(int(cls), chunk, wc, on_cp, pre, dec,
                                    split=split, deadline=dl))
        # the SLO plane only engages when a dispatch carries a deadline or
        # an engine is degraded: a best-effort steady-state tick must stay
        # O(classes + budget), so the propagation (memoized per plan entry)
        # is not even consulted on that path
        if degraded_mode or any(d.deadline is not None for d in out):
            D = self._deadline_view()
            if D is not None:
                for d in out:
                    d.slack = float(D.slack[d.node_decode])
        if degraded_mode:
            out = self._slo_shed(out)
        for d in out:
            self.stats["dispatches"] += 1
            self.stats["coalesced"] += len(d.requests) - 1
        # emptied classes leave the resident mix (and thus the plan signature)
        for wc in [wc for wc, q in self.resident.items() if not q]:
            del self.resident[wc]
        self.stats["resident"] = sum(len(q) for q in self.resident.values())
        return out

    def _slo_shed(self, out: list[Dispatch]) -> list[Dispatch]:
        """Slack-keyed shedding off degraded engines: of the
        dispatches the plan still placed on a monitor-degraded engine, the
        MOST-slack ones are held back (requeued for the next tick's re-plan)
        first — they can absorb the extra tick without missing their
        deadline, while the least-slack work keeps its slot rather than
        gambling its remaining budget on a requeue.  Bounded: a healthy
        engine must exist (else deferring is pure livelock) and at least one
        dispatch always goes out, so every tick makes progress."""
        slow_eng = {i for i in range(len(self._slow))
                    if self._slow[i] >= self.monitor.threshold}
        healthy = [i for i in self.pool.live_indices() if i not in slow_eng]
        if not healthy or len(out) <= 1:
            return out
        candidates = sorted(
            (d for d in out
             if d.engine in slow_eng and d.slack > self.planned_span(d)),
            key=lambda d: -d.slack)
        shed: list[Dispatch] = []
        for d in candidates:
            if len(out) - len(shed) <= 1:
                break
            shed.append(d)
        if shed:
            ids = {id(d) for d in shed}
            out = [d for d in out if id(d) not in ids]
            self._requeue(shed)
            self.stats["slo_shed"] += sum(len(d.requests) for d in shed)
        return out

    # -------------------------------------------------------------- execution
    def run_dispatch(self, d: Dispatch) -> dict[int, np.ndarray]:
        """Execute one micro-batch on its planned engine, feed the measured
        per-token rate back into the cost table, return {rid: tokens}."""
        lens = {int(r.prompt.shape[0]) for r in d.requests}
        if len(lens) != 1:
            # no padding mask in the engines: filler tokens would corrupt the
            # shorter requests' generations (tick() never mixes lengths)
            raise ValueError(f"micro-batch mixes prompt lengths {sorted(lens)}")
        prompts = np.stack([r.prompt for r in d.requests]).astype(np.int32)
        plen = prompts.shape[1]
        max_new = max(int(r.max_new) for r in d.requests)
        t0 = time.perf_counter()
        toks = self.pool.generate(d.engine, prompts,
                                  ServeConfig(max_new_tokens=max_new))
        dt = time.perf_counter() - t0
        # the engine generates the batch max_new for every row; charge the
        # rate for the work actually done and trim each row to its own budget
        self.observe(d.engine, d.wclass, dt, len(d.requests) * (plen + max_new))
        toks = np.asarray(toks)
        return {r.rid: toks[b, : plen + int(r.max_new)]
                for b, r in enumerate(d.requests)}

    def _requeue(self, ds: list[Dispatch],
                 done: dict[int, np.ndarray] | None = None) -> None:
        """Put un-served dispatches back at the FRONT of their resident
        queues (FIFO order preserved) so the next tick re-plans them.
        ``done`` filters out requests another attempt (a hedge, a recovered
        original) already completed — re-serving those would waste work and
        break the exactly-once accounting."""
        for d in ds:
            reqs = (d.requests if done is None
                    else [r for r in d.requests if r.rid not in done])
            if not reqs:
                continue
            q = self.resident.setdefault(d.wclass, deque())
            for r in reversed(reqs):
                q.appendleft(r)
            self.stats["requeued"] += len(reqs)
        self.stats["resident"] = sum(len(q) for q in self.resident.values())

    # ------------------------------------------------------- deadline watchdog
    def planned_span(self, d: Dispatch) -> float:
        """Expected service seconds for one micro-batch under the current
        cost table x straggler slowdowns — the same numbers its plan was
        priced with, so the watchdog enforces exactly what the plan
        promised.  The slowdown factor is capped: a monitor-degraded (or
        LOST-column) engine would otherwise inflate the budget toward
        infinity and disarm the watchdog exactly when it matters most.
        Hitting the cap is counted (``stats["clamped_budgets"]``): a clamped
        budget under-states a genuinely slower engine's span, so SLO misses
        caused by the cap must be observable, not silent."""
        rate = float(self.costs.row(d.wclass)[d.engine])
        slow = float(self._slow[d.engine]) if d.engine < len(self._slow) else 1.0
        if slow > 10.0:
            self.stats["clamped_budgets"] += 1
        return (rate * min(slow, 10.0)
                * len(d.requests) * (d.wclass[0] + d.wclass[1]))

    def _deadline_view(self) -> DeadlineSchedule | None:
        """The cached plan's backward deadline propagation, memoized on the
        plan-cache entry (``PlanEntry.derived``) so a steady-state tick never
        re-propagates: re-sweeps build a fresh entry (fresh memo slot) and
        byte-equal hits return the same entry, so the memo can never serve a
        schedule inconsistent with the plan it annotates."""
        entry = self._entry
        if entry is None:
            return None
        D = entry.derived.get("deadlines")
        if D is None:
            D = propagate_deadlines(entry.graph, entry.comp32, entry.machine,
                                    entry.result)
            entry.derived["deadlines"] = D
        return D

    def dispatch_budget(self, d: Dispatch) -> float:
        """The watchdog budget for one dispatch: the flat
        ``deadline_factor x planned_span`` when the batch is best-effort,
        else the tighter of that and the SLO's propagated latest-finish —
        ``latest_finish(decode) + remaining - makespan`` shifts the plan-
        relative latest finish onto the request's remaining budget (latest
        times are affine in the horizon, see repro_torch.sched.deadlines).  Floor-
        clamped by ``min_deadline`` so an already-blown SLO degrades to the
        fastest ladder, not a zero budget."""
        wd = self.watchdog
        flat = wd.budget(self.planned_span(d))
        if d.deadline is None:
            return flat
        rem = d.deadline - time.monotonic()
        D = self._deadline_view()
        if D is not None:
            rem = D.latest_finish_for(d.node_decode, rem)
        return max(wd.min_deadline, min(flat, rem))

    def _complete(self, d: Dispatch, out: dict[int, np.ndarray]) -> None:
        """First-attempt-wins completion: a rid already completed (by the
        hedge or the original, whichever returned first) has its late
        duplicate dropped and counted, never overwritten."""
        with self._serve_lock:
            if self._serve_done is None:
                return
            for rid, toks in out.items():
                if rid in self._serve_done:
                    self.stats["stale_replies"] += 1
                else:
                    self._serve_done[rid] = toks
                    self.stats["completions"] += 1

    def _on_overdue(self, entry: InflightEntry, now: float) -> None:
        """Watchdog callback — the escalation ladder, one rung per strike,
        keyed on the dispatch's remaining SLO budget where it has one:

        1. report the offender to the straggler monitor (its column trips
           the threshold, so the next plan sheds work off it); then either
           HEDGE — critical-path work, or SLO-critical work whose remaining
           budget cannot survive another strike (rem < budget): duplicate to
           the degraded plane's best alternate now, first result wins — or
           SHED — slack-rich work (rem >= 2 budgets): requeue immediately,
           it can absorb a re-plan round-trip, so it leaves the degraded
           engine first.  Best-effort / middling-slack work just waits for
           rung 2 (the historical ladder);
        2. requeue the dispatch — the next tick re-plans it elsewhere
           (first result wins; the stuck original is dropped as stale);
        3. the worker is treated as hung for good: mark_lost degrades its
           column and the entry leaves the watchdog.

        Runs on the monitor thread: it only touches the serve lock and the
        pool/monitor's own synchronized entry points; tick-side state (the
        resident queues) is reached via the ``_wd_requeue`` hand-off list
        drained on the serve thread."""
        d: Dispatch = entry.payload
        self.stats["overdue"] += 1
        if entry.on_critical_path:
            self.stats["overdue_cp"] += 1
        if entry.strikes == 1:
            self.monitor.report_overdue(entry.engine)
            self.stats["invalidations"] += self.plancache.invalidate(
                engine=entry.engine)
            self._plan_sig = None
            rem = None if d.deadline is None else d.deadline - now
            slo_critical = rem is not None and rem < entry.budget
            if ((entry.on_critical_path or slo_critical)
                    and self.hedge and not entry.hedged):
                entry.hedged = True
                if slo_critical and not entry.on_critical_path:
                    self.stats["slo_hedges"] += 1
                self._launch_hedge(entry)
            elif rem is not None and rem >= 2.0 * entry.budget:
                entry.shed = True
                self.stats["slo_shed"] += len(d.requests)
                with self._serve_lock:
                    self._wd_requeue.append(d)
        elif entry.strikes == 2:
            if not entry.shed:      # a strike-1 shed already requeued it
                with self._serve_lock:
                    self._wd_requeue.append(d)
        else:
            self.stats["watchdog_lost"] += 1
            self.watchdog.disarm(entry.seq)
            try:
                self.pool.mark_lost(
                    entry.engine,
                    f"watchdog: overdue past {entry.strikes} deadline budgets")
            except Exception:
                pass

    def _hedge_target(self, d: Dispatch) -> int | None:
        """The engine the batched degraded plane names as the best alternate
        for this dispatch's class — the same nominal+degraded re-plan the
        pool-loss path uses, re-priced with the offender's column degraded
        to LOST, run through a TRANSIENT (store=False) cache pass so hedge
        pricing can never poison the cached tick plans."""
        live = set(self.pool.live_indices())
        live.discard(d.engine)
        if not live:
            return None
        if self.last_dag is not None and self.last_groups is not None:
            try:
                n, src, dst, data, comp_nominal = self.last_dag
                slow = np.array(self._slow, np.float64, copy=True)
                if d.engine < len(slow):
                    slow[d.engine] = max(slow[d.engine], 1e6)
                comp = comp_nominal * slow[None, :]
                g = request_graph(n, src, dst, data)
                res, _, _ = self.plancache.plan(
                    g, comp, self._m_snapshot, slot="router-hedge",
                    classes=[wc for wc, _ in self.last_groups], store=False,
                    planner=self.planner)
                alt = res.assignment.get(d.node_decode,
                                         res.assignment.get(d.node_prefill))
                if alt is not None and int(alt) in live:
                    return int(alt)
                # the degraded path moved off this class entirely: take the
                # earliest-finish live engine for the decode vertex instead
                for c in np.argsort(res.ceft[d.node_decode]):
                    if int(c) in live:
                        return int(c)
            except Exception:
                pass
        return self._fallback_target(d, live)

    def _fallback_target(self, d: Dispatch, live: set[int]) -> int | None:
        """Rate-based alternate when no planned DAG is available (first-tick
        races): cheapest live engine for the class under current slowdowns."""
        if not live:
            return None
        row = self.costs.row(d.wclass)
        row = row * self._slow[: len(row)]
        for c in np.argsort(row):
            if int(c) in live:
                return int(c)
        return next(iter(live))

    def _launch_hedge(self, entry: InflightEntry) -> None:
        """Speculatively re-send an overdue critical-path dispatch to the
        degraded plane's best alternate.  First result wins via _complete's
        rid dedup; the hedge itself is armed on the watchdog (off-path, so
        it can never hedge recursively) and its failure requeues instead of
        raising — the original attempt (or a later requeue) still owns the
        requests."""
        d: Dispatch = entry.payload
        alt = self._hedge_target(d)
        if alt is None:
            return
        clone = dataclasses.replace(d, engine=int(alt))
        self.stats["hedges"] += 1

        def run():
            seq = next_seq()
            self.watchdog.arm(seq, clone, planned_span=self.planned_span(clone),
                              engine=clone.engine, on_critical_path=False,
                              budget=self.dispatch_budget(clone))
            try:
                out = self.run_dispatch(clone)
            except BaseException:
                with self._serve_lock:
                    self._wd_requeue.append(clone)
                return
            finally:
                self.watchdog.disarm(seq)
            self._complete(clone, out)

        t = threading.Thread(target=run, name=f"hedge-{alt}", daemon=True)
        self._hedge_threads.append(t)
        t.start()

    def serve(self, max_ticks: int = 64) -> dict[int, np.ndarray]:
        """Tick until the queue AND residents are empty (or max_ticks): the
        launcher's loop.  Disarmed (no watchdog) this IS the historical loop
        — byte-for-byte the unwatched behaviour; armed it adds deadline
        enforcement around the identical planning pipeline (tick() is
        untouched, so armed-no-fault plans stay bit-identical)."""
        if self.watchdog is None:
            return self._serve_plain(max_ticks)
        return self._serve_watched(max_ticks)

    def _serve_plain(self, max_ticks: int = 64) -> dict[int, np.ndarray]:
        """The disarmed serve loop (the historical code path).

        Each tick's micro-batches execute on one worker thread *per engine*
        (each engine runs its own dispatches in planned order): the CEFT
        makespan assumes the processor classes work in parallel, and the
        scoped-profile substrate makes concurrent engine traces safe.

        Failure semantics: a worker DEATH (:class:`WorkerLost` — a killed
        subprocess, a dead pipe) is degradation, not an abort.  The lost
        worker's pending dispatches re-enter the resident queues, the pool
        listener has already marked the class column fully degraded, and the
        next tick's nominal+degraded re-plan routes the in-flight workload
        to the survivors — their completed results are kept throughout.
        Each loss is recorded in ``self.failures`` with per-engine context.
        Engine ERRORS (an exception from a live engine) still fail the loop
        loudly, all concurrent failures aggregated — a silent partial result
        dict would pass smoke runs.  Losing the LAST live worker raises,
        aggregating every recorded loss."""
        done: dict[int, np.ndarray] = {}
        lock = threading.Lock()
        for _ in range(max_ticks):
            if not len(self.queue) and not self.resident:
                break
            if not self.pool.live_indices():
                agg = RuntimeError(
                    f"no live pool workers remain ({len(self.failures)} "
                    "lost): "
                    + "; ".join(f"{name}: {type(e).__name__}: {e}"
                                for name, e in self.failures))
                agg.failures = list(self.failures)
                raise agg
            errors: list[tuple[str, BaseException]] = []
            lost: list[tuple[str, WorkerLost, list[Dispatch]]] = []
            per_engine: dict[int, list[Dispatch]] = {}
            for d in self.tick():
                per_engine.setdefault(d.engine, []).append(d)

            def worker(name: str, ds: list[Dispatch]):
                for i, d in enumerate(ds):
                    try:
                        out = self.run_dispatch(d)
                    except WorkerLost as e:   # degradation: requeue the rest
                        with lock:
                            lost.append((name, e, ds[i:]))
                        return
                    except BaseException as e:  # surfaced after join, not lost
                        with lock:
                            errors.append((name, e))
                        return
                    with lock:
                        done.update(out)

            threads = [threading.Thread(target=worker,
                                        args=(self.slots[eng].name, ds))
                       for eng, ds in per_engine.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for name, e, pending in lost:
                self.failures.append((name, e))
                self._requeue(pending)
            if errors:
                # dead engines must fail the serve loop loudly -- silently
                # returning a partial result dict would pass smoke runs --
                # and ALL concurrent failures must surface: raising only the
                # first dropped every other engine's error on the floor
                if len(errors) == 1:
                    raise errors[0][1]
                agg = RuntimeError(
                    f"{len(errors)} engines failed concurrently: "
                    + "; ".join(f"{name}: {type(e).__name__}: {e}"
                                for name, e in errors))
                agg.failures = list(errors)   # originals, per-engine context
                raise agg from errors[0][1]
        return done

    def _serve_watched(self, max_ticks: int = 64) -> dict[int, np.ndarray]:
        """The armed serve loop: the same admit/plan/dispatch pipeline as
        the plain loop, with every dispatch armed on the deadline watchdog
        and completion made first-attempt-wins (rid dedup in _complete).

        Fault-containment differences from the plain loop:

        * every attempt carries ``deadline_factor x planned_span``; overdue
          attempts walk the _on_overdue ladder (report+hedge / requeue /
          mark_lost),
        * engine worker threads are joined with a CAPPED timeout — a thread
          stuck in an unreleasable hang is abandoned (daemon), its
          un-completed dispatches requeued and already counted toward the
          offender's strikes, instead of blocking serve forever,
        * budget-eligible lost workers are relaunched each tick through the
          pool's bounded exponential backoff.
        """
        wd = self.watchdog
        with self._serve_lock:
            self._serve_done = {}
            self._wd_requeue = []
        wd.start()
        max_budget = wd.min_deadline
        try:
            for _ in range(max_ticks):
                with self._serve_lock:
                    pending_wd, self._wd_requeue = self._wd_requeue, []
                    done_view = dict(self._serve_done)
                self._requeue(pending_wd, done=done_view)
                self.pool.maybe_relaunch_lost()
                if not len(self.queue) and not self.resident:
                    # queue drained: wait out in-flight attempts (hedges,
                    # abandoned originals) — their completions land in
                    # _serve_done, their strikes may still requeue work
                    t_end = time.monotonic() + 1.0 + 4.0 * max_budget
                    while wd.inflight() and time.monotonic() < t_end:
                        time.sleep(min(wd.poll_interval, 0.01))
                    with self._serve_lock:
                        pending_wd, self._wd_requeue = self._wd_requeue, []
                        done_view = dict(self._serve_done)
                    self._requeue(pending_wd, done=done_view)
                    if not len(self.queue) and not self.resident:
                        break
                    continue
                if not self.pool.live_indices():
                    agg = RuntimeError(
                        f"no live pool workers remain ({len(self.failures)} "
                        "lost): "
                        + "; ".join(f"{name}: {type(e).__name__}: {e}"
                                    for name, e in self.failures))
                    agg.failures = list(self.failures)
                    raise agg
                errors: list[tuple[str, BaseException]] = []
                lost: list[tuple[str, WorkerLost, list[Dispatch]]] = []
                lock = threading.Lock()
                per_engine: dict[int, list[Dispatch]] = {}
                for d in self.tick():
                    per_engine.setdefault(d.engine, []).append(d)
                for ds in per_engine.values():
                    for d in ds:
                        max_budget = max(max_budget,
                                         wd.budget(self.planned_span(d)))
                progress = {eng: 0 for eng in per_engine}

                def worker(eng: int, name: str, ds: list[Dispatch]):
                    for i, d in enumerate(ds):
                        seq = next_seq()
                        # armed from the propagated latest-finish when the
                        # batch carries an SLO, the flat budget otherwise
                        wd.arm(seq, d, planned_span=self.planned_span(d),
                               engine=eng,
                               on_critical_path=d.on_critical_path,
                               budget=self.dispatch_budget(d))
                        try:
                            out = self.run_dispatch(d)
                        except WorkerLost as e:
                            with lock:
                                lost.append((name, e, ds[i:]))
                                progress[eng] = len(ds)  # loss path requeues
                            return
                        except BaseException as e:
                            with lock:
                                errors.append((name, e))
                                progress[eng] = len(ds)
                            return
                        finally:
                            wd.disarm(seq)
                        self._complete(d, out)
                        with lock:
                            progress[eng] = i + 1

                threads = [(eng, threading.Thread(
                                target=worker,
                                args=(eng, self.slots[eng].name, ds),
                                daemon=True))
                           for eng, ds in per_engine.items()]
                for _, t in threads:
                    t.start()
                # capped join: long enough for every planned span plus the
                # full three-strike ladder, short enough that an
                # unreleasable hang cannot wedge the loop
                deadline = time.monotonic() + 1.0 + 4.0 * max_budget
                for eng, t in threads:
                    t.join(timeout=max(0.0, deadline - time.monotonic()))
                    if t.is_alive():
                        # abandon the stuck thread (daemon; a late result is
                        # deduped by rid) and take back its unfinished work
                        with lock:
                            done_at = progress[eng]
                        name = self.slots[eng].name
                        e = WorkerLost(name, eng, "hung past join deadline")
                        with lock:
                            lost.append((name, e, per_engine[eng][done_at:]))
                        try:
                            self.pool.mark_lost(eng, "hung past join deadline")
                        except Exception:
                            pass
                with self._serve_lock:
                    done_view = dict(self._serve_done)
                for name, e, pending in lost:
                    self.failures.append((name, e))
                    self._requeue(pending, done=done_view)
                if errors:
                    if len(errors) == 1:
                        raise errors[0][1]
                    agg = RuntimeError(
                        f"{len(errors)} engines failed concurrently: "
                        + "; ".join(f"{name}: {type(e).__name__}: {e}"
                                    for name, e in errors))
                    agg.failures = list(errors)
                    raise agg from errors[0][1]
        finally:
            wd.stop()
        with self._serve_lock:
            done, self._serve_done = self._serve_done, None
        return done
