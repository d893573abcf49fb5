"""Unified plan cache: invalidate-don't-recompute for the planning path.

This module is the single owner of the port's cached planning state, in three
layers:

* **Graph store** (:func:`graph_for`) — content-keyed LRU mapping edge
  arrays to built :class:`TaskGraph` objects.  Structurally-equal arrays map
  to the SAME object, which is what makes the identity-keyed device-state
  store below hit for callers that rebuild their DAG every tick.
* **Device-state store** (:func:`device_state`) — LRU keyed by graph identity
  and device, holding each graph's fused run tables *on that device* (runs,
  source ids, v_b, per-run level spans), so a re-sweep with a new cost plane
  uploads only the plane.  TaskGraph is frozen and entries pin the graph
  object, so identity keying cannot go stale.
* **Plan store** (:class:`PlanCache`) — (slot, planner, graph, machine)-keyed
  plans with their per-run carry snapshots, a reverse index from workload
  class to the plans whose DAG contains it, and dirty-frontier re-sweeps.
  The planner name comes from the ``core/planners.py`` registry: CEFT keeps
  the device CSR sweep, list-scheduling planners go through a host path
  that still populates the cache and the reverse index.

Invariant: **invalidate-don't-recompute** — a cost delta may only SKIP work,
never change the resulting schedule.  Invalidation is therefore advisory — it
marks plans dirty through the reverse index — while :meth:`PlanCache.plan`
always byte-compares the stored float32 cost plane against the requested one
before reusing anything.  Equal bytes => the cached result IS the
from-scratch result; changed bytes => re-sweep, resuming at the lowest fused
run whose level span contains a changed row (levels are longest-path depth,
so each vertex is written exactly once, in its own run — the carry entering a
run depends only on comp rows of the levels below it, making run-granular
resume bit-identical to a full sweep).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
import numpy as np

from ..core import ceft_torch, planners
from ..core.ceft import CeftResult, _finalize
from ..core.planners import Plan
from ..core.machine import Machine
from ..core.taskgraph import TaskGraph, from_edge_arrays, graph_fingerprint

_LOCK = threading.RLock()

# content-keyed graph store: equal edge arrays -> the same TaskGraph object,
# LRU-bounded so a caller serving many DAG shapes keeps its recent working set
_GRAPH_STORE: OrderedDict[tuple, TaskGraph] = OrderedDict()
GRAPH_STORE_CAP = 64

# device-state store: (id(graph), device) -> (graph, runs, srcs, v_b, spans).
# Entries hold a strong reference to the graph so the id cannot be recycled
# while the entry lives.
_DEVICE_STATE: OrderedDict[tuple, tuple] = OrderedDict()
DEVICE_STATE_CAP = 16


def graph_for(n: int, src, dst, data) -> TaskGraph:
    """The TaskGraph for edge arrays, content-keyed: equal arrays return the
    SAME object (so identity-keyed device state hits), racing builders agree
    on one winner."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    key = (int(n), src.tobytes(), dst.tobytes(), data.tobytes())
    with _LOCK:
        g = _GRAPH_STORE.get(key)
        if g is not None:
            _GRAPH_STORE.move_to_end(key)
            return g
    g = from_edge_arrays(n, src, dst, data)
    with _LOCK:
        # first inserter wins: concurrent builders of the same key must all
        # hand out one object or the device-state identity cache splits
        g = _GRAPH_STORE.setdefault(key, g)
        _GRAPH_STORE.move_to_end(key)
        while len(_GRAPH_STORE) > GRAPH_STORE_CAP:
            _GRAPH_STORE.popitem(last=False)
    return g


def device_state(g: TaskGraph, device):
    """(device runs, source ids, v_b, run level spans) for one graph on one
    device, identity-cached.  Built by
    :func:`ceft_torch._build_device_state`; this store only owns the
    lifetime."""
    device = ceft_torch.resolve_device(device)
    key = (id(g), str(device))
    with _LOCK:
        entry = _DEVICE_STATE.get(key)
        if entry is not None:
            _DEVICE_STATE.move_to_end(key)
            return entry[1], entry[2], entry[3], entry[4]
    built = (g,) + ceft_torch._build_device_state(g, device)
    with _LOCK:
        entry = _DEVICE_STATE.setdefault(key, built)
        _DEVICE_STATE.move_to_end(key)
        while len(_DEVICE_STATE) > DEVICE_STATE_CAP:
            _DEVICE_STATE.popitem(last=False)
    return entry[1], entry[2], entry[3], entry[4]


def machine_fingerprint(m: Machine) -> bytes:
    """Content digest of a machine (latencies, bandwidths, class counts)."""
    h = hashlib.sha1()
    for a in (m.L, m.bw, m.counts):
        a = np.ascontiguousarray(a)
        h.update(a.dtype.str.encode())
        h.update(np.asarray(a.shape, np.int64).tobytes())
        h.update(a.tobytes())
    return h.digest()


@dataclasses.dataclass
class PlanEntry:
    """One cached swept plan plus everything needed to resume it."""
    graph: TaskGraph
    machine: Machine
    comp32: np.ndarray            # (v, P) float32 plane the result was swept with
    result: CeftResult | Plan     # CeftResult (CSR path) or Plan (host path)
    carries: list                 # per-run carry snapshots (device tensors)
    classes: frozenset            # workload classes whose vertices the DAG holds
    dirty: bool = False           # advisory: a relevant delta landed since the sweep
    derived: dict = dataclasses.field(default_factory=dict)  # e.g. cpop memos


class PlanCache:
    """Content-keyed swept plans with reverse-index invalidation and
    dirty-frontier partial re-sweeps.

    ``plan`` statuses: ``"hit"`` (stored plane byte-equal — zero sweeps),
    ``"partial"`` (resumed at the lowest dirty fused run, reusing the cached
    carry for the clean prefix), ``"full"``.  All three return results
    bit-identical to a from-scratch sweep; see the module docstring for why.

    Thread-safe: one RLock serializes plan/invalidate, so concurrent
    ``observe()``/``maybe_replan`` callers can never read a torn reverse
    index or a half-updated entry.

    ``device`` is where the CEFT sweeps run: the card unless the caller
    passes ``device="cpu"`` (asking for CUDA without it raises here).
    """

    def __init__(self, capacity: int = 128, *, device="cuda"):
        self.device = ceft_torch.resolve_device(device)
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._plans: OrderedDict[tuple, PlanEntry] = OrderedDict()
        self._by_class: dict[object, set[tuple]] = {}
        self.counters = {"hits": 0, "full_sweeps": 0, "partial_sweeps": 0,
                         "invalidations": 0}

    # ------------------------------------------------------------------ keys
    @staticmethod
    def key(g: TaskGraph, m: Machine, slot=None,
            planner: str = "ceft_cpop") -> tuple:
        return (slot, planner, graph_fingerprint(g), machine_fingerprint(m))

    # -------------------------------------------------------------- planning
    def plan(
        self, g: TaskGraph, comp: np.ndarray, m: Machine, *,
        slot=None, classes=None, planner: str = "ceft_cpop",
        store: bool = True,
    ) -> tuple[CeftResult | Plan, str, PlanEntry]:
        """Plan ``(g, comp, m)`` with the named planner, reusing as much
        cached work as the actual byte-level deltas allow.

        ``slot`` namespaces independent planes over the same graph/machine
        (the router's nominal vs degraded scenarios, the straggler baseline).
        ``classes`` registers the plan under those workload classes in the
        reverse index, so targeted :meth:`invalidate` calls can find it.
        ``planner`` selects the registered planner (``core/planners.py``):
        CEFT-consuming planners keep the device CSR sweep below and
        return a :class:`CeftResult`; list-scheduling planners take a host
        path that returns a full :class:`Plan` — both still populate the
        cache, the reverse index, and the hit/full counters, and both verify
        a byte-equal cost plane before serving anything cached (a host plan
        is a deterministic function of the float32 plane, so byte-equality
        implies result-equality exactly as for the sweep).
        ``store=False`` makes the pass TRANSIENT: a miss still reads (and may
        resume from) the cached entry, but the fresh result is never stored —
        speculative pricing (the router's hedge re-plan) must not evict or
        overwrite the plans steady-state ticks are served from.
        Returns ``(result, status, entry)``.
        """
        comp32 = np.ascontiguousarray(comp, np.float32)
        spec = planners.get_planner(planner)
        k = self.key(g, m, slot, planner=planner)
        with self._lock:
            entry = self._plans.get(k)
            if entry is not None and entry.comp32.shape == comp32.shape and \
                    entry.comp32.tobytes() == comp32.tobytes():
                # byte-equal plane: the cached result IS the from-scratch
                # result, whatever advisory invalidations happened meanwhile
                entry.dirty = False
                self._plans.move_to_end(k)
                self.counters["hits"] += 1
                return entry.result, "hit", entry

            if not spec.uses_ceft:
                # host path: no sweep, no carries — the planner runs on the
                # float64 view of the float32 plane so a byte-equal plane
                # always reproduces the identical plan
                result = planners.plan(
                    planner, g, comp32.astype(np.float64), m)
                entry = PlanEntry(
                    graph=g, machine=m, comp32=comp32.copy(), result=result,
                    carries=[],
                    classes=frozenset(classes) if classes is not None
                    else frozenset(),
                )
                self.counters["full_sweeps"] += 1
                if store:
                    self._store(k, entry)
                return result, "full", entry

            inputs = ceft_torch.csr_device_inputs(g, comp32, m, device=self.device)
            _, _, _, spans = device_state(g, self.device)
            resume_run = 0
            if entry is not None and entry.comp32.shape == comp32.shape:
                changed = np.nonzero(
                    (entry.comp32 != comp32).any(axis=1))[0]
                lo_level = int(g.level[changed].min())
                if lo_level >= 1:
                    # first run whose [lo, hi) span still contains dirty
                    # levels; runs below it (and the level-0 init) saw no
                    # comp change, so their cached carry is exact
                    for r, (lo, hi) in enumerate(spans):
                        if lo_level < hi:
                            resume_run = r
                            break
            if resume_run >= 1 and len(entry.carries) >= resume_run:
                carries = list(entry.carries[:resume_run])
                carry = ceft_torch.csr_sweep(
                    inputs, keep_carries=carries,
                    resume=(resume_run, entry.carries[resume_run - 1]))
                status = "partial"
                self.counters["partial_sweeps"] += 1
            else:
                carries = []
                carry = ceft_torch.csr_sweep(inputs, keep_carries=carries)
                status = "full"
                self.counters["full_sweeps"] += 1
            v = g.n
            ceft_arr, ptask, pproc = (c[:v].cpu().numpy() for c in carry)
            result = _finalize(g, ceft_arr.astype(np.float64), ptask, pproc)
            entry = PlanEntry(
                graph=g, machine=m, comp32=comp32.copy(), result=result,
                carries=carries,
                classes=frozenset(classes) if classes is not None
                else frozenset(),
            )
            if store:
                self._store(k, entry)
            return result, status, entry

    def _store(self, k: tuple, entry: PlanEntry) -> None:
        old = self._plans.pop(k, None)
        if old is not None:
            self._unindex(k, old)
        self._plans[k] = entry
        for c in entry.classes:
            self._by_class.setdefault(c, set()).add(k)
        while len(self._plans) > self.capacity:
            ek, ev = self._plans.popitem(last=False)
            ev.dirty = True          # holders of the evicted entry must replan
            self._unindex(ek, ev)

    def _unindex(self, k: tuple, entry: PlanEntry) -> None:
        for c in entry.classes:
            keys = self._by_class.get(c)
            if keys is not None:
                keys.discard(k)
                if not keys:
                    del self._by_class[c]

    # ---------------------------------------------------------- invalidation
    def invalidate(self, *, wclass=None, engine: int | None = None,
                   machine_fp: bytes | None = None) -> int:
        """Mark affected plans dirty; returns how many flipped clean->dirty.

        ``wclass`` scopes through the reverse index to plans whose DAG
        contains that workload class — deliberately conservative (DAG
        containment, not path membership): a cost delta on an off-path class
        can MOVE the critical path, so only plans that cannot see the class
        at all may stay clean.  ``engine`` deltas (straggler slowdowns)
        rescale a whole comp column and dirty every plan.  ``machine_fp``
        scopes to plans swept over one machine snapshot — the engine pool's
        hook for a measured comm-plane delta: plans keyed by the superseded
        snapshot's fingerprint can never be served for the new machine (the
        fingerprint is part of the key), so dirtying them just stops holders
        short-circuiting on stale entries.  Advisory either way:
        :meth:`plan` re-verifies bytes before serving anything.
        """
        with self._lock:
            if wclass is not None:
                keys = list(self._by_class.get(wclass, ()))
            elif machine_fp is not None:
                keys = [k for k in self._plans if k[3] == machine_fp]
            elif engine is not None:
                keys = list(self._plans.keys())
            else:
                keys = list(self._plans.keys())
            n = 0
            for k in keys:
                e = self._plans.get(k)
                if e is not None and not e.dirty:
                    e.dirty = True
                    n += 1
            self.counters["invalidations"] += n
            return n

    # -------------------------------------------------------------- plumbing
    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)


def clear_stores() -> None:
    """Drop the module-level graph / device-state stores (tests)."""
    with _LOCK:
        _GRAPH_STORE.clear()
        _DEVICE_STATE.clear()
