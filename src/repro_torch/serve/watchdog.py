"""Plan-derived deadline watchdog for the serving plane.

The paper's mutual-inclusivity claim says the CEFT plan already carries the
*expected finish time* of every task on its mapped engine class.  Until this
module that information was computed and thrown away: a worker that hung,
stalled, or silently dropped its reply blocked ``Router.serve`` forever.
Here the plan becomes an enforcement budget — every dispatch is armed with

    deadline = dispatch_ts + deadline_factor x planned_span

where ``planned_span`` is the dispatch's expected service time under the
current EWMA cost table x straggler slowdowns (the same numbers the plan was
priced with), floor-clamped by ``min_deadline`` so micro-second smoke spans
do not turn timer noise into false alarms.  A caller that knows better —
the router arming from a backward-propagated latest-finish
(repro_torch.sched.deadlines) — passes an explicit ``budget=`` to :meth:`arm` and
that budget replaces the flat multiple for the entry's whole ladder.

The watchdog is deliberately policy-free: it tracks in-flight entries, and a
monitor thread (or an explicit :meth:`sweep` call — tests drive this with an
injected clock) reports overdue entries to the ``on_overdue`` callback with a
strike count.  The *router* owns the response ladder (hedge / report /
requeue / mark_lost); this module only decides *when* the plan's promise was
broken.

Invariant (the reason escalation policy stays out of this file):
**one strike per budget** — after each strike the entry's deadline is pushed
by exactly one more of ITS OWN budget, so a stuck dispatch escalates strike
by strike instead of firing on every poll, and a three-strike ladder always
spans three budgets of wall clock regardless of the poll interval.  Nothing
in this module ever skips a rung or fires twice inside one budget.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable


@dataclasses.dataclass
class InflightEntry:
    """One armed dispatch attempt."""
    seq: int                     # dispatch-attempt sequence id (queue.next_seq)
    payload: object              # opaque to the watchdog (the router's Dispatch)
    engine: int                  # pool worker index the attempt runs on
    on_critical_path: bool
    planned_span: float          # expected service seconds from the plan
    t0: float                    # arm time (watchdog clock)
    deadline: float              # absolute time the plan's budget expires
    budget: float = 0.0          # per-strike push (flat or SLO-propagated)
    strikes: int = 0             # overdue sweeps that have fired on this entry
    hedged: bool = False         # a speculative clone was already sent
    shed: bool = False           # already requeued by a slack-keyed strike


class DeadlineWatchdog:
    """Sweeps in-flight dispatches against their plan-derived deadlines.

    ``on_overdue(entry, now)`` fires once per strike, outside the internal
    lock (handlers take their own locks — the router's, the pool's).  The
    monitor thread (:meth:`start`) polls every ``poll_interval`` seconds;
    deterministic tests skip the thread and call :meth:`sweep` with an
    explicit ``now`` from an injected ``clock``.
    """

    def __init__(self, *, deadline_factor: float = 3.0,
                 min_deadline: float = 0.05, poll_interval: float = 0.01,
                 clock: Callable[[], float] = time.monotonic,
                 on_overdue: Callable | None = None):
        self.deadline_factor = float(deadline_factor)
        self.min_deadline = float(min_deadline)
        self.poll_interval = float(poll_interval)
        self.clock = clock
        self.on_overdue = on_overdue
        self._lock = threading.Lock()
        self._inflight: dict[int, InflightEntry] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.stats = {"armed": 0, "completed": 0, "overdue": 0, "sweeps": 0}

    # --------------------------------------------------------------- tracking
    def budget(self, planned_span: float) -> float:
        """The enforcement budget for one planned span, floor-clamped."""
        return max(self.deadline_factor * float(planned_span),
                   self.min_deadline)

    def arm(self, seq: int, payload, *, planned_span: float, engine: int,
            on_critical_path: bool,
            budget: float | None = None) -> InflightEntry:
        """Track one attempt.  ``budget=None`` (historical behaviour) uses
        the flat ``deadline_factor x planned_span``; an explicit budget — the
        router's SLO-propagated latest-finish — replaces it, floor-clamped by
        ``min_deadline``, and drives every later strike push too."""
        now = self.clock()
        b = (self.budget(planned_span) if budget is None
             else max(float(budget), self.min_deadline))
        entry = InflightEntry(
            seq=int(seq), payload=payload, engine=int(engine),
            on_critical_path=bool(on_critical_path),
            planned_span=float(planned_span), t0=now,
            deadline=now + b, budget=b)
        with self._lock:
            self._inflight[entry.seq] = entry
            self.stats["armed"] += 1
        return entry

    def disarm(self, seq: int) -> InflightEntry | None:
        """Completion (or abandonment): stop watching the attempt."""
        with self._lock:
            entry = self._inflight.pop(int(seq), None)
            if entry is not None:
                self.stats["completed"] += 1
        return entry

    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    # --------------------------------------------------------------- sweeping
    def sweep(self, now: float | None = None) -> list[InflightEntry]:
        """Fire one strike on every overdue entry; returns them.

        Each fired entry's deadline is pushed by one more of ITS OWN budget
        (flat or SLO-propagated, whatever it was armed with) before the
        callback runs, so a still-stuck dispatch escalates one strike per
        budget rather than once per poll, and a handler that disarms the
        entry (mark_lost) simply stops the ladder."""
        now = self.clock() if now is None else now
        with self._lock:
            self.stats["sweeps"] += 1
            fired = []
            for entry in self._inflight.values():
                if entry.deadline <= now:
                    entry.strikes += 1
                    entry.deadline = now + (entry.budget if entry.budget > 0.0
                                            else self.budget(entry.planned_span))
                    self.stats["overdue"] += 1
                    fired.append(entry)
        if self.on_overdue is not None:
            for entry in fired:
                self.on_overdue(entry, now)
        return fired

    # ---------------------------------------------------------- monitor thread
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.poll_interval):
                self.sweep()

        self._thread = threading.Thread(
            target=loop, name="deadline-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
