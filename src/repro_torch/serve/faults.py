"""Deterministic fault injection for the serving plane (chaos harness).

Invariant: **faults enter only through the wrapper seam**.  Everything that
can *break* a pool worker on purpose lives here — this module is the only
place allowed to attach to :meth:`EnginePool.add_handle_wrapper`
(the reference's ``scripts/ci.sh`` greps that the hook stays private to it), so production
code paths contain zero fault branches: disarmed, the pool runs the exact
bytes a chaos run exercises, and a fault can never hide in router/pool
logic where it would fire outside a chaos soak.  The injector
wraps every worker handle (both backends: inproc and subprocess) with a proxy
that consults a :class:`FaultPlan` — a scripted or seed-derived schedule of
faults keyed by (worker index, per-worker generate-call number) — and fails
the call the way real infrastructure fails:

=============  ==============================================================
``delay``      sleep before forwarding (a transient stall, below loss)
``hang``       block until released — the unreachable-worker case the
               deadline watchdog exists for; released hangs surface as
               :class:`WorkerLost`
``kill``       SIGKILL the subprocess child mid-call (inproc: synthesize the
               resulting :class:`WorkerLost`), so the parent sees a dead pipe
``drop``       run the work, drop the reply, surface :class:`WorkerLost` —
               the request executed but the caller can never know
``corrupt``    write garbage bytes into the protocol stream (subprocess: the
               real framing layer must convert the desync to
               :class:`WorkerLost`; inproc: synthesized)
``dup``        run the work but HOLD the reply past the deadline budget and
               return it late — the duplicate-reply case: a hedge wins the
               race and the late original must be dropped by rid dedup
               (``stats["stale_replies"]``), never double-completed
=============  ==============================================================

Determinism: :meth:`FaultPlan.seeded` derives the whole schedule from one
integer seed via ``random.Random`` — the same seed replays the same faults at
the same call numbers on the same workers, which is what lets a
chaos soak run as a *smoke test* instead of a flake generator.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time

from .pool import EnginePool, WorkerLost

# Fault kinds the injector understands (see module docstring table).
KINDS = ("delay", "hang", "kill", "drop", "corrupt", "dup")


@dataclasses.dataclass
class Fault:
    """One scheduled fault: fires on worker ``worker``'s ``call``-th
    generate() (1-based, counted per worker)."""
    worker: int
    call: int
    kind: str
    param: float = 0.0     # delay/dup hold seconds; unused otherwise

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {KINDS})")


class FaultPlan:
    """A schedule of :class:`Fault`\\ s, scripted or seed-derived."""

    def __init__(self, faults: list[Fault] | None = None):
        self._by_slot: dict[tuple[int, int], Fault] = {}
        for f in faults or []:
            self.add(f.worker, f.call, f.kind, f.param)

    def add(self, worker: int, call: int, kind: str,
            param: float = 0.0) -> "FaultPlan":
        self._by_slot[(int(worker), int(call))] = Fault(
            int(worker), int(call), kind, float(param))
        return self

    def pop(self, worker: int, call: int) -> Fault | None:
        return self._by_slot.pop((int(worker), int(call)), None)

    def __len__(self) -> int:
        return len(self._by_slot)

    @classmethod
    def seeded(cls, seed: int, workers: int, *, calls: int = 10,
               rate: float = 0.25, kinds: tuple = KINDS,
               delay: float = 0.05, hold: float = 0.5) -> "FaultPlan":
        """Derive a full schedule from one integer seed: each of the first
        ``calls`` generate() calls on each worker independently draws a fault
        with probability ``rate``.  Worker 0 is exempted from ``kill`` and
        ``hang`` on its first call so a seeded soak can never open by losing
        every worker before any request completes (the soak asserts
        exactly-once, not survival-of-zero-workers)."""
        rng = random.Random(int(seed))
        plan = cls()
        for w in range(int(workers)):
            for c in range(1, int(calls) + 1):
                if rng.random() >= rate:
                    continue
                kind = rng.choice(list(kinds))
                if w == 0 and c == 1 and kind in ("kill", "hang"):
                    kind = "delay"
                param = delay if kind == "delay" else hold
                plan.add(w, c, kind, param)
        return plan


class FaultInjector:
    """Installs a :class:`FaultPlan` on a pool via the public handle-wrapper
    seam; owns the hang-release latch and the per-kind fired counters."""

    def __init__(self, plan: FaultPlan, *, hang_timeout: float = 60.0):
        self.plan = plan
        self.hang_timeout = float(hang_timeout)
        self.stats = {k: 0 for k in KINDS}
        self.stats["calls"] = 0
        self._lock = threading.Lock()
        self._calls: dict[int, int] = {}
        self._release = threading.Event()

    def install(self, pool: EnginePool) -> "FaultInjector":
        pool.add_handle_wrapper(self._wrap)
        return self

    def release(self) -> None:
        """Release every in-flight injected hang (they surface as
        :class:`WorkerLost`).  Idempotent.  Deliberately NOT fired by handle
        close(): mark_lost closes handles, and a kill on one worker must not
        cut every other worker's hang short — ``hang_timeout`` bounds the
        abandoned threads instead."""
        self._release.set()

    # ----------------------------------------------------------- wrapping
    def _wrap(self, idx: int, handle):
        return _FaultyHandle(self, idx, handle)

    def _next_call(self, idx: int) -> int:
        with self._lock:
            n = self._calls.get(idx, 0) + 1
            self._calls[idx] = n
            self.stats["calls"] += 1
            return n


class _FaultyHandle:
    """Worker-handle proxy: forwards the handle protocol, injecting the
    plan's fault (if any) for each generate() call.  Private to this module —
    production code never sees fault machinery."""

    def __init__(self, injector: FaultInjector, idx: int, inner):
        self._injector = injector
        self._idx = idx
        self._inner = inner
        self._name = getattr(inner, "_name", f"engine{idx}")

    # anything else the pool reads off a handle (engine, proc, topology)
    # passes straight through, so pool.slots / worker_pid keep working
    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def generate(self, prompts, scfg):
        inj = self._injector
        fault = inj.plan.pop(self._idx, inj._next_call(self._idx))
        if fault is None:
            return self._inner.generate(prompts, scfg)
        inj.stats[fault.kind] += 1
        if fault.kind == "delay":
            time.sleep(fault.param)
            return self._inner.generate(prompts, scfg)
        if fault.kind == "hang":
            inj._release.wait(timeout=inj.hang_timeout)
            raise WorkerLost(self._name, self._idx, "injected hang released")
        if fault.kind == "kill":
            proc = getattr(self._inner, "proc", None)
            if proc is not None:
                proc.kill()
                # the forwarded call now reads a dead pipe: the transport's
                # own EOF/WorkerLost path is what gets exercised
                return self._inner.generate(prompts, scfg)
            raise WorkerLost(self._name, self._idx, "injected kill")
        if fault.kind == "drop":
            try:
                self._inner.generate(prompts, scfg)
            except Exception:
                pass
            raise WorkerLost(self._name, self._idx, "injected reply drop")
        if fault.kind == "corrupt":
            proc = getattr(self._inner, "proc", None)
            if proc is not None and proc.stdin is not None:
                try:
                    # garbage into the live protocol stream: the child's
                    # framing cap rejects the bogus length header and exits,
                    # and the forwarded call surfaces the desync as
                    # WorkerLost through the REAL framing layer
                    proc.stdin.write(b"\xde\xad\xbe\xef" * 4)
                    proc.stdin.flush()
                except Exception:
                    pass
                return self._inner.generate(prompts, scfg)
            raise WorkerLost(self._name, self._idx, "injected corrupt frame")
        if fault.kind == "dup":
            # duplicate-reply: do the work, hold the reply past any sane
            # deadline budget, then return it LATE -- by then a hedge has
            # won the race and this completion must be dropped as stale
            out = self._inner.generate(prompts, scfg)
            time.sleep(fault.param)
            return out
        raise AssertionError(f"unhandled fault kind {fault.kind!r}")

    def probe(self, payload):
        return self._inner.probe(payload)

    def ping(self):
        return self._inner.ping()

    def close(self):
        return self._inner.close()


def install_chaos(pool: EnginePool, seed: int, *, calls: int = 10,
                  rate: float = 0.25, hold: float = 0.5) -> FaultInjector:
    """The launcher's one-call chaos entry point: seed -> plan -> injector."""
    plan = FaultPlan.seeded(seed, pool.size, calls=calls, rate=rate, hold=hold)
    return FaultInjector(plan).install(pool)
