"""The placement plane: an elastic engine pool.

Everything that knows *where computation lives* sits in this module.  The
Router above plans over processor classes; this pool owns the classes'
physical reality — worker lifecycle (launch, drain, loss), the transport to
each worker, and the *measured* communication plane between workers — and
exposes it as the paper's :class:`~repro_torch.core.machine.Machine` view through
:meth:`EnginePool.machine`.

Two worker backends:

* ``inproc`` (default) — any in-process object with
  ``generate(prompts, ServeConfig)``, held directly.  Keeps the tests
  hermetic and is bit-identical to a direct-engine Router for a fixed
  snapshot.
* ``subprocess`` — a worker process speaking a small length-framed
  pickle-over-pipe protocol (``init`` / ``generate`` / ``probe`` / ``ping``
  / ``close``).  The engine is built inside the child from a
  ``"module:callable"`` factory path, so the parent never pickles live
  engines.  A dead pipe surfaces as :class:`WorkerLost`.

Comm-plane measurement: with ``probe="measure"`` (or an injected callable,
for determinism in tests) the pool times a payload transfer leg per worker —
in this architecture KV handoffs between workers are parent-relayed, so the
pair cost a→b is the measured egress leg of a plus the ingress leg of b —
EWMA-smooths the rates, and quantizes them onto a sqrt2 grid so the Machine
snapshot (and hence the plan cache's machine fingerprint) only changes when
a measurement moves materially, not on every probe.  A snapshot change
notifies listeners, which feed ``sched/plancache`` invalidation.  With
``probe="static"`` the plane is the fixed proxy (``router_machine``),
byte-stable forever.

Failure as degradation: a lost worker KEEPS its slot (its processor-class
column).  Listeners (the Router) mark the column fully degraded in the
StragglerMonitor, and the existing batched nominal+degraded re-plan routes
the critical path around it — failover needs no new planner code.  Launching
into a freed slot revives the column.

Worker lifecycle state (``_WorkerState``, the subprocess protocol, the
worker bootstrap) is private to this module.  A subprocess worker imports
this package, never the reference's, and a host-only engine (such as
:func:`null_engine_factory`) never starts CUDA in the child.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import pickle
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from ..core.machine import Machine
from ..substrate import process_topology


class _WorkerState:
    """Lifecycle states, private to the pool."""
    LIVE = "live"
    DRAINED = "drained"
    LOST = "lost"


class WorkerLost(RuntimeError):
    """A worker died (process exit, broken pipe, a corrupt protocol frame, or
    an injected loss).

    Carries per-engine context so serve-loop error handling can report which
    pool member failed without string-parsing."""

    def __init__(self, name: str, index: int, cause: str = "worker lost"):
        super().__init__(f"{name} (engine {index}): {cause}")
        self.engine_name = name
        self.index = index
        self.cause = cause


class FrameError(RuntimeError):
    """The length-framed pickle stream is corrupt (bad header, truncated
    body, garbage payload bytes).  The transport cannot resynchronize a
    corrupt stream, so the worker layer converts this to :class:`WorkerLost`
    with per-engine context — never a hang, never a raw ``EOFError``."""


@dataclasses.dataclass
class EngineSlot:
    """One pool member as the Router sees it: anything with
    ``generate(prompts, ServeConfig)``, pinned to a sharding profile."""
    name: str
    engine: object
    profile: str


@dataclasses.dataclass
class WorkerSpec:
    """How to (re)create one worker.  ``engine`` holds a live object for
    inproc workers; ``factory`` is a ``"module:callable"`` path built inside
    the child for subprocess workers (the parent never pickles engines)."""
    name: str
    profile: str = "baseline"
    engine: object = None
    factory: str | None = None
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    backend: str = "inproc"


def null_engine_factory():
    """Cheapest poolable engine: zero tokens, numpy only (tests/benches)."""
    class _Null:
        def generate(self, prompts, scfg):
            B, P = np.asarray(prompts).shape
            return np.zeros((B, P + scfg.max_new_tokens), np.int32)
    return _Null()


def smoke_engine_factory(arch: str, profile: str, device="cuda"):
    """A real smoke-scale :class:`Engine` (built inside the worker, in the
    child for subprocess workers); on the card unless ``device="cpu"``."""
    from .. import configs as C
    from .engine import Engine
    return Engine(C.get(arch, smoke=True), profile=profile, device=device)


# ----------------------------------------------------------------- transport
# Sanity cap on one frame: a corrupt header decodes to a random 64-bit
# length; without the cap the reader blocks trying to consume exabytes (a
# hang), with it the garbage surfaces immediately as FrameError.
_MAX_FRAME = 1 << 31


def _send_msg(fobj, obj) -> None:
    b = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    fobj.write(struct.pack("<Q", len(b)))
    fobj.write(b)
    fobj.flush()


def _recv_msg(fobj):
    hdr = fobj.read(8)
    if len(hdr) < 8:
        raise EOFError("pipe closed")
    (n,) = struct.unpack("<Q", hdr)
    if n > _MAX_FRAME:
        raise FrameError(f"frame length {n} exceeds cap (corrupt header)")
    b = fobj.read(n)
    if len(b) < n:
        raise EOFError(f"pipe closed mid-message (truncated frame: "
                       f"{len(b)}/{n} bytes)")
    try:
        return pickle.loads(b)
    except BaseException as e:
        raise FrameError(
            f"corrupt frame payload: {type(e).__name__}: {e}") from e


def _worker_main() -> None:  # pragma: no cover - runs in the child process
    """Subprocess worker loop: framed pickle requests on stdin, replies on
    the ORIGINAL stdout (sys.stdout is re-pointed at stderr first, so engine
    prints cannot corrupt the protocol stream).

    Every request carries a monotonic sequence id and every reply echoes it:
    the parent matches replies to requests by seq, so a duplicated reply
    frame (a retransmitting transport, an injected duplicate-reply fault) is
    dropped as stale instead of desynchronizing the stream.  A corrupt
    inbound frame is unrecoverable (the stream cannot resync), so the worker
    exits and the parent sees the EOF as :class:`WorkerLost`."""
    out = sys.stdout.buffer
    sys.stdout = sys.stderr
    inp = sys.stdin.buffer
    engine = None
    while True:
        try:
            msg = _recv_msg(inp)
        except (EOFError, FrameError):
            return
        seq, op, rest = msg[0], msg[1], msg[2:]
        try:
            if op == "init":
                path, args, kwargs = rest
                mod, _, fn = path.partition(":")
                engine = getattr(importlib.import_module(mod), fn)(*args, **kwargs)
                _send_msg(out, (seq, "ok", process_topology()))
            elif op == "generate":
                prompts, max_new, eos = rest
                from .engine import ServeConfig
                toks = engine.generate(
                    prompts, ServeConfig(max_new_tokens=max_new, eos_id=eos))
                _send_msg(out, (seq, "ok", np.asarray(toks)))
            elif op == "probe":
                (payload,) = rest
                _send_msg(out, (seq, "ok", len(payload)))
            elif op == "ping":
                _send_msg(out, (seq, "ok", "pong"))
            elif op == "close":
                _send_msg(out, (seq, "ok", None))
                return
            else:
                _send_msg(out, (seq, "err", f"unknown op {op!r}", ""))
        except BaseException as e:  # reply, don't die: the parent decides
            import traceback
            _send_msg(out, (seq, "err", f"{type(e).__name__}: {e}",
                            traceback.format_exc()))


_CHILD_BOOT = "from repro_torch.serve.pool import _worker_main; _worker_main()"


class _InprocWorker:
    """Backend for engines living in this process (the historical reality)."""
    kind = "inproc"

    def __init__(self, spec: WorkerSpec):
        if spec.engine is not None:
            self.engine = spec.engine
        else:
            mod, _, fn = spec.factory.partition(":")
            self.engine = getattr(importlib.import_module(mod), fn)(
                *spec.args, **spec.kwargs)
        self.topology = process_topology()

    def generate(self, prompts, scfg):
        return self.engine.generate(prompts, scfg)

    def probe(self, payload: bytes) -> None:
        # the local transfer leg really is a serialize/deserialize round:
        # that is what a same-process KV handoff costs on this transport
        pickle.loads(pickle.dumps(payload))

    def ping(self) -> None:
        pass

    def close(self) -> None:
        pass


class _SubprocWorker:
    """Backend for a worker process on this host, one pipe pair per worker.

    Requests carry monotonic sequence ids; :meth:`_reply_for` matches replies
    by seq, dropping stale (duplicated / late) reply frames into
    ``stats["stale_replies"]`` instead of letting them desynchronize the
    stream, and surfacing truncated or corrupt frames as :class:`WorkerLost`
    with per-engine context."""
    kind = "subprocess"

    close_timeout = 5.0   # graceful-exit grace before SIGKILL

    def __init__(self, spec: WorkerSpec, *, index: int, env: dict | None = None,
                 stats: dict | None = None):
        if not spec.factory:
            raise ValueError(f"subprocess worker {spec.name!r} needs a "
                             "'module:callable' factory path")
        self._name, self._index = spec.name, index
        self.stats = stats if stats is not None else {"stale_replies": 0}
        child_env = dict(os.environ)
        src = str(Path(__file__).resolve().parents[2])
        pp = child_env.get("PYTHONPATH", "")
        child_env["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
        child_env.update(env or {})
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD_BOOT], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, env=child_env)
        self._lock = threading.Lock()
        self._seq = 0
        self.topology = self._rpc(
            ("init", spec.factory, spec.args, spec.kwargs))

    def _reply_for(self, seq: int):
        """Read replies until the one matching ``seq``: a LOWER seq is a
        stale frame (duplicated or late reply) — dropped and counted — while
        a higher seq means the stream skipped a reply and cannot be trusted."""
        while True:
            reply = _recv_msg(self.proc.stdout)
            if not isinstance(reply, tuple) or len(reply) < 2:
                raise FrameError(f"malformed reply {type(reply).__name__}")
            if reply[0] == seq:
                return reply
            if isinstance(reply[0], int) and reply[0] < seq:
                self.stats["stale_replies"] = \
                    self.stats.get("stale_replies", 0) + 1
                continue
            raise FrameError(
                f"protocol desync: got reply seq {reply[0]!r}, want {seq}")

    def _rpc(self, msg):
        with self._lock:
            try:
                self._seq += 1
                seq = self._seq
                _send_msg(self.proc.stdin, (seq,) + msg)
                reply = self._reply_for(seq)
            except (EOFError, BrokenPipeError, OSError, FrameError) as e:
                raise WorkerLost(self._name, self._index,
                                 f"pipe to worker died ({e})") from e
        if reply[1] == "ok":
            return reply[2]
        raise RuntimeError(
            f"worker {self._name} failed: {reply[2]}\n{reply[3]}")

    def generate(self, prompts, scfg):
        return self._rpc(("generate", np.asarray(prompts),
                          int(scfg.max_new_tokens), int(scfg.eos_id)))

    def probe(self, payload: bytes) -> None:
        self._rpc(("probe", payload))

    def ping(self) -> None:
        self._rpc(("ping",))

    def close(self) -> None:
        """Shut the worker down WITHOUT ever blocking forever or leaking:
        polite close rpc only if the pipe is free (a generate blocked on a
        hung child holds the lock — trying to rpc under it would deadlock),
        then wait → SIGKILL → reap, then close both pipe fds.  A hung or
        SIGSTOP'd child cannot leave a zombie or leaked fds behind across
        drain + relaunch cycles."""
        if self._lock.acquire(blocking=False):
            try:
                self._seq += 1
                # fire-and-forget: NEVER read the reply here — a stopped or
                # hung child would block the read forever, and proc.wait()
                # below observes the graceful exit anyway
                _send_msg(self.proc.stdin, (self._seq, "close"))
            except (BrokenPipeError, OSError, ValueError):
                pass
            finally:
                self._lock.release()
        try:
            self.proc.wait(timeout=self.close_timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()          # SIGKILL stops even a SIGSTOP'd child
            self.proc.wait()          # reap: no zombie survives close()
        for fobj in (self.proc.stdin, self.proc.stdout):
            try:
                fobj.close()
            except Exception:
                pass


@dataclasses.dataclass
class _PoolMember:
    spec: WorkerSpec
    handle: object
    state: str = _WorkerState.LIVE


def _quantize_rate(x: np.ndarray) -> np.ndarray:
    """Snap measured rates onto a sqrt2 geometric grid: the Machine snapshot
    (and the plan cache's machine fingerprint) must only move when a
    measurement moves materially, not on every probe's timer noise."""
    x = np.asarray(x, np.float64)
    return np.exp2(np.round(np.log2(np.maximum(x, 1e-30)) * 2.0) / 2.0)


class EnginePool:
    """Owns worker lifecycle and the measured communication plane.

    ``specs`` seed the pool; ``probe`` selects the comm plane: ``"static"``
    (fixed proxy, byte-stable — the compat default for
    :meth:`from_slots`), ``"measure"`` (real transfer probes), or a callable
    ``(member, payload) -> seconds`` measuring one transfer leg (tests
    inject deterministic clocks here).  ``autoscale`` enables queue-depth
    driven :meth:`maybe_autoscale` between ``min_size`` and ``max_size``.

    Listeners receive ``fn(event, payload)`` with events ``"lost"`` /
    ``"launch"`` / ``"drain"`` (payload = worker index) and ``"machine"``
    (payload = the previous Machine snapshot).
    """

    def __init__(self, specs: Sequence[WorkerSpec] = (), *,
                 backend: str = "inproc",
                 probe: str | Callable = "static",
                 kv_bw: float = 1e4, latency: float = 1e-3,
                 probe_tokens: int = 4096, bw_alpha: float = 0.3,
                 min_size: int = 1, max_size: int | None = None,
                 autoscale: bool = False,
                 high_water: int = 8, low_water: int = 0,
                 machine: Machine | None = None,
                 child_env: dict | None = None,
                 relaunch_budget: int = 3,
                 relaunch_backoff: float = 0.5,
                 relaunch_backoff_max: float = 30.0):
        self.backend = backend
        self.probe = probe
        self.kv_bw = float(kv_bw)
        self.latency = float(latency)
        self.probe_tokens = int(probe_tokens)
        self.bw_alpha = float(bw_alpha)
        self.min_size = int(min_size)
        self.max_size = max_size if max_size is None else int(max_size)
        self.autoscale = bool(autoscale)
        self.high_water = int(high_water)
        self.low_water = int(low_water)
        self.child_env = child_env
        self.relaunch_budget = int(relaunch_budget)
        self.relaunch_backoff = float(relaunch_backoff)
        self.relaunch_backoff_max = float(relaunch_backoff_max)
        self._members: list[_PoolMember] = []
        self._listeners: list[Callable] = []
        self._handle_wrappers: list[Callable] = []
        self._lat_ewma: np.ndarray = np.zeros(0)      # seconds, ping round-trip
        self._leg_ewma: np.ndarray = np.zeros(0)      # tokens/s, transfer leg
        self._machine: Machine | None = None
        self._pinned_machine = machine
        self._autoscaled: list[int] = []
        self._relaunch_attempts: dict[int, int] = {}
        self._relaunch_next: dict[int, float] = {}
        self.stats = {"launched": 0, "drained": 0, "lost": 0, "probes": 0,
                      "scale_out": 0, "scale_in": 0, "stale_replies": 0,
                      "relaunches": 0, "relaunch_exhausted": 0}
        for spec in specs:
            self.launch(spec)

    # ------------------------------------------------------------ construction
    @classmethod
    def from_slots(cls, slots: Sequence[EngineSlot], *,
                   machine: Machine | None = None, **kw) -> "EnginePool":
        """Wrap a direct engine list (the pre-pool Router input) as an
        in-process pool with the byte-stable static comm plane — plans for a
        fixed snapshot are bit-identical to the direct-engine Router."""
        specs = [WorkerSpec(s.name, s.profile, engine=s.engine) for s in slots]
        return cls(specs, probe=kw.pop("probe", "static"), machine=machine, **kw)

    # ----------------------------------------------------------------- views
    @property
    def size(self) -> int:
        """Processor-class count: lost/drained workers KEEP their column."""
        return len(self._members)

    def live_indices(self) -> list[int]:
        return [i for i, m in enumerate(self._members)
                if m.state == _WorkerState.LIVE]

    def state(self, idx: int) -> str:
        return self._members[idx].state

    @property
    def slots(self) -> list[EngineSlot]:
        """The Router/test-facing view; inproc members expose their engine
        object, subprocess members their handle."""
        return [EngineSlot(m.spec.name,
                           getattr(m.handle, "engine", m.handle),
                           m.spec.profile)
                for m in self._members]

    def worker_pid(self, idx: int) -> int | None:
        """OS pid of a subprocess worker (None for inproc) — lets tests and
        operators kill a real worker from outside the pool's own API."""
        proc = getattr(self._members[idx].handle, "proc", None)
        return None if proc is None else proc.pid

    def topology(self) -> list[dict | None]:
        """Per-worker host/process placement, as reported through the
        substrate seam (subprocess workers report their own child's view)."""
        return [getattr(m.handle, "topology", None) for m in self._members]

    def add_listener(self, fn: Callable) -> None:
        self._listeners.append(fn)

    def add_handle_wrapper(self, wrap: Callable) -> None:
        """Public middleware seam for the worker transport: every current and
        future handle is replaced by ``wrap(index, handle)``.  The wrapper
        must expose the handle protocol (generate/probe/ping/close).  This is
        how tracing or fault injection (``repro_torch.serve.faults``) attaches
        without touching the pool's private lifecycle state."""
        self._handle_wrappers.append(wrap)
        for i, m in enumerate(self._members):
            m.handle = wrap(i, m.handle)

    def _notify(self, event: str, payload) -> None:
        for fn in self._listeners:
            fn(event, payload)

    # ------------------------------------------------------------- lifecycle
    def _build_handle(self, spec: WorkerSpec, idx: int):
        backend = spec.backend or self.backend
        if backend == "subprocess":
            handle = _SubprocWorker(spec, index=idx, env=self.child_env,
                                    stats=self.stats)
        elif backend == "inproc":
            handle = _InprocWorker(spec)
        else:
            raise ValueError(f"unknown pool backend {backend!r}")
        for wrap in self._handle_wrappers:
            handle = wrap(idx, handle)
        return handle

    def launch(self, spec: WorkerSpec, idx: int | None = None) -> int:
        """Start a worker.  Freed slots (lost/drained) are revived in place so
        processor-class columns stay index-stable; otherwise a new column is
        appended.  ``idx`` targets a specific freed slot (the relaunch path);
        by default the first freed slot is revived.  Returns the worker
        index."""
        if not spec.backend:
            spec = dataclasses.replace(spec, backend=self.backend)
        freed = [i for i, m in enumerate(self._members)
                 if m.state != _WorkerState.LIVE]
        if idx is not None:
            if self._members[idx].state == _WorkerState.LIVE:
                raise ValueError(f"slot {idx} is live; drain it first")
            self._members[idx] = _PoolMember(spec, self._build_handle(spec, idx))
        elif freed:
            idx = freed[0]
            self._members[idx] = _PoolMember(spec, self._build_handle(spec, idx))
        else:
            idx = len(self._members)
            self._members.append(_PoolMember(spec, self._build_handle(spec, idx)))
            self._lat_ewma = np.concatenate([self._lat_ewma, [np.nan]])
            self._leg_ewma = np.concatenate([self._leg_ewma, [np.nan]])
        # a revived column's old measurements belong to the previous worker
        self._lat_ewma[idx] = np.nan
        self._leg_ewma[idx] = np.nan
        self.stats["launched"] += 1
        self._notify("launch", idx)
        return idx

    def drain(self, idx: int) -> None:
        """Gracefully retire a worker: close the handle, keep the column."""
        m = self._members[idx]
        if m.state != _WorkerState.LIVE:
            return
        m.state = _WorkerState.DRAINED
        try:
            m.handle.close()
        except Exception:
            pass
        self.stats["drained"] += 1
        self._notify("drain", idx)

    def mark_lost(self, idx: int, cause: str = "worker lost") -> None:
        """Record a worker death.  The column stays: listeners degrade it
        (StragglerMonitor) and the nominal+degraded re-plan routes around it."""
        m = self._members[idx]
        if m.state == _WorkerState.LOST:
            return
        m.state = _WorkerState.LOST
        try:
            m.handle.close()
        except Exception:
            pass
        self.stats["lost"] += 1
        self._notify("lost", idx)

    def close(self) -> None:
        for i in self.live_indices():
            self.drain(i)

    # -------------------------------------------------------------- relaunch
    def relaunchable(self) -> list[int]:
        """Lost slots still inside their relaunch budget."""
        return [i for i, m in enumerate(self._members)
                if m.state == _WorkerState.LOST
                and self._relaunch_attempts.get(i, 0) < self.relaunch_budget]

    def maybe_relaunch(self, idx: int, now: float | None = None) -> bool:
        """Try to revive one lost slot from its own spec, under a bounded
        exponential backoff and a hard per-slot attempt budget: a
        crash-looping worker costs at most ``relaunch_budget`` relaunches,
        then converges to permanently-degraded (its column stays LOST, the
        degraded re-plan keeps routing around it) instead of flapping the
        machine fingerprint on every crash cycle."""
        m = self._members[idx]
        if m.state != _WorkerState.LOST:
            return False
        attempts = self._relaunch_attempts.get(idx, 0)
        if attempts >= self.relaunch_budget:
            return False
        now = time.monotonic() if now is None else now
        if now < self._relaunch_next.get(idx, 0.0):
            return False
        self._relaunch_attempts[idx] = attempts + 1
        self._relaunch_next[idx] = now + min(
            self.relaunch_backoff * (2.0 ** attempts),
            self.relaunch_backoff_max)
        if self._relaunch_attempts[idx] >= self.relaunch_budget:
            self.stats["relaunch_exhausted"] += 1
        try:
            self.launch(dataclasses.replace(m.spec), idx=idx)
        except Exception:
            # the relaunch itself crashed (factory raised, spawn failed):
            # that consumed one budgeted attempt; the slot stays lost
            self._members[idx].state = _WorkerState.LOST
            return False
        self.stats["relaunches"] += 1
        return True

    def maybe_relaunch_lost(self, now: float | None = None) -> list[int]:
        """Attempt every budget-eligible lost slot; returns revived indices."""
        return [i for i in self.relaunchable() if self.maybe_relaunch(i, now)]

    # -------------------------------------------------------------- dispatch
    def generate(self, idx: int, prompts, scfg):
        """Run one micro-batch on worker ``idx``; :class:`WorkerLost` (from a
        dead pipe or the engine itself) marks the worker lost before
        re-raising, so the caller's very next plan sees the degraded column."""
        m = self._members[idx]
        if m.state != _WorkerState.LIVE:
            raise WorkerLost(m.spec.name, idx, f"worker is {m.state}")
        try:
            return m.handle.generate(prompts, scfg)
        except WorkerLost as e:
            self.mark_lost(idx, e.cause)
            raise
        except (BrokenPipeError, EOFError) as e:
            self.mark_lost(idx, str(e))
            raise WorkerLost(m.spec.name, idx, str(e)) from e

    # ------------------------------------------------------------ comm plane
    def _measure_leg(self, member: _PoolMember, payload: bytes) -> float:
        t0 = time.perf_counter()
        member.handle.probe(payload)
        return time.perf_counter() - t0

    def refresh_probes(self) -> None:
        """Measure one transfer leg + dispatch latency per live worker and
        EWMA-fold them into the comm plane.  No-op for the static proxy."""
        if self.probe == "static":
            return
        injected = callable(self.probe)
        leg = self.probe if injected else self._measure_leg
        payload = b"\x00" * (self.probe_tokens * 4)   # int32 tokens
        a = self.bw_alpha
        for i in self.live_indices():
            m = self._members[i]
            sec = max(float(leg(m, payload)), 1e-9)
            rate = self.probe_tokens / sec
            self.stats["probes"] += 1
            old_r = self._leg_ewma[i]
            self._leg_ewma[i] = (rate if np.isnan(old_r)
                                 else a * rate + (1 - a) * old_r)
            if injected:
                # an injected clock covers the transfer leg only; latency
                # stays at the configured default so tests are deterministic
                continue
            t0 = time.perf_counter()
            m.handle.ping()
            lat = max(time.perf_counter() - t0, 1e-9)
            old_l = self._lat_ewma[i]
            self._lat_ewma[i] = (lat if np.isnan(old_l)
                                 else a * lat + (1 - a) * old_l)

    def machine(self) -> Machine:
        """The pool as a CEFT machine: one class per worker (count 1).  The
        returned object is a cached SNAPSHOT — it is replaced (and listeners
        notified with the old snapshot, for plan-cache invalidation) only
        when quantized measurements or the pool shape actually change."""
        if self._pinned_machine is not None:
            return self._pinned_machine
        P = max(self.size, 1)
        L = np.full(P, self.latency, np.float64)
        bw = np.full((P, P), self.kv_bw, np.float64)
        if self.probe != "static" and self._leg_ewma.size:
            lq = _quantize_rate(self._lat_ewma[:P])
            L = np.where(np.isnan(self._lat_ewma[:P]), L, lq)
            # pair rate a->b composes the measured legs (the handoff is
            # parent-relayed: egress from a, then ingress into b), then
            # snaps onto the sqrt2 grid so the fingerprint stays put under
            # probe timer noise
            legs = self._leg_ewma[:P]
            with np.errstate(invalid="ignore"):
                pair = 1.0 / (1.0 / legs[:, None] + 1.0 / legs[None, :])
            pq = _quantize_rate(pair)
            ok = ~np.isnan(legs[:, None]) & ~np.isnan(legs[None, :])
            bw = np.where(ok, pq, bw)
        m = self._machine
        if (m is not None and m.P == P and np.array_equal(m.L, L)
                and np.array_equal(m.bw, bw)):
            return m
        self._machine = Machine(L=L, bw=bw, counts=np.ones(P, np.int64))
        if m is not None:
            self._notify("machine", m)
        return self._machine

    # -------------------------------------------------------------- autoscale
    def maybe_autoscale(self, depth: int) -> str | None:
        """Queue-depth policy: scale OUT (clone the first worker's spec) when
        the backlog per live worker exceeds ``high_water`` and the pool is
        below ``max_size``; DRAIN the most recent autoscaled worker when the
        backlog falls to ``low_water`` or below.  Returns "out"/"in"/None."""
        if not self.autoscale:
            return None
        live = self.live_indices()
        if not live:
            return None
        if depth > self.high_water * len(live) and (
                self.max_size is None or len(live) < self.max_size):
            base = self._members[live[0]].spec
            idx = self.launch(dataclasses.replace(
                base, name=f"{base.name}~{self.stats['launched']}"))
            self._autoscaled.append(idx)
            self.stats["scale_out"] += 1
            return "out"
        if depth <= self.low_water and len(live) > self.min_size \
                and self._autoscaled:
            idx = self._autoscaled.pop()
            if self._members[idx].state == _WorkerState.LIVE:
                self.drain(idx)
                self.stats["scale_in"] += 1
                return "in"
        return None
