"""Admission queue for the multi-tenant serving front-end.

Requests carry a tenant and a *workload class* — the (prompt-len, max-new)
pow2 bucket pair.  The class is the unit the router plans over: CEFT treats
each pending class as a task chain, so bucketing is what keeps the per-tick
DAG small (a handful of classes) no matter how many raw requests are queued.

Admission control is per-tenant and global: a tenant that floods the queue
is rejected at submit() without touching other tenants' backlog, and drain()
interleaves tenants so one deep backlog cannot starve the rest.  Tenants may
carry a :class:`TenantTier`: the tier's *weight* drives a smooth
weighted-round-robin drain with a hard starvation bound (a non-empty tenant
of weight w is popped at least once per ``ceil(2 x total_weight / w)``
drains — see :meth:`AdmissionQueue.starvation_bound` for the credit-range
argument), and the tier's *SLO* is stamped onto every admitted request so the router
can propagate deadlines backward through its plan.  Uniform weights reduce
the drain exactly to the historical insertion-order round-robin.
Thread-safe: tenants submit from their own threads, the router drains from
its tick loop.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from collections import OrderedDict, deque

import numpy as np

_IDS = itertools.count()

# Dispatch-attempt sequence ids, monotonic process-wide.  Every attempt to
# serve a request — the original dispatch, a hedged re-dispatch, a requeue's
# re-dispatch — draws a fresh seq here, and completion is first-attempt-wins:
# a later reply for an already-completed request is dropped as stale (counted
# in stats["stale_replies"]) instead of double-completing it.  Single owner so
# router- and pool-level attempt ids can never collide.
_ATTEMPTS = itertools.count(1)


def next_seq() -> int:
    """A fresh dispatch-attempt sequence id (monotonic, never reused)."""
    return next(_ATTEMPTS)


def _pow2ceil(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


def workload_class(prompt_len: int, max_new: int) -> tuple[int, int]:
    """The (prompt-len, max-new) pow2 bucket pair — the router's task class."""
    return (_pow2ceil(prompt_len), _pow2ceil(max_new))


def moldable_class(wclass: tuple[int, int], split: int) -> tuple[int, int, int]:
    """A workload-class bucket extended with a moldable split degree: the
    (prompt-len, max-new, split) triple a fork-join plan registers under in
    the plan cache's reverse index, *alongside* the base pair (cost deltas
    arrive keyed by the base class and must still dirty every split's plan).
    ``split=1`` is the unsplit prefill->decode chain."""
    return (int(wclass[0]), int(wclass[1]), int(split))


def class_mix(resident: dict) -> tuple:
    """Deterministic (wclass, count) signature of a pending mix.

    The router's steady-state short-circuit key: two ticks with equal mixes
    build byte-identical request DAGs and cost planes, so a clean cached plan
    can be served without touching the planner at all.  Counts are exact, not
    bucketed — serving a plan priced for a different request count would
    break the plan-cache invariant (cached == from-scratch)."""
    return tuple(sorted((wc, len(q)) for wc, q in resident.items()))


@dataclasses.dataclass(frozen=True)
class TenantTier:
    """Admission policy for one tenant: drain weight and optional latency SLO.

    ``weight`` is the tenant's share of drain slots (smooth weighted round-
    robin; 1.0 is the untiered default).  Zero or negative weights are
    rejected at construction — a zero-weight tenant would never win a drain
    slot, i.e. starve forever, which is a config error, not a policy.
    ``slo`` (seconds, end-to-end from submit) is stamped onto every admitted
    request; the router propagates it backward through the planned DAG.
    """
    name: str
    weight: float = 1.0
    slo: float | None = None

    def __post_init__(self):
        w = float(self.weight)
        if not math.isfinite(w) or w <= 0.0:
            raise ValueError(
                f"tier {self.name!r}: weight must be finite and > 0 "
                f"(got {self.weight!r}); a zero-weight tenant would starve")
        if self.slo is not None and not float(self.slo) > 0.0:
            raise ValueError(f"tier {self.name!r}: slo must be > 0 seconds")


@dataclasses.dataclass
class Request:
    tenant: str
    prompt: np.ndarray          # (plen,) int32 token ids
    max_new: int
    rid: int = dataclasses.field(default_factory=lambda: next(_IDS))
    slo: float | None = None    # end-to-end budget (stamped at admission)
    t_submit: float = 0.0       # monotonic admission time (stamped at submit)

    @property
    def wclass(self) -> tuple[int, int]:
        return workload_class(int(self.prompt.shape[0]), int(self.max_new))

    @property
    def deadline(self) -> float | None:
        """Absolute monotonic deadline, or None for best-effort requests."""
        return None if self.slo is None else self.t_submit + self.slo


class AdmissionQueue:
    """Bounded per-tenant FIFOs with (weighted) round-robin drain."""

    def __init__(self, max_pending: int = 256, per_tenant: int = 64,
                 tiers: "dict[str, TenantTier] | None" = None):
        self.max_pending = int(max_pending)
        self.per_tenant = int(per_tenant)
        self.tiers: dict[str, TenantTier] = dict(tiers) if tiers else {}
        for t, tier in self.tiers.items():
            if not isinstance(tier, TenantTier):
                raise TypeError(f"tiers[{t!r}] must be a TenantTier")
        self.rejected = 0
        self._lock = threading.Lock()
        self._pending: OrderedDict[str, deque[Request]] = OrderedDict()
        # smooth-WRR state: per-tenant current credit (nginx-style)
        self._credit: dict[str, float] = {}
        self._n = 0

    def _weight(self, tenant: str) -> float:
        tier = self.tiers.get(tenant)
        return 1.0 if tier is None else float(tier.weight)

    def __len__(self) -> int:
        with self._lock:
            return self._n

    def submit(self, req: Request) -> bool:
        """Admit ``req``; False when the tenant or global bound is hit.

        Admission stamps the request's SLO clock: ``t_submit`` is set (once)
        to the monotonic admission time and a tenant with a tier SLO has it
        copied onto the request unless the request already carries its own —
        the deadline the router propagates is *end-to-end from admission*,
        queueing delay included."""
        with self._lock:
            q = self._pending.get(req.tenant)
            if self._n >= self.max_pending or (q is not None
                                               and len(q) >= self.per_tenant):
                # bounds checked before any insertion: a rejected submit from
                # a never-admitted tenant must not leak a dict entry
                self.rejected += 1
                return False
            if req.t_submit == 0.0:
                req.t_submit = time.monotonic()
            if req.slo is None:
                tier = self.tiers.get(req.tenant)
                if tier is not None:
                    req.slo = tier.slo
            if q is None:
                q = self._pending[req.tenant] = deque()
            q.append(req)
            self._n += 1
            return True

    def starvation_bound(self, tenant: str) -> int:
        """Upper bound on drain slots that can pass over a non-empty tenant:
        ``ceil(2 x total active weight / weight(tenant))``.  Smooth WRR keeps
        every tenant's credit strictly inside (-W, W) for W the total active
        weight; a tenant passed over k times gains k x w credit, so
        k x w < 2W before it must hold the maximum and win a slot.  The
        factor 2 is tight: a tenant with w ~ W still waits up to 2 slots."""
        with self._lock:
            total = sum(self._weight(t) for t, q in self._pending.items() if q)
        total = max(total, self._weight(tenant))
        return int(math.ceil(2.0 * total / self._weight(tenant)))

    def drain(self, limit: int | None = None) -> list[Request]:
        """Pop up to ``limit`` requests, interleaving tenants by tier weight.

        Smooth weighted round-robin (the nginx algorithm): each selection
        adds every non-empty tenant's weight to its credit, the highest
        credit wins (insertion order of first submit breaks ties) and pays
        the total active weight back.  With uniform weights this IS the
        historical insertion-order round-robin, pop for pop; with tiers it
        interleaves proportionally while keeping the starvation bound above.
        Credit persists across drains (so fairness holds across ticks, not
        just within one) and is dropped when a tenant's backlog empties."""
        out: list[Request] = []
        with self._lock:
            budget = self._n if limit is None else min(limit, self._n)
            while budget > 0:
                active = [(t, q) for t, q in self._pending.items() if q]
                if not active:
                    break
                total = 0.0
                best, best_credit = None, -np.inf
                for t, q in active:
                    w = self._weight(t)
                    total += w
                    c = self._credit.get(t, 0.0) + w
                    self._credit[t] = c
                    if c > best_credit:
                        best, best_credit = t, c
                self._credit[best] -= total
                out.append(self._pending[best].popleft())
                self._n -= 1
                budget -= 1
            # drop emptied tenants: a long-lived router with ephemeral tenant
            # ids must not accumulate one permanent dict entry (and one
            # round-robin scan slot) per tenant ever admitted.  Their WRR
            # credit goes with them: a returning tenant starts even, it does
            # not cash in credit banked while it had nothing to serve.
            for t in [t for t, q in self._pending.items() if not q]:
                del self._pending[t]
                self._credit.pop(t, None)
        return out
