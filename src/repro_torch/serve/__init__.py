"""repro_torch.serve — the CEFT-routed serving plane: admission queue, engine
pool, deadline watchdog, fault injection and the router.  The pool serves any
object with ``generate(prompts, ServeConfig)``; the LM engines are not ported
yet."""
from .engine import ServeConfig
from .pool import (
    EnginePool,
    EngineSlot,
    WorkerLost,
    WorkerSpec,
    null_engine_factory,
)
from .queue import AdmissionQueue, Request, TenantTier, class_mix, workload_class
from .router import Dispatch, Router, router_machine
from .watchdog import DeadlineWatchdog

__all__ = ["AdmissionQueue", "DeadlineWatchdog", "Dispatch", "EnginePool",
           "EngineSlot", "Request", "Router", "ServeConfig", "TenantTier",
           "WorkerLost", "WorkerSpec", "class_mix", "null_engine_factory",
           "router_machine", "workload_class"]
