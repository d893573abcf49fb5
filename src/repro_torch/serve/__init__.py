"""repro_torch.serve — the CEFT-routed serving plane: the batched LM engine,
admission queue, engine pool, deadline watchdog, fault injection and the
router.  The pool serves any object with ``generate(prompts, ServeConfig)``:
an :class:`Engine` (dense, MoE, SSM and hybrid decoders) or a stand-in such as
:func:`null_engine_factory`'s."""
from .engine import Engine, ServeConfig
from .pool import (
    EnginePool,
    EngineSlot,
    WorkerLost,
    WorkerSpec,
    null_engine_factory,
    smoke_engine_factory,
)
from .queue import AdmissionQueue, Request, TenantTier, class_mix, workload_class
from .router import Dispatch, Router, router_machine
from .watchdog import DeadlineWatchdog

__all__ = ["AdmissionQueue", "DeadlineWatchdog", "Dispatch", "Engine",
           "EnginePool", "EngineSlot", "Request", "Router", "ServeConfig",
           "TenantTier", "WorkerLost", "WorkerSpec", "class_mix",
           "null_engine_factory", "router_machine", "smoke_engine_factory",
           "workload_class"]
