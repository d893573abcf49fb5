"""repro_torch.sched — the CEFT planner as the runtime's scheduling brain:
the plan cache and the straggler re-planning loop."""
from .plancache import PlanCache, PlanEntry
from .straggler import (LOST_SLOWDOWN, EwmaCostTable, StragglerEvent,
                        StragglerMonitor)

__all__ = ["EwmaCostTable", "LOST_SLOWDOWN", "PlanCache", "PlanEntry",
           "StragglerEvent", "StragglerMonitor"]
