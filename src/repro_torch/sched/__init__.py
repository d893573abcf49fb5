"""repro_torch.sched — the CEFT planner as the runtime's scheduling brain:
the plan cache, the straggler re-planning loop and backward deadline
propagation."""
from .deadlines import DeadlineSchedule, plan_classes, propagate_deadlines
from .plancache import PlanCache, PlanEntry
from .straggler import (LOST_SLOWDOWN, EwmaCostTable, StragglerEvent,
                        StragglerMonitor)

__all__ = ["DeadlineSchedule", "EwmaCostTable", "LOST_SLOWDOWN", "PlanCache",
           "PlanEntry", "StragglerEvent", "StragglerMonitor", "plan_classes",
           "propagate_deadlines"]
