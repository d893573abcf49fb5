"""repro_torch.sched — the CEFT planner as the runtime's scheduling brain:
the plan cache, the straggler re-planning loop, backward deadline
propagation, and the pipeline partitioner over a model's layer DAG."""
from .deadlines import DeadlineSchedule, plan_classes, propagate_deadlines
from .layer_dag import DEFAULT_FLEET, DeviceClass, build_layer_dag, fleet_machine
from .partitioner import PipelinePlan, Stage, plan_pipeline
from .plancache import PlanCache, PlanEntry
from .straggler import (LOST_SLOWDOWN, EwmaCostTable, StragglerEvent,
                        StragglerMonitor)

__all__ = ["DEFAULT_FLEET", "DeadlineSchedule", "DeviceClass", "EwmaCostTable",
           "LOST_SLOWDOWN", "PipelinePlan", "PlanCache", "PlanEntry", "Stage",
           "StragglerEvent", "StragglerMonitor", "build_layer_dag",
           "fleet_machine", "plan_classes", "plan_pipeline",
           "propagate_deadlines"]
