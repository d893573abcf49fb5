"""repro_torch.core — CEFT and its schedulers (numpy), plus the device sweep
in ``ceft_torch`` (imported on its own: it needs torch)."""
from .ceft import (
    CeftResult,
    averaged_critical_path,
    ceft,
    ceft_reference,
    chain_cost,
    min_comp_critical_path,
)
from .cpop import ceft_cpop, cpop, cpop_cpl
from .heft import ceft_heft_down, ceft_heft_up, heft, heft_down
from .machine import Machine, random_machine, uniform_machine
from .metrics import slack, slr, speedup
from .planners import (
    PLANNERS,
    Plan,
    PlannerSpec,
    averaged_path_misidentified,
    chain_optimal_assignment,
    get_planner,
    planner_names,
)
from .planners import plan as plan_with
from .planners import realize as realize_plan
from .ranks import rank_ceft_down, rank_ceft_up, rank_d, rank_u
from .schedule import Schedule, list_schedule, sequential_time, validate_schedule
from .taskgraph import (
    FusedLevelRun,
    LevelSegments,
    TaskGraph,
    csr_batch_segments,
    csr_level_segments,
    from_edge_arrays,
    from_edges,
    fuse_levels,
    linear_chain,
    moldable_fork_join,
    moldable_fork_join_arrays,
    padded_level_tables,
)

__all__ = [
    "CeftResult", "FusedLevelRun", "LevelSegments", "Machine", "PLANNERS",
    "Plan", "PlannerSpec", "Schedule",
    "TaskGraph", "averaged_critical_path", "averaged_path_misidentified",
    "ceft", "ceft_cpop", "chain_optimal_assignment", "get_planner",
    "plan_with", "planner_names", "realize_plan",
    "ceft_heft_down", "ceft_heft_up", "ceft_reference", "chain_cost", "cpop",
    "cpop_cpl", "csr_batch_segments", "csr_level_segments",
    "from_edge_arrays", "from_edges", "fuse_levels", "heft", "heft_down",
    "linear_chain", "list_schedule", "min_comp_critical_path",
    "moldable_fork_join", "moldable_fork_join_arrays",
    "padded_level_tables", "random_machine", "rank_ceft_down",
    "rank_ceft_up", "rank_d", "rank_u", "sequential_time", "slack", "slr",
    "speedup", "uniform_machine", "validate_schedule",
]
