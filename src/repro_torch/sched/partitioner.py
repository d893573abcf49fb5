"""CEFT-guided pipeline partitioner (the paper's technique as a first-class
runtime feature).

Given an architecture x shape cell and a heterogeneous fleet, build the layer
DAG, run CEFT for the true critical path + its partial assignment (the makespan
lower bound and the class each stage *wants*), schedule with CEFT-CPOP, and
collapse the per-layer assignment into contiguous pipeline stages.  CPOP and
HEFT plans are produced for comparison -- the paper's Table-3 experiment
replayed on real model graphs.  Planning runs on the host (numpy), as in the
reference, and yields the reference's identical plan.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeCell
from ..core import planners, validate_schedule
from .layer_dag import DEFAULT_FLEET, build_layer_dag


@dataclasses.dataclass
class Stage:
    start_layer: int          # index into the DAG's node list
    end_layer: int            # inclusive
    device_class: str


@dataclasses.dataclass
class PipelinePlan:
    stages: list[Stage]
    cpl: float                # CEFT critical-path length (makespan lower bound)
    makespan: float           # CEFT-CPOP schedule makespan
    makespan_cpop: float
    makespan_heft: float
    assignment: dict[int, int]
    labels: list[str]

    @property
    def speedup_vs_cpop(self) -> float:
        return self.makespan_cpop / self.makespan


def plan_pipeline(cfg: ArchConfig, cell: ShapeCell, fleet=None) -> PipelinePlan:
    fleet = fleet or DEFAULT_FLEET
    g, comp, m, labels = build_layer_dag(cfg, cell, fleet)
    # all three plans come from the registry; ceft_cpop's Plan carries the
    # CEFT path and cpl
    p_ours = planners.plan("ceft_cpop", g, comp, m)
    p_cpop = planners.plan("cpop", g, comp, m)
    p_heft = planners.plan("heft", g, comp, m)
    for s in (p_ours, p_cpop, p_heft):
        validate_schedule(s, g, comp, m)

    # collapse the CEFT path assignment into contiguous stages
    names = [c.name for c in fleet]
    stages: list[Stage] = []
    for task, cls in p_ours.path:
        if stages and names[cls] == stages[-1].device_class:
            stages[-1].end_layer = task
        else:
            stages.append(Stage(task, task, names[cls]))
    return PipelinePlan(
        stages=stages,
        cpl=p_ours.cpl,
        makespan=p_ours.makespan,
        makespan_cpop=p_cpop.makespan,
        makespan_heft=p_heft.makespan,
        assignment=p_ours.assignment,
        labels=labels,
    )
