"""HEFT (Topcuoglu et al. 2002) and its rank-swapped variants (paper §8.2)."""
from __future__ import annotations

import numpy as np

from .machine import Machine
from .ranks import rank_ceft_down, rank_ceft_up, rank_d, rank_u
from .schedule import Schedule, list_schedule
from .taskgraph import TaskGraph


def heft(g: TaskGraph, comp: np.ndarray, m: Machine) -> Schedule:
    """Classic HEFT: upward-rank priority + insertion-based EFT placement."""
    return list_schedule(g, comp, m, priority=rank_u(g, comp, m))


def heft_down(g: TaskGraph, comp: np.ndarray, m: Machine) -> Schedule:
    """HEFT ordered by downward rank.  rank_d grows along the graph, so the
    ready-queue uses its negation to stay topologically consistent (entry
    tasks first)."""
    return list_schedule(g, comp, m, priority=-rank_d(g, comp, m))


def ceft_heft_up(g: TaskGraph, comp: np.ndarray, m: Machine) -> Schedule:
    """CEFT-HEFT-UP: HEFT with rank_ceft_up (CEFT on the transposed DAG)."""
    return list_schedule(g, comp, m, priority=rank_ceft_up(g, comp, m))


def ceft_heft_down(g: TaskGraph, comp: np.ndarray, m: Machine) -> Schedule:
    """CEFT-HEFT-DOWN: HEFT with rank_ceft_down (the CEFT DP array)."""
    return list_schedule(g, comp, m, priority=-rank_ceft_down(g, comp, m))
