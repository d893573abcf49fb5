"""Task ranking functions.

Mean-value ranks (Topcuoglu et al. 2002, used by HEFT/CPOP):

    rank_u(i) = wbar_i + max_{j in succ(i)} ( cbar_ij + rank_u(j) )
    rank_d(i) = max_{k in pred(i)} ( rank_d(k) + wbar_k + cbar_ki )

CEFT-based ranks (paper §8.2):

    rank_ceft_down(i) = min_p CEFT(i, p)            (accurate downward length)
    rank_ceft_up(i)   = min_p CEFT_T(i', p)          (CEFT on the edge-transposed
                                                     DAG, i' the relabelled id)
"""
from __future__ import annotations

import numpy as np

from .ceft import ceft
from .machine import Machine
from .taskgraph import TaskGraph


def mean_costs(g: TaskGraph, comp: np.ndarray, m: Machine):
    wbar = m.mean_comp(comp)
    cbar = m.mean_comm(g.cdata)  # aligned with children CSR
    return wbar, cbar


def rank_u(g: TaskGraph, comp: np.ndarray, m: Machine) -> np.ndarray:
    wbar, cbar = mean_costs(g, comp, m)
    r = np.zeros(g.n, np.float64)
    for i in range(g.n - 1, -1, -1):
        lo, hi = g.cindptr[i], g.cindptr[i + 1]
        best = 0.0
        for j, c in zip(g.cindices[lo:hi], np.atleast_1d(cbar)[lo:hi]):
            best = max(best, c + r[j])
        r[i] = wbar[i] + best
    return r


def rank_d(g: TaskGraph, comp: np.ndarray, m: Machine) -> np.ndarray:
    wbar, cbar = mean_costs(g, comp, m)
    r = np.zeros(g.n, np.float64)
    for i in range(g.n):
        lo, hi = g.cindptr[i], g.cindptr[i + 1]
        for j, c in zip(g.cindices[lo:hi], np.atleast_1d(cbar)[lo:hi]):
            r[j] = max(r[j], r[i] + wbar[i] + c)
    return r


def rank_ceft_down(g: TaskGraph, comp: np.ndarray, m: Machine) -> np.ndarray:
    res = ceft(g, comp, m)
    return res.ceft.min(axis=1)


def rank_ceft_up(g: TaskGraph, comp: np.ndarray, m: Machine) -> np.ndarray:
    gt = g.transpose()
    # transpose() relabels vertex i -> n-1-i; costs follow the task identity
    comp_t = comp[::-1]
    res = ceft(gt, comp_t, m)
    up = res.ceft.min(axis=1)
    return up[::-1]
