"""Heterogeneous machine model (paper §3.1, G_r).

The paper's key §5 observation: CEFT only needs *classes* of processors
(identical computation + communication behaviour), because a critical path never
contends for resources — ``O(P^2 e)`` with P = number of classes.  The list
schedulers (HEFT/CPOP/CEFT-CPOP) additionally need concrete *instances* with
availability, so a Machine carries both views:

  * class view  : P classes, per-class comm startup L, class-pair bandwidth bw
  * instance view: ``counts[c]`` instances per class, ``inst_class`` mapping

Communication cost of ``data`` bytes from task on processor a to task on
processor b (Definition 3):

    0                                   if a and b are the same *instance*
    L[class(a)] + data / bw[class(a), class(b)]   otherwise

For the CEFT class view "same instance" relaxes to "same class" — the DP may
always co-locate a parent and child of the same class on one instance.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Machine:
    L: np.ndarray        # (P,) communication startup time per class
    bw: np.ndarray       # (P, P) bandwidth between classes (>0)
    counts: np.ndarray   # (P,) number of instances per class

    @property
    def P(self) -> int:
        return int(self.L.shape[0])

    @property
    def n_proc(self) -> int:
        return int(self.counts.sum())

    @property
    def inst_class(self) -> np.ndarray:
        return np.repeat(np.arange(self.P, dtype=np.int32), self.counts)

    # --------------------------------------------------------------- comm costs
    def comm_class(self, data: float, cls_from: int, cls_to: int) -> float:
        """Class-view comm cost (same class => co-locate => 0). Used by CEFT."""
        if cls_from == cls_to:
            return 0.0
        return float(self.L[cls_from] + data / self.bw[cls_from, cls_to])

    def comm_class_vec(self, data) -> np.ndarray:
        """(..., P_from, P_to) comm costs for data of shape (...,). Diagonal 0."""
        data = np.asarray(data, dtype=np.float64)
        c = self.L[:, None] + data[..., None, None] / self.bw
        off = ~np.eye(self.P, dtype=bool)
        return c * off

    def comm_inst(self, data: float, inst_from: int, inst_to: int) -> float:
        """Instance-view comm cost (same instance => 0). Used by schedulers."""
        if inst_from == inst_to:
            return 0.0
        ic = self.inst_class
        a, b = int(ic[inst_from]), int(ic[inst_to])
        return float(self.L[a] + data / self.bw[a, b])

    # ------------------------------------------------------------- mean values
    def mean_comm(self, data) -> np.ndarray:
        """Average comm cost over *distinct ordered instance pairs* (CPOP/HEFT
        use mean communication costs, Topcuoglu et al. 2002)."""
        data = np.asarray(data, dtype=np.float64)
        ic = self.inst_class
        n = self.n_proc
        if n <= 1:
            return np.zeros_like(data)
        La = self.L[ic]                      # (n,)
        inv = 1.0 / self.bw[np.ix_(ic, ic)]  # (n, n)
        off = ~np.eye(n, dtype=bool)
        mean_L = La[:, None].repeat(n, 1)[off].mean()
        mean_inv = inv[off].mean()
        return mean_L + data * mean_inv

    def mean_comp(self, comp_class: np.ndarray) -> np.ndarray:
        """Instance-count-weighted mean execution time, (v,P)->(v,)."""
        w = self.counts / self.counts.sum()
        return comp_class @ w


def uniform_machine(P: int, counts=None, bw: float = 1.0, L: float = 0.0) -> Machine:
    """Homogeneous-communication machine (the RGG-classic setting: a single
    per-edge comm cost, zero startup)."""
    counts = np.ones(P, np.int64) if counts is None else np.asarray(counts, np.int64)
    return Machine(
        L=np.full(P, L, np.float64),
        bw=np.full((P, P), bw, np.float64),
        counts=counts,
    )


def random_machine(
    P: int,
    rng: np.random.Generator,
    *,
    counts=None,
    bw_range: tuple[float, float] = (0.5, 2.0),
    L_range: tuple[float, float] = (0.0, 0.0),
) -> Machine:
    """Heterogeneous communication backbone: symmetric log-uniform bandwidths."""
    lo, hi = np.log(bw_range[0]), np.log(bw_range[1])
    b = np.exp(rng.uniform(lo, hi, size=(P, P)))
    b = np.sqrt(b * b.T)  # symmetric
    L = rng.uniform(L_range[0], L_range[1], size=P)
    counts = np.ones(P, np.int64) if counts is None else np.asarray(counts, np.int64)
    return Machine(L=L.astype(np.float64), bw=b.astype(np.float64), counts=counts)
