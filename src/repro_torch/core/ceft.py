"""CEFT — Critical Earliest Finish Time (paper §4, Algorithm 1).

    CEFT(t_i, p_j) = C_comp(t_i, p_j)
                   + max_{t_k in parents(t_i)} min_{p_l} [ CEFT(t_k, p_l)
                                                           + comm({t_k,p_l},{t_i,p_j}) ]

with comm zero when p_l == p_j (class view: co-location).  The critical path is
``max_{sinks} min_p CEFT(sink, p)`` and the DP carries predecessor pointers so the
(task -> processor-class) *partial assignment* of the path can be reconstructed
(paper lines 19-26; the frontier/backtrack bookkeeping realizes the O(beta*p)
space argument of §5).

Two implementations:
  * ``ceft_reference`` — the paper's Algorithm 1 verbatim (4 nested loops).
    This is the paper-faithful baseline.
  * ``ceft`` — per-task vectorization over (p_l, p_j) (numpy).  Same results.
The level-vectorized device formulation lives in ``ceft_torch.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .machine import Machine
from .taskgraph import TaskGraph

NEG = -np.inf


@dataclasses.dataclass
class CeftResult:
    ceft: np.ndarray        # (v, P) dynamic programming array
    pred_task: np.ndarray   # (v, P) maximizing parent t_k^max (-1 for sources)
    pred_proc: np.ndarray   # (v, P) that parent's minimizing class p_l^min
    sink: int               # t_s^max
    sink_proc: int          # p_s^min
    cpl: float              # critical-path length

    @property
    def path(self) -> list[tuple[int, int]]:
        """The critical path with its partial assignment, entry -> exit:
        list of (task, processor-class)."""
        out: list[tuple[int, int]] = []
        t, p = self.sink, self.sink_proc
        while t >= 0:
            out.append((int(t), int(p)))
            t, p = int(self.pred_task[t, p]), int(self.pred_proc[t, p])
        return out[::-1]

    @property
    def assignment(self) -> dict[int, int]:
        return dict(self.path)


def _finalize(g: TaskGraph, ceft, pred_task, pred_proc) -> CeftResult:
    """Paper lines 21-26: per sink minimize over classes, then maximize over
    sinks (the longest shortest finish)."""
    sinks = g.sinks
    per_sink_proc = np.argmin(ceft[sinks], axis=1)
    per_sink_cost = ceft[sinks, per_sink_proc]
    k = int(np.argmax(per_sink_cost))
    return CeftResult(
        ceft=ceft,
        pred_task=pred_task,
        pred_proc=pred_proc,
        sink=int(sinks[k]),
        sink_proc=int(per_sink_proc[k]),
        cpl=float(per_sink_cost[k]),
    )


def ceft_reference(g: TaskGraph, comp: np.ndarray, m: Machine) -> CeftResult:
    """Algorithm 1, literal form.  O(P^2 e) time.  comp is the (v, P) class-view
    execution-time matrix C_comp."""
    v, P = comp.shape
    ceft = np.zeros((v, P), np.float64)
    pred_task = np.full((v, P), -1, np.int32)
    pred_proc = np.full((v, P), -1, np.int32)
    for ti in range(v):  # vertex ids are topological
        parents = g.parents(ti)
        pdat = g.parent_data(ti)
        if parents.size == 0:
            ceft[ti, :] = comp[ti, :]  # source task: execution time alone
            continue
        for pj in range(P):
            best = NEG
            bt, bp = -1, -1
            for tk, data in zip(parents, pdat):
                # min over p_l of CEFT(t_k, p_l) + comm({t_k,p_l},{t_i,p_j})
                cur, arg = np.inf, -1
                for pl in range(P):
                    comm = 0.0 if pl == pj else m.L[pl] + data / m.bw[pl, pj]
                    c = ceft[tk, pl] + comm
                    if c < cur:
                        cur, arg = c, pl
                # max over parents of the minimized choices
                if cur > best:
                    best, bt, bp = cur, int(tk), arg
            ceft[ti, pj] = comp[ti, pj] + best
            pred_task[ti, pj] = bt
            pred_proc[ti, pj] = bp
    return _finalize(g, ceft, pred_task, pred_proc)


def ceft(g: TaskGraph, comp: np.ndarray, m: Machine) -> CeftResult:
    """Vectorized Algorithm 1: per task, the (parents x P_l x P_j) relaxation is
    one dense max-min-plus contraction."""
    v, P = comp.shape
    ceft_arr = np.zeros((v, P), np.float64)
    pred_task = np.full((v, P), -1, np.int32)
    pred_proc = np.full((v, P), -1, np.int32)
    off = ~np.eye(P, dtype=bool)
    for ti in range(v):
        parents = g.parents(ti)
        if parents.size == 0:
            ceft_arr[ti, :] = comp[ti, :]
            continue
        pdat = g.parent_data(ti)
        # cand[k, l, j] = CEFT(parent_k, l) + comm(l, j | data_k)
        # (identical arithmetic to ceft_reference so ties break the same way)
        comm = (m.L[:, None] + pdat[:, None, None] / m.bw) * off
        cand = ceft_arr[parents][:, :, None] + comm
        argl = cand.argmin(axis=1)                      # (k, j)
        minl = np.take_along_axis(cand, argl[:, None, :], 1)[:, 0, :]  # (k, j)
        argk = minl.argmax(axis=0)                      # (j,)
        ceft_arr[ti] = comp[ti] + minl[argk, np.arange(P)]
        pred_task[ti] = parents[argk]
        pred_proc[ti] = argl[argk, np.arange(P)]
    return _finalize(g, ceft_arr, pred_task, pred_proc)


def chain_cost(
    path: list[tuple[int, int]], g: TaskGraph, comp: np.ndarray, m: Machine
) -> float:
    """Exact cost of a (task, class) chain: sum of execution times plus class-view
    comm along consecutive edges.  CEFT's value equals this for its own path."""
    total = 0.0
    for idx, (t, p) in enumerate(path):
        total += float(comp[t, p])
        if idx + 1 < len(path):
            t2, p2 = path[idx + 1]
            ps = g.parents(t2)
            pos = np.nonzero(ps == t)[0]
            if pos.size == 0:
                raise ValueError(f"path edge {t}->{t2} not in graph")
            data = float(g.parent_data(t2)[pos[0]])
            total += m.comm_class(data, p, p2)
    return total


def min_comp_critical_path(g: TaskGraph, comp: np.ndarray) -> tuple[float, list[int]]:
    """The classical CP_MIN (Definition 4 / SLR denominator): longest path using
    per-task minimum computation cost, communication ignored."""
    w = comp.min(axis=1)
    dist = np.full(g.n, NEG)
    pred = np.full(g.n, -1, np.int64)
    dist[g.sources] = w[g.sources]
    for i in range(g.n):
        for j in g.children(i):
            nd = dist[i] + w[j]
            if nd > dist[j]:
                dist[j] = nd
                pred[j] = i
    snk = int(g.sinks[np.argmax(dist[g.sinks])])
    path = [snk]
    while pred[path[-1]] >= 0:
        path.append(int(pred[path[-1]]))
    return float(dist[snk]), path[::-1]


def averaged_critical_path(g: TaskGraph, comp: np.ndarray, m: Machine) -> tuple[float, list[int]]:
    """The CPOP-style estimated CP: longest path under instance-count-weighted
    mean computation costs and mean communication costs (paper §2's first
    'simplifying assumption', used as the comparison CP in §7/§8)."""
    wbar = m.mean_comp(comp)
    dist = np.full(g.n, NEG)
    pred = np.full(g.n, -1, np.int64)
    dist[g.sources] = wbar[g.sources]
    for i in range(g.n):
        cbar = m.mean_comm(g.child_data(i))
        for j, c in zip(g.children(i), np.atleast_1d(cbar)):
            nd = dist[i] + c + wbar[j]
            if nd > dist[j]:
                dist[j] = nd
                pred[j] = i
    snk = int(g.sinks[np.argmax(dist[g.sinks])])
    path = [snk]
    while pred[path[-1]] >= 0:
        path.append(int(pred[path[-1]]))
    return float(dist[snk]), path[::-1]
