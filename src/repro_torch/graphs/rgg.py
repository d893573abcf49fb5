"""Randomly generated workloads (paper §7.1).

Four families sharing one structure generator (parameters n, o, c, alpha, beta,
gamma) but differing in how execution times are drawn:

  * RGG-classic — eq. (5): w_ij ~ U(w_i (1-beta/2), w_i (1+beta/2)) -- at most a
    3x fast/slow ratio, Topcuoglu-style; homogeneous communication backbone.
  * RGG-low / medium / high — eq. (6) two-node-weight cost model:
    Cost(t_i, p_j) = w1(t_i)/W1(p_j) + w0(t_i)/W0(p_j), node weights drawn from
    two intervals {I1, I2} swapped with probability beta -- tasks can be fast on
    some processors while those processors are not universally faster.

beta is given in percent ({10,25,50,75,95}) as in §7.1 and divided by 100.
Each processor in the paper's processor graphs has its own weights, so classes
== processors (counts of 1) for these workloads.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.machine import Machine, random_machine, uniform_machine
from ..core.taskgraph import TaskGraph, from_edges

INTERVALS = {
    "resource": ((1e2, 1e3), (1e3, 1e4)),
    "low": ((1e2, 1e3), (1e3, 1e4)),
    "medium": ((1e2, 1e3), (1e4, 1e5)),
    "high": ((1e2, 1e3), (1e5, 1e6)),
}


@dataclasses.dataclass
class Workload:
    graph: TaskGraph
    comp: np.ndarray  # (v, P) class-view execution times
    machine: Machine
    meta: dict


# --------------------------------------------------------------------- structure
def rgg_structure(
    n: int, o: float, alpha: float, rng: np.random.Generator
) -> tuple[list[tuple[int, int]], np.ndarray]:
    """Level-structured DAG: height ~ sqrt(n)/alpha, level widths ~ U(mean =
    alpha*sqrt(n)); every vertex has >=1 parent in an earlier level (except
    level 0) and average out-degree ~ o.  Returns (edges, level_of_vertex)."""
    height = max(2, min(n, int(round(np.sqrt(n) / alpha))))
    mean_w = max(1.0, alpha * np.sqrt(n))
    widths = []
    left = n
    for lvl in range(height):
        remaining_lvls = height - lvl
        if remaining_lvls == 1:
            w = left
        else:
            w = int(np.clip(rng.uniform(0.5 * mean_w, 1.5 * mean_w), 1, left - (remaining_lvls - 1)))
        widths.append(w)
        left -= w
        if left == 0:
            break
    levels: list[np.ndarray] = []
    start = 0
    for w in widths:
        levels.append(np.arange(start, start + w))
        start += w
    lvl_of = np.zeros(n, np.int32)
    for li, l in enumerate(levels):
        lvl_of[l] = li

    edges: set[tuple[int, int]] = set()
    # every non-root vertex gets a parent in the previous level (connectivity)
    for li in range(1, len(levels)):
        for v in levels[li]:
            u = int(rng.choice(levels[li - 1]))
            edges.add((u, int(v)))
    # extra forward edges to hit average out-degree o
    target = int(o * n)
    later = [np.concatenate(levels[li + 1 :]) if li + 1 < len(levels) else np.empty(0, int)
             for li in range(len(levels))]
    attempts = 0
    while len(edges) < target and attempts < 20 * target:
        attempts += 1
        u = int(rng.integers(0, n))
        cand = later[lvl_of[u]]
        if cand.size == 0:
            continue
        v = int(rng.choice(cand))
        edges.add((u, v))
    return sorted(edges), lvl_of


def _skew_mask(n: int, lvl_of: np.ndarray, gamma: float, rng: np.random.Generator) -> np.ndarray:
    """gamma-skewness (§7.1): larger gamma concentrates computation in 'hot'
    pockets.  We mark ~gamma of the levels hot; hot tasks get x(1 + 9*gamma)
    weight (an interpretation -- the paper gives no formula)."""
    n_lvl = int(lvl_of.max()) + 1
    hot_levels = rng.random(n_lvl) < gamma
    factor = np.where(hot_levels[lvl_of], 1.0 + 9.0 * gamma, 1.0)
    return factor


# ----------------------------------------------------------------------- weights
def classic_workload(
    g: TaskGraph,
    P: int,
    c: float,
    beta: float,
    rng: np.random.Generator,
    *,
    gamma: float = 0.0,
    lvl_of: np.ndarray | None = None,
    w_dag_range: tuple[float, float] = (1.0, 100.0),
) -> Workload:
    """eq. (5)/(7) weighting on an existing structure + homogeneous comm."""
    b = beta / 100.0 if beta > 1 else beta
    w_dag = rng.uniform(*w_dag_range)
    w = rng.uniform(0, 2 * w_dag, size=g.n)
    if gamma > 0 and lvl_of is not None:
        w = w * _skew_mask(g.n, lvl_of, gamma, rng)
    comp = w[:, None] * rng.uniform(1 - b / 2, 1 + b / 2, size=(g.n, P))
    # edge weight = w_src * c * U(1 +- beta/2); machine is homogeneous (bw=1, L=0)
    src = np.repeat(np.arange(g.n), np.diff(g.cindptr))
    cdata = w[src] * c * rng.uniform(1 - b / 2, 1 + b / 2, size=g.n_edges)
    g2 = _with_edge_data(g, cdata)
    m = uniform_machine(P)
    return Workload(g2, comp, m, {"kind": "classic", "c": c, "beta": beta})


def interval_workload(
    g: TaskGraph,
    P: int,
    c: float,
    beta: float,
    kind: str,
    rng: np.random.Generator,
    *,
    gamma: float = 0.0,
    lvl_of: np.ndarray | None = None,
    hetero_bw: bool = True,
    proc_beta: float = 0.5,
) -> Workload:
    """eq. (6) two-node-weight cost model (RGG-low/medium/high).

    The paper uses *one fixed set* of six processor graphs across every
    workload, so the processor population is a (roughly even) mix of the two
    interval orderings regardless of the workload's beta -- hence the separate
    ``proc_beta`` defaulting to 0.5.
    """
    b = beta / 100.0 if beta > 1 else beta
    tI1, tI2 = INTERVALS[kind]
    rI1, rI2 = INTERVALS["resource"]

    def draw_two(nu: int, I1, I2, prob):
        swap = rng.random(nu) >= prob
        a = rng.uniform(*I1, size=nu)
        z = rng.uniform(*I2, size=nu)
        w1 = np.where(swap, z, a)
        w0 = np.where(swap, a, z)
        return w1, w0

    tw1, tw0 = draw_two(g.n, tI1, tI2, b)
    if gamma > 0 and lvl_of is not None:
        f = _skew_mask(g.n, lvl_of, gamma, rng)
        tw1, tw0 = tw1 * f, tw0 * f
    pW1, pW0 = draw_two(P, rI1, rI2, proc_beta)
    comp = tw1[:, None] / pW1[None, :] + tw0[:, None] / pW0[None, :]  # eq. (6)

    # edge weight from the task's mean execution time (scalar proxy for w_i)
    wbar = comp.mean(axis=1)
    src = np.repeat(np.arange(g.n), np.diff(g.cindptr))
    cdata = wbar[src] * c * rng.uniform(1 - b / 2, 1 + b / 2, size=g.n_edges)
    g2 = _with_edge_data(g, cdata)
    m = (
        random_machine(P, rng, bw_range=(0.5, 2.0))
        if hetero_bw
        else uniform_machine(P)
    )
    return Workload(g2, comp, m, {"kind": kind, "c": c, "beta": beta})


def _with_edge_data(g: TaskGraph, cdata: np.ndarray) -> TaskGraph:
    """Rebuild the graph with new edge data (cdata aligned to children CSR)."""
    src = np.repeat(np.arange(g.n), np.diff(g.cindptr))
    edges = list(zip(src.tolist(), g.cindices.tolist(), cdata.tolist()))
    return from_edges(g.n, edges)


# ------------------------------------------------------------------ entry point
def rgg(
    kind: str,
    n: int,
    P: int,
    rng: np.random.Generator,
    *,
    o: float = 4.0,
    c: float = 1.0,
    alpha: float = 1.0,
    beta: float = 50.0,
    gamma: float = 0.1,
) -> Workload:
    """One experiment's workload: structure + weights + machine.

    kind in {"classic", "low", "medium", "high"}.
    """
    edges, lvl_of = rgg_structure(n, o, alpha, rng)
    g = from_edges(n, [(a, b, 1.0) for a, b in edges])
    if kind == "classic":
        wl = classic_workload(g, P, c, beta, rng, gamma=gamma, lvl_of=lvl_of)
    else:
        wl = interval_workload(g, P, c, beta, kind, rng, gamma=gamma, lvl_of=lvl_of)
    wl.meta.update({"n": n, "P": P, "o": o, "alpha": alpha, "gamma": gamma})
    return wl
