"""Task-graph representation (paper §3.1).

A task graph is a weighted DAG G_t(V_t, E_t): vertices are tasks, edges carry the
data volume communicated from a parent task to a child task.  We keep the graph in
CSR form in both directions (children and parents), require vertex ids to be a
topological order (the paper's Algorithm 1 assumes this), and pre-compute the
longest-path *level* of every vertex so the vectorized CEFT sweep can process one
level at a time.

This module is the only place that builds level tables for the device sweeps:
``padded_level_tables`` (the dense (n_levels, Wmax, Dmax) form) and
``csr_level_segments`` (the edge-centric CSR form whose total size is O(v + e)).
Everything else must consume these structures, not rebuild them.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskGraph:
    n: int
    # children CSR: edges (i -> cindices[cindptr[i]:cindptr[i+1]])
    cindptr: np.ndarray
    cindices: np.ndarray
    cdata: np.ndarray  # data volume per child edge
    # parents CSR (transpose), aligned data
    pindptr: np.ndarray
    pindices: np.ndarray
    pdata: np.ndarray
    # longest-path depth of each vertex (sources are level 0)
    level: np.ndarray

    # ------------------------------------------------------------------ basics
    @property
    def n_edges(self) -> int:
        return int(self.cindices.shape[0])

    def children(self, i: int) -> np.ndarray:
        return self.cindices[self.cindptr[i] : self.cindptr[i + 1]]

    def child_data(self, i: int) -> np.ndarray:
        return self.cdata[self.cindptr[i] : self.cindptr[i + 1]]

    def parents(self, i: int) -> np.ndarray:
        return self.pindices[self.pindptr[i] : self.pindptr[i + 1]]

    def parent_data(self, i: int) -> np.ndarray:
        return self.pdata[self.pindptr[i] : self.pindptr[i + 1]]

    @property
    def in_degree(self) -> np.ndarray:
        return np.diff(self.pindptr)

    @property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.cindptr)

    @property
    def sources(self) -> np.ndarray:
        return np.nonzero(self.in_degree == 0)[0]

    @property
    def sinks(self) -> np.ndarray:
        return np.nonzero(self.out_degree == 0)[0]

    @property
    def n_levels(self) -> int:
        return int(self.level.max()) + 1 if self.n else 0

    def levels(self) -> list[np.ndarray]:
        """Vertices grouped by longest-path depth (each a topological batch)."""
        order, bounds = _level_order(self)
        return [order[bounds[k] : bounds[k + 1]] for k in range(self.n_levels)]

    # --------------------------------------------------------------- transforms
    def transpose(self) -> "TaskGraph":
        """Edge-reversed graph (paper §8.2: rank_ceft_up runs CEFT on G^T).

        Vertex ids are relabelled as ``n-1-i`` so that ids remain a topological
        order of the transposed graph.
        """
        n = self.n
        remap = n - 1 - np.arange(n, dtype=np.int32)
        src = np.repeat(np.arange(n, dtype=np.int32), self.out_degree)
        return from_edge_arrays(n, remap[self.cindices], remap[src], self.cdata)

    def with_virtual_source_sink(self) -> tuple["TaskGraph", int, int]:
        """Add a zero-cost virtual entry/exit if the graph has several of either.

        Returns (graph, vsrc, vsink) where vsrc/vsink are -1 when not added.
        Virtual vertices get id 0 / n+? while preserving topological ids.
        """
        srcs, snks = self.sources, self.sinks
        add_src = len(srcs) > 1
        add_snk = len(snks) > 1
        if not add_src and not add_snk:
            return self, -1, -1
        off = 1 if add_src else 0
        n = self.n + off + (1 if add_snk else 0)
        src = np.repeat(np.arange(self.n, dtype=np.int64), self.out_degree) + off
        dst = self.cindices.astype(np.int64) + off
        dat = self.cdata.astype(np.float64)
        vsrc = 0 if add_src else -1
        vsink = n - 1 if add_snk else -1
        if add_src:
            src = np.concatenate([src, np.zeros(len(srcs), np.int64)])
            dst = np.concatenate([dst, srcs.astype(np.int64) + off])
            dat = np.concatenate([dat, np.zeros(len(srcs))])
        if add_snk:
            src = np.concatenate([src, snks.astype(np.int64) + off])
            dst = np.concatenate([dst, np.full(len(snks), n - 1, np.int64)])
            dat = np.concatenate([dat, np.zeros(len(snks))])
        return from_edge_arrays(n, src, dst, dat), vsrc, vsink


def graph_fingerprint(g: TaskGraph) -> bytes:
    """Content digest of a graph's structure and edge weights.

    Two graphs with equal fingerprints are interchangeable for every level
    table / segment structure this module builds (the children CSR determines
    the graph completely; the parent CSR and levels are derived from it).
    Used by the plan cache (repro_torch.sched.plancache) to key plans by *value*,
    so a rebuilt-but-equal graph hits instead of re-sweeping.
    """
    import hashlib

    h = hashlib.sha1()
    h.update(np.int64(g.n).tobytes())
    for a in (g.cindptr, g.cindices, g.cdata):
        a = np.ascontiguousarray(a)
        h.update(a.dtype.str.encode())
        h.update(a.tobytes())
    return h.digest()


def _csr_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flat indices [starts[i] .. starts[i]+counts[i]) concatenated (the
    vectorized multi-row CSR gather)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    first = np.cumsum(counts) - counts
    return np.repeat(starts, counts) + (np.arange(total) - np.repeat(first, counts))


def from_edge_arrays(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    data: np.ndarray,
    *,
    sort_topologically: bool = False,
) -> TaskGraph:
    """Array form of :func:`from_edges` — the fast path for large graphs
    (no Python loop over edges anywhere in the build)."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    dat = np.asarray(data, dtype=np.float64)
    if src.size and not (src < dst).all():
        if not sort_topologically:
            raise ValueError("edges must satisfy src < dst (topological ids); "
                             "pass sort_topologically=True to relabel")
        order = _topo_order(n, src, dst)
        rank = np.empty(n, np.int32)
        rank[order] = np.arange(n, dtype=np.int32)
        src, dst = rank[src], rank[dst]
        if not (src < dst).all():  # pragma: no cover - cycle
            raise ValueError("graph has a cycle")

    def csr(a: np.ndarray, b: np.ndarray, d: np.ndarray):
        order = np.lexsort((b, a))
        a, b, d = a[order], b[order], d[order]
        indptr = np.zeros(n + 1, np.int64)
        np.add.at(indptr, a + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, b.astype(np.int32), d

    cindptr, cindices, cdata = csr(src, dst, dat)
    pindptr, pindices, pdata = csr(dst, src, dat)
    level = _levels_from_csr(n, cindptr, cindices, pindptr)
    return TaskGraph(n, cindptr, cindices, cdata, pindptr, pindices, pdata, level)


def from_edges(
    n: int, edges: Iterable[tuple[int, int, float]], *, sort_topologically: bool = False
) -> TaskGraph:
    """Build a TaskGraph from (src, dst, data) triples.

    Vertex ids must already be a topological order (src < dst) unless
    ``sort_topologically`` is set, in which case we relabel via Kahn's algorithm.
    """
    e = list(edges)
    if e:
        arr = np.asarray(e, dtype=np.float64).reshape(len(e), 3)
        src = arr[:, 0].astype(np.int32)
        dst = arr[:, 1].astype(np.int32)
        dat = arr[:, 2]
    else:
        src = np.zeros(0, np.int32)
        dst = np.zeros(0, np.int32)
        dat = np.zeros(0, np.float64)
    return from_edge_arrays(n, src, dst, dat, sort_topologically=sort_topologically)


def _levels_from_csr(
    n: int, cindptr: np.ndarray, cindices: np.ndarray, pindptr: np.ndarray
) -> np.ndarray:
    """Longest-path depth of every vertex, one vectorized wavefront per level
    (replaces the per-vertex Python loop; O(depth) numpy passes)."""
    level = np.zeros(n, np.int32)
    remaining = np.diff(pindptr).astype(np.int64)
    frontier = np.nonzero(remaining == 0)[0]
    while frontier.size:
        counts = cindptr[frontier + 1] - cindptr[frontier]
        offs = _csr_ranges(cindptr[frontier], counts)
        if offs.size == 0:
            break
        dst = cindices[offs]
        np.maximum.at(level, dst, np.repeat(level[frontier] + 1, counts))
        np.add.at(remaining, dst, -1)
        frontier = np.unique(dst[remaining[dst] == 0])
    return level


def _topo_order(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    indeg = np.zeros(n, np.int64)
    np.add.at(indeg, dst, 1)
    adj: list[list[int]] = [[] for _ in range(n)]
    for a, b in zip(src.tolist(), dst.tolist()):
        adj[a].append(b)
    stack = [i for i in range(n) if indeg[i] == 0]
    out = []
    while stack:
        i = stack.pop()
        out.append(i)
        for j in adj[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                stack.append(j)
    if len(out) != n:
        raise ValueError("graph has a cycle")
    return np.asarray(out, dtype=np.int32)


def linear_chain(n: int, data: float = 1.0) -> TaskGraph:
    return from_edges(n, [(i, i + 1, data) for i in range(n - 1)])


def moldable_fork_join_arrays(
    volumes: np.ndarray, split: int
) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Edge arrays for a *moldable* fork-join batch DAG (Wang & Sinnen).

    ``volumes[i]`` is batch ``i``'s divisible work (a request class's prefill
    token volume); ``split`` is the planner-chosen degree d.  Each batch
    becomes d parallel chunk tasks (vertices ``i*d .. i*d+d-1``, volume/d
    each) joining into one sink task (vertex ``n_batches*d + i``), with edge
    data the chunk volume — the KV handoff cost a join pays per chunk that
    lands on a different class.  ``split=1`` reproduces the classic
    prefill->decode chain arrays byte-for-byte, which is what keeps the
    router's content-keyed graph store hitting for unsplit plans.

    Returns ``(n, src, dst, data)`` ready for :func:`from_edge_arrays` (chunk
    ids precede join ids, so vertex ids are already topological).
    """
    volumes = np.asarray(volumes, np.float64)
    G = int(volumes.size)
    d = int(split)
    if d < 1:
        raise ValueError(f"split degree must be >= 1, got {d}")
    src = np.arange(G * d, dtype=np.int32)
    dst = (G * d + src // d).astype(np.int32)
    data = np.repeat(volumes / d, d)
    return G * d + G, src, dst, data


def moldable_fork_join(volumes: np.ndarray, split: int) -> TaskGraph:
    """:func:`moldable_fork_join_arrays` built into a TaskGraph (the graph-zoo
    / tournament entry point; the router keeps the raw arrays for the
    content-keyed graph store)."""
    return from_edge_arrays(*moldable_fork_join_arrays(volumes, split))


# --------------------------------------------------------------- level tables
def _level_order(g: TaskGraph) -> tuple[np.ndarray, np.ndarray]:
    """(order, bounds): vertices stably sorted by level (ascending id within a
    level) and the per-level start offsets into ``order``."""
    order = np.argsort(g.level, kind="stable")
    bounds = np.searchsorted(g.level[order], np.arange(g.n_levels + 1))
    return order, bounds


def _slots_from_order(g: TaskGraph, order: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Within-level position of every vertex under the :meth:`TaskGraph.levels`
    ordering (ascending vertex id within a level)."""
    slot = np.empty(g.n, np.int32)
    slot[order] = (np.arange(g.n) - bounds[g.level[order]]).astype(np.int32)
    return slot


def padded_level_tables(g: TaskGraph) -> dict[str, np.ndarray]:
    """Fixed-shape per-level tables for the padded CEFT sweep.

    Returns arrays padded to (n_levels, max_width) and (n_levels, max_width, dmax):
      tasks  : vertex id or -1
      par    : parent vertex id or -1
      pdata  : data volume on the parent edge (0 where padded)
    Level 0 rows are sources (no parents).
    """
    order, bounds = _level_order(g)
    n_levels = g.n_levels
    widths = np.diff(bounds)
    width = int(widths.max()) if n_levels else 0
    indeg = g.in_degree
    dmax = max(1, int(indeg.max()) if g.n else 1)
    tasks = np.full((n_levels, width), -1, np.int32)
    par = np.full((n_levels, width, dmax), -1, np.int32)
    pdat = np.zeros((n_levels, width, dmax), np.float32)
    if g.n == 0:
        return {"tasks": tasks, "par": par, "pdata": pdat}
    slot = _slots_from_order(g, order, bounds)
    tasks[g.level[order], slot[order]] = order
    # scatter every parent edge into its (level, slot, k) cell in one pass
    edst = np.repeat(np.arange(g.n, dtype=np.int64), indeg)
    k = np.arange(g.n_edges) - np.repeat(g.pindptr[:-1], indeg)
    par[g.level[edst], slot[edst], k] = g.pindices
    pdat[g.level[edst], slot[edst], k] = g.pdata
    return {"tasks": tasks, "par": par, "pdata": pdat}


@dataclasses.dataclass(frozen=True)
class LevelSegments:
    """Edge-centric CSR level structure: the O(v + e) alternative to
    :func:`padded_level_tables` (paper §5's O(P²e) bound).

    Vertices are ordered by (level, id); each level's parent edges form one
    contiguous run, ordered by (child slot, parent id) so per-child segments
    are contiguous and tie-breaking matches the dense formulation (first
    maximal parent in ascending-id order wins).

      task_ids    : (n,)  vertex ids sorted by (level, id)
      task_bounds : (n_levels+1,) level k's tasks are task_ids[tb[k]:tb[k+1]]
      edge_src    : (e,)  parent vertex id per edge
      edge_data   : (e,)  data volume per edge
      edge_seg    : (e,)  within-level slot of the child vertex (segment id)
      edge_bounds : (n_levels+1,) level k's edges are rows eb[k]:eb[k+1]
    """
    task_ids: np.ndarray
    task_bounds: np.ndarray
    edge_src: np.ndarray
    edge_data: np.ndarray
    edge_seg: np.ndarray
    edge_bounds: np.ndarray

    @property
    def n_levels(self) -> int:
        return int(self.task_bounds.shape[0]) - 1

    def level_tasks(self, k: int) -> np.ndarray:
        return self.task_ids[self.task_bounds[k] : self.task_bounds[k + 1]]

    def level_edges(self, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        s = slice(self.edge_bounds[k], self.edge_bounds[k + 1])
        return self.edge_src[s], self.edge_data[s], self.edge_seg[s]


@dataclasses.dataclass(frozen=True)
class FusedLevelRun:
    """Stacked super-step tables: a run of adjacent levels sharing one padded
    shape, stacked along a leading axis so a device sweep walks the whole
    run from one set of tables instead of building one per level.

      tasks     : (R, W) vertex ids, padded with the caller's pad vertex
      edge_src  : (R, E) parent vertex id per edge, padded with the pad vertex
      edge_data : (R, E) data volume per edge (0 where padded)
      edge_seg  : (R, E) within-level child slot, padded with W - 1
      e_real    : (R,)   real (unpadded) edge count per level
      width     : W — the per-level segment count (padding slots included)

    Rows past the run's natural length are no-op levels (all-padding tasks and
    edges, ``e_real == 0``): a sweep may execute them freely, they only touch
    the padding scratch slot.
    """
    tasks: np.ndarray
    edge_src: np.ndarray
    edge_data: np.ndarray
    edge_seg: np.ndarray
    e_real: np.ndarray
    width: int

    @property
    def n_levels(self) -> int:
        return int(self.tasks.shape[0])


def fuse_levels(
    segs: LevelSegments,
    widths: Sequence[int],
    edge_caps: Sequence[int],
    *,
    pad_vertex: int,
    pad_run: "Callable[[int], int] | None" = None,
    run_ids: "Sequence[int] | None" = None,
) -> list[FusedLevelRun]:
    """Group adjacent levels landing in the same padded shape into stacked
    super-step tables.

    ``widths[k-1]`` / ``edge_caps[k-1]`` give level ``k``'s padded task/edge
    capacity for ``k in [1, n_levels)`` — the *caller* chooses them (the pow2
    bucket policy is owned by core/ceft_torch.py; this pass only groups equal
    shapes).  Level 0 (sources, no parent edges) is never part of a run.
    ``pad_run`` optionally maps a run's natural length to its padded length;
    appended levels are no-ops (see :class:`FusedLevelRun`).

    ``run_ids`` (aligned with ``widths``) makes the grouping explicit instead
    of by-equal-shape: adjacent levels group iff they share a non-negative
    run id, and levels with a negative id are skipped entirely (the caller
    builds those through another layout, e.g. :func:`fuse_levels_dense`).
    """
    n_levels = segs.n_levels
    if n_levels > 1 and (len(widths) != n_levels - 1 or len(edge_caps) != n_levels - 1):
        raise ValueError("need one (width, edge_cap) per level in [1, n_levels)")
    if run_ids is not None and len(run_ids) != n_levels - 1:
        raise ValueError("need one run id per level in [1, n_levels)")

    def same_group(a: int, b: int) -> bool:
        if run_ids is not None:
            return run_ids[a - 1] == run_ids[b - 1]
        return (int(widths[a - 1]), int(edge_caps[a - 1])) == (
            int(widths[b - 1]), int(edge_caps[b - 1]))

    runs: list[FusedLevelRun] = []
    k = 1
    while k < n_levels:
        if run_ids is not None and run_ids[k - 1] < 0:
            k += 1
            continue
        j = k
        key = (int(widths[k - 1]), int(edge_caps[k - 1]))
        while j + 1 < n_levels and same_group(k, j + 1):
            j += 1
            if (int(widths[j - 1]), int(edge_caps[j - 1])) != key:
                raise ValueError("a run must share one (width, edge_cap)")
        W, E = key
        R = j - k + 1
        R_pad = int(pad_run(R)) if pad_run is not None else R
        tasks = np.full((R_pad, W), pad_vertex, np.int32)
        src = np.full((R_pad, E), pad_vertex, np.int32)
        dat = np.zeros((R_pad, E), np.float32)
        seg = np.full((R_pad, E), W - 1, np.int32)
        e_real = np.zeros(R_pad, np.int32)
        for r, lv in enumerate(range(k, j + 1)):
            t = segs.level_tasks(lv)
            es, ed, eg = segs.level_edges(lv)
            if len(t) > W or len(es) > E:
                raise ValueError(f"level {lv} exceeds its padded shape {key}")
            tasks[r, : len(t)] = t
            src[r, : len(es)] = es
            dat[r, : len(es)] = ed
            seg[r, : len(es)] = eg
            e_real[r] = len(es)
        runs.append(FusedLevelRun(tasks, src, dat, seg, e_real, W))
        k = j + 1
    return runs


@dataclasses.dataclass(frozen=True)
class FusedDenseRun:
    """Dense-layout super-step tables: a run of adjacent levels stacked into
    run-local (R, W, D) padded parent tables (the `padded_level_tables` form
    restricted to one run and its own width/fan-in buckets).

    The device sweep picks this layout for runs with no *within-level*
    in-degree skew (W·D ≈ E): the dense contraction then does the same work
    as the segment form with cheaper per-level reductions.  Padding follows
    `padded_level_tables`: vertex/parent ids -1, data 0; rows past the run's
    natural length are all-padding no-op levels.
    """
    tasks: np.ndarray   # (R, W) vertex ids, -1 padded
    par: np.ndarray     # (R, W, D) parent vertex ids, -1 padded
    pdata: np.ndarray   # (R, W, D) data volume per parent edge (0 padded)

    @property
    def n_levels(self) -> int:
        return int(self.tasks.shape[0])


def fuse_levels_dense(
    segs: LevelSegments,
    start: int,
    stop: int,
    width: int,
    depth: int,
    *,
    pad_run: "Callable[[int], int] | None" = None,
) -> FusedDenseRun:
    """Build one run's dense (R, width, depth) tables for levels [start, stop)
    directly from the CSR segments — O(run edges) host work at the caller's
    *run-local* buckets.  (Slicing graph-global `padded_level_tables` would
    cost O(n_levels·Wmax·Dmax) to extract a narrow run, reintroducing the
    padding blowup the fused sweep exists to avoid; a run of narrow levels
    must not pay for the widest level elsewhere in the graph.)

    Parent slots follow the `padded_level_tables` convention — per child, the
    k-th slot is its k-th parent in ascending-id order — so the dense scan
    body tie-breaks identically."""
    R = stop - start
    R_pad = int(pad_run(R)) if pad_run is not None else R
    tasks = np.full((R_pad, width), -1, np.int32)
    par = np.full((R_pad, width, depth), -1, np.int32)
    pdat = np.zeros((R_pad, width, depth), np.float32)
    for r, lv in enumerate(range(start, stop)):
        t = segs.level_tasks(lv)
        es, ed, eg = segs.level_edges(lv)
        if len(t) > width:
            raise ValueError(f"level {lv} width {len(t)} exceeds {width}")
        tasks[r, : len(t)] = t
        if len(es) == 0:
            continue
        # within-segment position: edges are sorted by (slot, parent id)
        starts = np.zeros(len(es), np.int64)
        first = np.flatnonzero(np.diff(eg)) + 1
        starts[first] = first
        np.maximum.accumulate(starts, out=starts)
        k = np.arange(len(es)) - starts
        if int(k.max()) >= depth:
            raise ValueError(f"level {lv} fan-in {int(k.max()) + 1} exceeds {depth}")
        par[r, eg, k] = es
        pdat[r, eg, k] = ed
    return FusedDenseRun(tasks, par, pdat)


def stack_cost_planes(
    g: TaskGraph, comps: "Sequence[np.ndarray] | np.ndarray"
) -> np.ndarray:
    """Validate and stack per-scenario ``(v, P)`` cost planes into the
    float32 ``(B, v, P)`` array the batched device sweep runs on."""
    if not isinstance(comps, np.ndarray):
        comps = np.stack([np.asarray(c) for c in comps])
    comps = np.asarray(comps, np.float32)
    if comps.ndim != 3 or comps.shape[1] != g.n:
        raise ValueError(f"comps must be (B, {g.n}, P); got {comps.shape}")
    return comps


def csr_batch_segments(
    g: TaskGraph, comps: "Sequence[np.ndarray] | np.ndarray"
) -> tuple[LevelSegments, np.ndarray]:
    """Shared segment arrays + stacked per-scenario cost planes for the
    batched CSR sweep.

    The level/segment structure depends only on the graph, so one
    :class:`LevelSegments` is shared across the whole batch; the per-scenario
    cost planes are stacked via :func:`stack_cost_planes`.
    """
    return csr_level_segments(g), stack_cost_planes(g, comps)


def csr_level_segments(g: TaskGraph) -> LevelSegments:
    """Flatten each level's parent edges into contiguous segments.

    The parents-CSR is already ordered by (child, parent); a stable sort of
    edges by the child's level groups each level's edges contiguously while
    preserving that order, so within a level edges run over children in slot
    order with each child's parents in ascending-id order.
    """
    order, bounds = _level_order(g)
    slot = _slots_from_order(g, order, bounds)
    indeg = g.in_degree
    edst = np.repeat(np.arange(g.n, dtype=np.int64), indeg)
    eorder = np.argsort(g.level[edst], kind="stable")
    edge_bounds = np.searchsorted(g.level[edst][eorder], np.arange(g.n_levels + 1))
    return LevelSegments(
        task_ids=order.astype(np.int32),
        task_bounds=bounds.astype(np.int64),
        edge_src=g.pindices[eorder].astype(np.int32),
        edge_data=g.pdata[eorder],
        edge_seg=slot[edst[eorder]],
        edge_bounds=edge_bounds.astype(np.int64),
    )
