"""Level-vectorized CEFT in PyTorch: the device sweeps of the planning path.

The paper's Algorithm 1 is a 4-deep scalar loop.  On the card the DAG is swept
one *topological level* at a time; a whole level's relaxation

    cand[w, k, l, j] = CEFT[par[w,k], l] + comm(l, j | data[w,k])
    CEFT[task_w, j]  = comp[task_w, j] + max_k min_l cand[w, k, l, j]

is relaxed by a hand-written kernel (``kernels/``).  Three formulations, each
bit-identical to the reference package's counterpart in
``repro.core.ceft_jax``:

  * ``ceft_torch`` — the padded dense sweep over (n_levels, Wmax, Dmax)
    tables, relaxed by the ``ceft_relax`` kernel (which splits a wide fan-in
    across warps and blocks) plus a handful of gathers and scatters.  Simple,
    and the reference the CSR sweep is held against.
  * ``ceft_torch_csr`` — the fused hybrid sweep.  Adjacent levels are grouped
    into runs at bucketed shapes (the bucket policy below); per run the layout
    adapts: no within-level in-degree skew -> run-local dense (R, W, D) tables
    through the same level body as ``ceft_torch``; skewed fan-in -> the
    edge-centric segment layout (gather parent CEFT rows per *edge*, relax
    them, take a per-child segmented max with a first-max tie-break in edge
    order, write the children's rows) — O(e·P²) work, the paper's §5 bound.
    On the card a segment-layout level is one ``seg_level`` launch that does
    all of it; on the CPU it is the same steps in plain PyTorch.
  * ``ceft_torch_batch_csr`` — the batched re-planning form: an explicit
    leading batch axis over cost planes / machines, with the run tables shared
    across the batch (the straggler loop's shape).

Every sweep keeps a leading batch axis internally (B = 1 for single sweeps),
so the single and batched forms run one code path.  The level loop is a
Python loop with no host synchronization in it: every quantity a branch
depends on (real widths, real edge counts, layouts) is known on the host when
the tables are built.  Rows past a level's real width are never written, so
the scratch row ``v_b`` stays zero; padded edges read it (plain version) and
never count.

Every entry point runs on the card unless the caller passes ``device="cpu"``;
asking for CUDA on a machine without it raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from .ceft import CeftResult, _finalize
from .machine import Machine
from .taskgraph import (
    FusedDenseRun,
    TaskGraph,
    csr_level_segments,
    fuse_levels,
    fuse_levels_dense,
    padded_level_tables,
    stack_cost_planes,
)

def resolve_device(device) -> torch.device:
    """The torch device for an entry point's ``device=`` argument; CUDA that
    is not available raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


# --------------------------------------------------------------- level bodies
@dataclasses.dataclass(frozen=True)
class DenseLevel:
    """One level's dense tables, cut to its real tasks (a prefix of the
    padded width): vertex ids ``tasks`` (w,), parent ids ``par`` (w, D) with
    padding pointing at the scratch row, edge data ``pdata`` (w, D), the
    float parent mask ``validp`` (w, D) and ``has_par`` (w,)."""
    tasks: torch.Tensor
    par: torch.Tensor
    pdata: torch.Tensor
    validp: torch.Tensor
    has_par: torch.Tensor


def _dense_levels(tasks: np.ndarray, par: np.ndarray, pdata: np.ndarray,
                  scratch: int, device) -> list[DenseLevel]:
    """Device-side :class:`DenseLevel` list for stacked (R, W, D) tables padded
    with -1 (``padded_level_tables`` / ``fuse_levels_dense``); all-padding
    levels are dropped (they write nothing)."""
    out = []
    for r in range(tasks.shape[0]):
        w = int((tasks[r] >= 0).sum())
        if w == 0:
            continue
        valid = par[r, :w] >= 0
        out.append(DenseLevel(
            tasks=torch.as_tensor(tasks[r, :w].astype(np.int64), device=device),
            par=torch.as_tensor(np.where(valid, par[r, :w], scratch).astype(np.int64),
                                device=device),
            pdata=torch.as_tensor(np.ascontiguousarray(pdata[r, :w], np.float32),
                                  device=device),
            validp=torch.as_tensor(valid.astype(np.float32), device=device),
            has_par=torch.as_tensor(valid.any(axis=1), device=device),
        ))
    return out


def _write(carry, tasks, newv, pt, pl) -> None:
    ceft_arr, ptask, pproc = carry
    ceft_arr.index_copy_(1, tasks, newv)
    ptask.index_copy_(1, tasks, pt)
    pproc.index_copy_(1, tasks, pl)


def _dense_level(carry, comp_pad, L, bw, lv: DenseLevel) -> None:
    """The dense level body, shared by the padded sweep and the dense-layout
    runs of the CSR sweep (so the two stay bit-identical by construction).
    carry / comp_pad are (B, V, P); L (B, P); bw (B, P, P)."""
    ceft_arr = carry[0]
    B, _, P = ceft_arr.shape
    w, D = lv.par.shape
    pv = ceft_arr.index_select(1, lv.par.reshape(-1)).view(B, w, D, P)
    maxk, argk, argl = ops.ceft_relax(pv, lv.pdata, lv.validp, L, bw)
    has = lv.has_par[None, :, None]
    relaxed = torch.where(has, maxk, 0.0)
    newv = comp_pad.index_select(1, lv.tasks) + relaxed
    # argk is -1 on rows without parents: clamp for the gather, then mask
    pt = torch.gather(lv.par.expand(B, w, D), 2, argk.clamp_min(0).long())
    pt = torch.where(has, pt, -1).to(torch.int32)
    _write(carry, lv.tasks, newv, pt, argl)


@dataclasses.dataclass(frozen=True)
class SegLevel:
    """One segment-layout level at its run's bucketed shape (W_b, E_b):
    ``tasks`` (w,) real vertex ids, ``edge_src`` / ``edge_data`` /
    ``edge_seg`` (E_b,) with the first ``e_real`` edges real."""
    tasks: torch.Tensor
    edge_src: torch.Tensor
    edge_data: torch.Tensor
    edge_seg: torch.Tensor
    e_real: int
    width: int          # W_b, the run's bucketed segment count


def _seg_level(carry, comp_pad, L, bw, lv: SegLevel) -> None:
    """One level of the edge-centric sweep: per-edge relaxation, then the
    per-child max over its contiguous parent segment with a first-max
    tie-break in edge order (== ascending parent id, matching the dense
    argmax), written into the carry -- one ``seg_level`` launch on the card."""
    ops.seg_level(carry, comp_pad, L, bw, lv.tasks, lv.edge_src, lv.edge_data,
                  lv.edge_seg, lv.e_real, lv.width)


# ------------------------------------------------------------- padded sweep
def _new_carry(B: int, V: int, P: int, device):
    return (torch.zeros((B, V, P), dtype=torch.float32, device=device),
            torch.full((B, V, P), -1, dtype=torch.int32, device=device),
            torch.full((B, V, P), -1, dtype=torch.int32, device=device))


def device_inputs(g: TaskGraph, comps, Ls, bws, *, device="cuda"):
    """Padded-sweep inputs for a batch of planes: (levels, comp_pad
    (B, v+1, P), L (B, P), bw (B, P, P)); row v is the scratch row."""
    dev = resolve_device(device)
    t = padded_level_tables(g)
    levels = _dense_levels(t["tasks"], t["par"], t["pdata"], g.n, dev)
    comps = np.asarray(comps, np.float32)
    B, v, P = comps.shape
    comp_pad = np.zeros((B, v + 1, P), np.float32)
    comp_pad[:, :v] = comps
    return (levels, torch.as_tensor(comp_pad, device=dev),
            torch.as_tensor(np.asarray(Ls, np.float32), device=dev),
            torch.as_tensor(np.asarray(bws, np.float32), device=dev))


def _padded_sweep(inputs):
    levels, comp_pad, L, bw = inputs
    B, V, P = comp_pad.shape
    carry = _new_carry(B, V, P, comp_pad.device)
    for lv in levels:
        _dense_level(carry, comp_pad, L, bw, lv)
    return tuple(c[:, : V - 1] for c in carry)


def ceft_torch(g: TaskGraph, comp: np.ndarray, m: Machine, *,
               device="cuda") -> CeftResult:
    """The padded dense sweep (the reference's ``ceft_jax``)."""
    inputs = device_inputs(g, np.asarray(comp)[None], np.asarray(m.L)[None],
                           np.asarray(m.bw)[None], device=device)
    ceft_arr, ptask, pproc = (c[0].cpu().numpy() for c in _padded_sweep(inputs))
    return _finalize(g, ceft_arr.astype(np.float64), ptask, pproc)


def ceft_torch_batch(g: TaskGraph, comps: np.ndarray, Ls: np.ndarray,
                     bws: np.ndarray, *, device="cuda"):
    """The padded sweep over machines that share P: comps (B, v, P), Ls
    (B, P), bws (B, P, P) -> the (B, v, P) CEFT table and predecessor tables
    (device tensors)."""
    return _padded_sweep(device_inputs(g, comps, Ls, bws, device=device))


# --- bucket policy (single owner in this package: this module) ---------------
# fusion waste budget: adjacent levels fuse into one run as long as the run's
# padded work (R · (W_b + E_b) at the run-max buckets) stays within this
# factor of the real work -- a little padded compute for fewer, larger tables
CSR_FUSE_WASTE = 4.0

# hybrid layout threshold: a fused run takes the dense (R, W, D) layout when
# its width·fan-in bucket is within this factor of its edge bucket (no
# within-level in-degree skew — chains, GE, layered DAGs); skewed runs (star
# fan-in, heavy tails) keep the O(e) segment layout
CSR_DENSE_SKEW = 1.5


def _geo_bucket(r: int) -> int:
    """The shape bucket: the √2-spaced grid {1,2,3,4,6,8,12,16,24,...}.

    O(log) distinct values, so the set of shapes the kernels see stays
    bounded across graphs, while padding wastes <= 1/3 extra work.  Used for
    every bucketed axis: vertex count, per-level width / edge cap, fan-in
    depth and fused run length."""
    b = 1
    while b < r:
        if b < 2:
            b = 2
        elif (b & (b - 1)) == 0:  # pow2 -> pow2 * 1.5
            b += b // 2
        else:                     # pow2 * 1.5 -> next pow2
            b = (b // 3) * 4
    return b


def _fused_runs(g: TaskGraph):
    """Host-side bucketed run tables — the bucket policy lives here, not in
    taskgraph.

    Greedy fusion: extend each run of adjacent levels while the padded work
    at the run-max buckets stays within CSR_FUSE_WASTE of the real work.
    Per-run layout: runs whose width·fan-in bucket is within CSR_DENSE_SKEW of
    the edge bucket take the dense (R, W, D) layout built from run-local
    buckets (``fuse_levels_dense``); skewed runs keep the segment layout
    (``fuse_levels``).  Returns (runs, v_b, spans) with runs a level-ordered
    list of FusedLevelRun / FusedDenseRun and spans the aligned [lo, hi)
    level range of each run (level 0, the init, belongs to no run) — the
    dirty frontier of an incremental re-sweep resolves to a run through
    spans."""
    segs = csr_level_segments(g)
    v_b = _geo_bucket(g.n)
    tb, eb = segs.task_bounds, segs.edge_bounds
    ws = [int(tb[k + 1] - tb[k]) for k in range(1, segs.n_levels)]
    es = [int(eb[k + 1] - eb[k]) for k in range(1, segs.n_levels)]
    groups: list[tuple[int, int, int, int]] = []  # (lo, hi, W_b, E_b), levels [lo, hi)
    start = 0
    cur_w = cur_e = real = 0
    for k in range(len(ws)):
        if k == start:
            cur_w, cur_e = _geo_bucket(ws[k]), _geo_bucket(es[k])
            real = ws[k] + es[k]
            continue
        new_w = max(cur_w, _geo_bucket(ws[k]))
        new_e = max(cur_e, _geo_bucket(es[k]))
        r = k - start + 1
        if r * (new_w + new_e) <= CSR_FUSE_WASTE * (real + ws[k] + es[k]):
            cur_w, cur_e = new_w, new_e
            real += ws[k] + es[k]
        else:  # close the run: waste budget exceeded
            groups.append((start + 1, k + 1, cur_w, cur_e))
            start = k
            cur_w, cur_e = _geo_bucket(ws[k]), _geo_bucket(es[k])
            real = ws[k] + es[k]
    if len(ws) > start:
        groups.append((start + 1, len(ws) + 1, cur_w, cur_e))

    indeg = g.in_degree
    widths = [0] * len(ws)
    ecaps = [0] * len(ws)
    run_ids = [-1] * len(ws)
    layouts = []
    for i, (lo, hi, W_b, E_b) in enumerate(groups):
        run_tasks = segs.task_ids[tb[lo] : tb[hi]]
        D_b = _geo_bucket(int(indeg[run_tasks].max()))
        if W_b * D_b <= CSR_DENSE_SKEW * E_b:
            layouts.append(("dense", lo, hi, W_b, D_b))
        else:
            layouts.append(("seg", lo, hi))
            for k in range(lo - 1, hi - 1):
                widths[k], ecaps[k], run_ids[k] = W_b, E_b, i
    seg_runs = iter(
        fuse_levels(segs, widths, ecaps, pad_vertex=v_b,
                    pad_run=_geo_bucket, run_ids=run_ids)
    )
    runs = []
    spans = []
    for lay in layouts:
        if lay[0] == "dense":
            _, lo, hi, W_b, D_b = lay
            runs.append(fuse_levels_dense(
                segs, lo, hi, W_b, D_b, pad_run=_geo_bucket))
        else:
            _, lo, hi = lay
            runs.append(next(seg_runs))
        spans.append((lo, hi))
    return runs, v_b, tuple(spans)


@dataclasses.dataclass(frozen=True)
class DeviceRun:
    """One fused run on the device: its layout and its real levels (the
    no-op padding levels of the host tables write nothing and are dropped)."""
    layout: str                 # "seg" or "dense"
    levels: tuple               # SegLevel or DenseLevel, one per real level


def _device_runs(runs, v_b: int, device) -> list[DeviceRun]:
    """Move fused run tables to the device once; a re-sweep with a new cost
    plane then uploads only the plane."""
    out = []
    for r in runs:
        if isinstance(r, FusedDenseRun):
            out.append(DeviceRun("dense", tuple(
                _dense_levels(r.tasks, r.par, r.pdata, v_b, device))))
            continue
        levels = []
        for k in range(r.n_levels):
            e = int(r.e_real[k])
            if e == 0:  # a no-op padding level
                continue
            w = int((r.tasks[k] != v_b).sum())
            levels.append(SegLevel(
                tasks=torch.as_tensor(r.tasks[k, :w].astype(np.int64), device=device),
                edge_src=torch.as_tensor(r.edge_src[k].astype(np.int64), device=device),
                edge_data=torch.as_tensor(r.edge_data[k], device=device),
                edge_seg=torch.as_tensor(r.edge_seg[k].astype(np.int64), device=device),
                e_real=e, width=r.width))
        out.append(DeviceRun("seg", tuple(levels)))
    return out


def _build_device_state(g: TaskGraph, device):
    """Uncached build of a graph's device-side sweep state: (device runs,
    source ids, v_b, run level spans).  The store for this state lives in
    :mod:`repro_torch.sched.plancache`; callers go through
    :func:`_graph_device_state` so repeated sweeps of one graph hit it."""
    fused, v_b, spans = _fused_runs(g)
    runs = _device_runs(fused, v_b, device)
    srcs = torch.as_tensor(g.sources.astype(np.int64), device=device)
    return runs, srcs, v_b, spans


def _graph_device_state(g: TaskGraph, device):
    from ..sched import plancache

    runs, srcs, v_b, _spans = plancache.device_state(g, device)
    return runs, srcs, v_b


def csr_device_inputs(g: TaskGraph, comp: np.ndarray, m: Machine, *, device="cuda"):
    """Inputs for :func:`csr_sweep`: (runs, comp_pad (v_b+1, P), srcs,
    L (P,), bw (P, P), v_b).  The run tables come from the plan cache's
    device-state store, so only the cost plane is uploaded per call."""
    dev = resolve_device(device)
    runs, srcs, v_b = _graph_device_state(g, dev)
    v, P = comp.shape
    comp_pad = np.zeros((v_b + 1, P), np.float32)
    comp_pad[:v] = comp
    return (runs, torch.as_tensor(comp_pad, device=dev), srcs,
            torch.as_tensor(np.asarray(m.L, np.float32), device=dev),
            torch.as_tensor(np.asarray(m.bw, np.float32), device=dev), v_b)


def _sweep_runs(runs, comp_pad, srcs, L, bw, *, keep_carries=None, resume=None):
    """The fused sweep over batched inputs: comp_pad (B, V, P), L (B, P),
    bw (B, P, P).  Returns the padded (B, V, P) carry."""
    start, carry = resume if resume is not None else (0, None)
    if carry is None:  # level 0: CEFT(src, j) = comp(src, j), no predecessors
        B, V, P = comp_pad.shape
        carry = _new_carry(B, V, P, comp_pad.device)
        carry[0].index_copy_(1, srcs, comp_pad.index_select(1, srcs))
    else:  # never update a cached snapshot in place
        carry = tuple(c.clone() for c in carry)
    for run in runs[start:]:
        if run.layout == "dense":
            for lv in run.levels:
                _dense_level(carry, comp_pad, L, bw, lv)
        else:
            for lv in run.levels:
                _seg_level(carry, comp_pad, L, bw, lv)
        if keep_carries is not None:
            keep_carries.append(tuple(c.clone() for c in carry))
    return carry


def csr_sweep(inputs, *, keep_carries: list | None = None,
              resume: tuple | None = None):
    """Run the fused CSR sweep over prebuilt :func:`csr_device_inputs`.

    Returns the *padded* (v_b+1, P) device tensors (ceft, pred_task,
    pred_proc); rows >= g.n are scratch.

    Incremental re-sweep hooks (the plan cache's dirty-frontier path):

    * ``keep_carries`` — a list the sweep appends a snapshot of each run's
      output carry to.  The carry after run r-1 depends only on comp rows of
      levels below run r (levels are longest-path depth, so each vertex is
      written exactly once, in its own run), which is what makes run-granular
      resume bit-identical to a full sweep.
    * ``resume=(start, carry)`` — skip runs ``< start`` and continue from the
      snapshot ``carry`` (the keep_carries entry for run start-1) with the
      *current* comp plane.  The snapshot is copied, never updated.  The
      caller guarantees no changed comp row lies below run ``start``."""
    runs, comp_pad, srcs, L, bw, _v_b = inputs
    carry = _sweep_runs(runs, comp_pad[None], srcs, L[None], bw[None],
                        keep_carries=keep_carries, resume=resume)
    return tuple(c[0] for c in carry)


def _result(g: TaskGraph, carry) -> CeftResult:
    v = g.n
    ceft_arr, ptask, pproc = (c[:v].cpu().numpy() for c in carry)
    return _finalize(g, ceft_arr.astype(np.float64), ptask, pproc)


def ceft_torch_csr(g: TaskGraph, comp: np.ndarray, m: Machine, *,
                   device="cuda") -> CeftResult:
    """Edge-centric fused CSR CEFT sweep: O(e·P²) work, bit-identical to
    :func:`ceft_torch` (same float32 arithmetic per candidate, same
    tie-breaking) while doing only real-edge work."""
    return _result(g, csr_sweep(csr_device_inputs(g, comp, m, device=device)))


# ------------------------------------------------------- batched CSR re-planning
def csr_batch_device_inputs(g: TaskGraph, comps, Ls, bws, *, device="cuda"):
    """Inputs for :func:`csr_batch_sweep`: the run tables are shared across
    the batch; cost planes and machines are stacked per scenario.  Returns
    (runs, comp_pad (B, v_b+1, P), srcs, Ls (B, P), bws (B, P, P), v_b)."""
    dev = resolve_device(device)
    comps = stack_cost_planes(g, comps)
    runs, srcs, v_b = _graph_device_state(g, dev)
    B, v, P = comps.shape
    comp_pad = np.zeros((B, v_b + 1, P), np.float32)
    comp_pad[:, :v] = comps
    return (runs, torch.as_tensor(comp_pad, device=dev), srcs,
            torch.as_tensor(np.asarray(Ls, np.float32), device=dev),
            torch.as_tensor(np.asarray(bws, np.float32), device=dev), v_b)


def csr_batch_sweep(inputs):
    """The batched fused CSR sweep: returns the padded (B, v_b+1, P) device
    tensors (ceft, pred_task, pred_proc); rows >= g.n are scratch."""
    runs, comp_pad, srcs, Ls, bws, _v_b = inputs
    return _sweep_runs(runs, comp_pad, srcs, Ls, bws)


def ceft_torch_batch_csr(g: TaskGraph, comps: np.ndarray, Ls: np.ndarray,
                         bws: np.ndarray, *, device="cuda"):
    """Batched re-planning on the CSR formulation: comps (B, v, P), Ls (B, P),
    bws (B, P, P) -> host (B, v, P) arrays, bit-identical to
    :func:`ceft_torch_batch`."""
    v = g.n
    carry = csr_batch_sweep(csr_batch_device_inputs(g, comps, Ls, bws, device=device))
    return tuple(c[:, :v].cpu().numpy() for c in carry)


def ceft_batch_csr_results(g: TaskGraph, comps: np.ndarray, Ls: np.ndarray,
                           bws: np.ndarray, *, device="cuda") -> list[CeftResult]:
    """Finalized :class:`CeftResult` per batched scenario (paper lines 19-26
    applied to each plane) — the form the re-planning schedulers consume."""
    ceft_arr, ptask, pproc = ceft_torch_batch_csr(g, comps, Ls, bws, device=device)
    ceft_np = ceft_arr.astype(np.float64)
    return [_finalize(g, ceft_np[b], ptask[b], pproc[b])
            for b in range(ceft_np.shape[0])]


# ------------------------------------------------------ in-memory request DAGs
def request_graph(n: int, src, dst, data) -> TaskGraph:
    """TaskGraph for an in-memory request DAG — a view over the plan cache's
    content-keyed graph store: structurally-equal edge arrays map to the SAME
    TaskGraph object, so the device-state store hits and the run tables are
    not rebuilt per call.  ``src``/``dst`` must already be topological."""
    from ..sched import plancache

    return plancache.graph_for(n, src, dst, data)


def plan_request_dag(n: int, src, dst, data, comp: np.ndarray, m: Machine, *,
                     device="cuda") -> CeftResult:
    """Plan one in-memory request DAG through the fused CSR sweep: edge arrays
    in, mapped critical path out."""
    return ceft_torch_csr(request_graph(n, src, dst, data), comp, m, device=device)


def plan_request_dags(n: int, src, dst, data, comps: np.ndarray, Ls: np.ndarray,
                      bws: np.ndarray, *, device="cuda") -> list[CeftResult]:
    """Batched scenario planning over one request DAG (nominal + degraded
    cost planes in one batched sweep)."""
    return ceft_batch_csr_results(request_graph(n, src, dst, data), comps, Ls, bws,
                                  device=device)
