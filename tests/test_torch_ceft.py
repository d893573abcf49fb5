"""The port's device sweeps (``repro_torch.core.ceft_torch``, run on the CPU)
against the reference package's JAX sweeps on the same inputs.

Tolerance: exact.  The float32 CEFT table, ``pred_task``, ``pred_proc``,
``cpl`` and the backtracked critical path are bit-equal for the padded, CSR,
batched and resumed sweeps; the run tables from ``_fused_runs`` are equal
array for array."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (  # noqa: E402
    from_edge_arrays,
    from_edges,
    linear_chain,
    random_machine,
    uniform_machine,
)
from repro.core import ceft_jax as cj  # noqa: E402
from repro.graphs import (  # noqa: E402
    epigenomics,
    fft_graph,
    gaussian_elimination,
    heavy_tail_fan_in,
    molecular_dynamics,
    rgg,
    star_fan_in,
)
from repro_torch import graphs as tgraphs  # noqa: E402
from repro_torch.core import ceft_torch as ct  # noqa: E402
from repro_torch.interop import from_reference_arrays  # noqa: E402
from conftest import make_random_dag  # noqa: E402
from test_plancache import _layered_graph  # noqa: E402

CPU = "cpu"


def _machine(P, seed=0):
    return random_machine(P, np.random.default_rng(seed),
                          bw_range=(0.5, 2.0), L_range=(0.0, 1.0))


def _same_result(a, b):
    np.testing.assert_array_equal(a.ceft, b.ceft)
    np.testing.assert_array_equal(a.pred_task, b.pred_task)
    np.testing.assert_array_equal(a.pred_proc, b.pred_proc)
    assert a.cpl == b.cpl and a.sink == b.sink and a.sink_proc == b.sink_proc
    assert a.path == b.path


def _assert_port_equal(g, comp, m):
    """Port padded and CSR sweeps == the reference's, bit for bit."""
    tg, tm, tcomp = from_reference_arrays(g, m, comp)
    want_pad = cj.ceft_jax(g, comp, m)
    want_csr = cj.ceft_jax_csr(g, comp, m)
    _same_result(ct.ceft_torch(tg, tcomp, tm, device=CPU), want_pad)
    _same_result(ct.ceft_torch_csr(tg, tcomp, tm, device=CPU), want_csr)


# --------------------------------------------------------- the sweep cases
def test_single_task():
    _assert_port_equal(from_edges(1, []), np.array([[3.0, 7.0]]), _machine(2))


def test_single_level():
    rng = np.random.default_rng(42)
    _assert_port_equal(from_edges(6, []), rng.uniform(1, 10, (6, 3)), _machine(3))


@pytest.mark.parametrize("seed,g", [
    (1, linear_chain(17, data=2.5)),
    (40, linear_chain(65, data=1.5)),
    (2, star_fan_in(65)),
    (3, heavy_tail_fan_in(80, np.random.default_rng(3))),
    (41, gaussian_elimination(9)),
    (101, gaussian_elimination(6)),
    (102, fft_graph(8)),
    (103, molecular_dynamics()),
    (104, epigenomics(6)),
])
def test_graph_zoo(seed, g):
    rng = np.random.default_rng(seed)
    _assert_port_equal(g, rng.uniform(1, 10, (g.n, 4)), _machine(4, seed))


@pytest.mark.parametrize("seed,g", [
    (201, gaussian_elimination(6)),
    (202, molecular_dynamics()),
    (203, star_fan_in(33)),
])
def test_transposed_graphs(seed, g):
    gt = g.transpose()
    rng = np.random.default_rng(seed)
    _assert_port_equal(gt, rng.uniform(1, 10, (gt.n, 3)), _machine(3))


def test_tie_breaking():
    """Exactly tied candidates: the first maximal parent in ascending-id
    order wins, in both packages."""
    g = from_edges(4, [(0, 3, 1.0), (1, 3, 1.0), (2, 3, 1.0)])
    comp = np.array([[2.0, 2.0], [2.0, 2.0], [2.0, 2.0], [1.0, 1.0]])
    _assert_port_equal(g, comp, uniform_machine(2, bw=1.0, L=0.0))


@pytest.mark.parametrize("seed", range(6))
def test_random_dags(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 12))
    P = int(rng.integers(1, 5))
    g = make_random_dag(n, 0.4, rng)
    comp = rng.uniform(1, 10, size=(n, P))
    _assert_port_equal(g, comp, random_machine(P, rng, bw_range=(0.5, 2.0),
                                               L_range=(0.0, 1.0)))


def test_rgg_multi_run_segment_sweep():
    """An RGG at P = 64 (the paper's class count): segment-layout runs."""
    wl = rgg("high", 600, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    _assert_port_equal(wl.graph, wl.comp, wl.machine)


def _tied(g, P, seed):
    """``g`` with edge data in {0, 1, 2}, integer costs in {1, 2, 3} and a
    homogeneous machine (L = 1, bw = 2): every candidate is exact in float32,
    so equal candidates and equal segment maxima are common."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(g.n, dtype=np.int32), np.diff(g.cindptr))
    gi = from_edge_arrays(g.n, src, g.cindices, rng.integers(0, 3, g.n_edges).astype(float))
    return gi, rng.integers(1, 4, (g.n, P)).astype(float), uniform_machine(P, bw=2.0, L=1.0)


@pytest.mark.parametrize("seed,g", [
    (61, heavy_tail_fan_in(400, np.random.default_rng(61))),
    (62, heavy_tail_fan_in(3000, np.random.default_rng(62))),
    (63, rgg("high", 600, 8, np.random.default_rng(5), o=4, alpha=0.75, beta=50).graph),
], ids=["heavytail400", "heavytail3000", "rgg600"])
def test_segment_sweep_with_ties_matches_reference(seed, g):
    """The segment-layout levels (the fused level's plain version) through the
    whole CSR sweep on tie-heavy integer costs, single and batched (B = 3),
    against the reference's ``ceft_jax_csr``: bit-equal.  heavytail3000 has a
    segment of 2834 edges."""
    gi, comp, m = _tied(g, 8, seed)
    tg, tm, _ = from_reference_arrays(gi, m)
    layouts = [r.layout for r in ct.csr_device_inputs(tg, comp, tm, device=CPU)[0]]
    assert "seg" in layouts
    _same_result(ct.ceft_torch_csr(tg, comp, tm, device=CPU), cj.ceft_jax_csr(gi, comp, m))
    rng = np.random.default_rng(seed)
    comps = rng.integers(1, 4, (3, gi.n, m.P)).astype(np.float32)
    Ls = np.full((3, m.P), 1.0, np.float32)
    bws = np.full((3, m.P, m.P), 2.0, np.float32)
    bws[1] = 4.0
    got = ct.ceft_torch_batch_csr(tg, comps, Ls, bws, device=CPU)
    want = cj.ceft_jax_batch_csr(gi, comps, Ls, bws)
    for a, b, name in zip(got, want, ["ceft", "ptask", "pproc"]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.mark.parametrize("task", [3, 10, 40])
def test_csr_sweep_on_a_nan_cost_plane(task):
    """One NaN cost (task ``task``, class 2) through the whole CSR sweep of an
    RGG with multi-segment levels, against ``ceft_jax_csr``.  The CEFT tables
    are equal, NaN positions included.  The predecessors differ only where
    a NaN parent decides a child's maximum inside a multi-segment level:
    there the port points at the first NaN parent (edge order) and its first
    NaN class, as the reference's single-segment and dense levels do, while
    the reference's multi-segment form finds no edge equal to the NaN
    maximum and points at the level's last edge (ROADMAP Queue 3)."""
    wl = rgg("high", 600, 8, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    g, comp, m = wl.graph, wl.comp.copy(), wl.machine
    comp[task, 2] = np.nan
    tg, tm, _ = from_reference_arrays(g, m)
    got = ct.ceft_torch_csr(tg, comp, tm, device=CPU)
    want = cj.ceft_jax_csr(g, comp, m)
    np.testing.assert_array_equal(got.ceft, want.ceft)
    nan_row = np.isnan(got.ceft).any(axis=1)
    src = np.repeat(np.arange(g.n), np.diff(g.cindptr))
    nan_parents = [[] for _ in range(g.n)]
    for s, d in zip(src, g.cindices):
        if nan_row[s]:
            nan_parents[d].append(int(s))
    diverges = np.zeros(got.pred_task.shape, bool)
    for run in ct.csr_device_inputs(tg, comp, tm, device=CPU)[0]:
        for lv in run.levels:
            if run.layout != "seg":
                continue
            for t in lv.tasks.tolist():
                if not nan_parents[t]:
                    continue
                p = min(nan_parents[t])
                assert (got.pred_task[t] == p).all()
                assert (got.pred_proc[t] == np.flatnonzero(np.isnan(got.ceft[p]))[0]).all()
                if lv.width > 1:
                    diverges[t] = True
                    assert (want.pred_task[t] == int(lv.edge_src[-1])).all()
    differ = (got.pred_task != want.pred_task) | (got.pred_proc != want.pred_proc)
    assert differ.any() and not (differ & ~diverges).any()


# --------------------------------------------------------- run tables
@pytest.mark.parametrize("g", [
    linear_chain(40),
    gaussian_elimination(8),
    star_fan_in(41),
    heavy_tail_fan_in(150, np.random.default_rng(51)),
    rgg("high", 600, 8, np.random.default_rng(5), o=4, alpha=0.75, beta=50).graph,
], ids=["chain", "ge", "star", "heavytail", "rgg"])
def test_fused_runs_match_reference(g):
    """Same runs, spans, layouts and table contents as the reference."""
    tg = from_reference_arrays(g)[0]
    want_runs, want_vb, want_spans = cj._fused_runs(g)
    got_runs, got_vb, got_spans = ct._fused_runs(tg)
    assert (got_vb, got_spans) == (want_vb, want_spans)
    assert len(got_runs) == len(want_runs)
    for a, b in zip(got_runs, want_runs):
        assert type(a).__name__ == type(b).__name__
        for field in ("tasks", "edge_src", "edge_data", "edge_seg", "e_real",
                      "par", "pdata"):
            if hasattr(b, field):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_port_generators_match_reference():
    """The port's copies of the workload generators give the reference's
    graphs, cost planes and machines for the same seed."""
    a = rgg("high", 300, 8, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    b = tgraphs.rgg("high", 300, 8, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    np.testing.assert_array_equal(a.comp, b.comp)
    np.testing.assert_array_equal(a.machine.bw, b.machine.bw)
    for f in ("cindptr", "cindices", "cdata", "pindptr", "pindices", "pdata", "level"):
        np.testing.assert_array_equal(getattr(a.graph, f), getattr(b.graph, f))
    a = heavy_tail_fan_in(200, np.random.default_rng(9))
    b = tgraphs.heavy_tail_fan_in(200, np.random.default_rng(9))
    np.testing.assert_array_equal(a.pindices, b.pindices)
    np.testing.assert_array_equal(star_fan_in(30).pindptr, tgraphs.star_fan_in(30).pindptr)


# ------------------------------------------------------- batched sweeps
def _batch_inputs(g, B, P, rng):
    comps = rng.uniform(1, 10, (B, g.n, P)).astype(np.float32)
    Ls = rng.uniform(0, 1, (B, P)).astype(np.float32)
    bws = rng.uniform(0.5, 2, (B, P, P)).astype(np.float32)
    return comps, Ls, bws


@pytest.mark.parametrize("seed,g", [
    (301, linear_chain(33)),
    (302, gaussian_elimination(6)),
    (303, star_fan_in(40)),
    (304, heavy_tail_fan_in(60, np.random.default_rng(304))),
    (305, epigenomics(5)),
])
def test_batched_sweeps_match_reference(seed, g):
    rng = np.random.default_rng(seed)
    comps, Ls, bws = _batch_inputs(g, 3, 4, rng)
    tg = from_reference_arrays(g)[0]
    want = cj.ceft_jax_batch_csr(g, comps, Ls, bws)
    got = ct.ceft_torch_batch_csr(tg, comps, Ls, bws, device=CPU)
    pad = ct.ceft_torch_batch(tg, comps, Ls, bws, device=CPU)
    for a, b, c, name in zip(got, pad, want, ["ceft", "ptask", "pproc"]):
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=name)
        np.testing.assert_array_equal(b.numpy(), np.asarray(c), err_msg=name)
    results = ct.ceft_batch_csr_results(tg, comps, Ls, bws, device=CPU)
    for got_r, want_r in zip(results, cj.ceft_batch_csr_results(g, comps, Ls, bws)):
        _same_result(got_r, want_r)


def test_request_dag_helpers():
    src = np.asarray([0, 1, 2, 2], np.int32)
    dst = np.asarray([2, 2, 3, 4], np.int32)
    data = np.asarray([1.0, 2.0, 1.0, 0.5])
    rng = np.random.default_rng(7)
    comp = rng.uniform(1, 10, (5, 3))
    m = _machine(3)
    tm = from_reference_arrays(machine=m)[1]
    _same_result(ct.plan_request_dag(5, src, dst, data, comp, tm, device=CPU),
                 cj.plan_request_dag(5, src, dst, data, comp, m))
    assert ct.request_graph(5, src, dst, data) is ct.request_graph(5, src.copy(), dst, data)
    comps, Ls, bws = _batch_inputs(from_edges(5, []), 2, 3, rng)
    for a, b in zip(ct.plan_request_dags(5, src, dst, data, comps, Ls, bws, device=CPU),
                    cj.plan_request_dags(5, src, dst, data, comps, Ls, bws)):
        _same_result(a, b)


# ------------------------------------------------------- dirty-frontier resume
def test_resume_at_each_run_matches_full_sweep():
    """Resuming at run r from the carry kept after run r-1, with comp rows
    changed only in levels of runs >= r, is bit-identical to a full sweep
    (of the port and of the reference)."""
    rng = np.random.default_rng(1)
    g, starts = _layered_graph(rng)
    m = uniform_machine(3, bw=1.0, L=0.1)
    comp = rng.uniform(1, 10, (g.n, m.P))
    tg, tm, _ = from_reference_arrays(g, m)
    carries: list = []
    ct.csr_sweep(ct.csr_device_inputs(tg, comp, tm, device=CPU), keep_carries=carries)
    _, _, spans = ct._fused_runs(tg)
    assert len(spans) >= 3 and len(carries) == len(spans)
    for r in range(1, len(spans)):
        comp2 = comp.copy()
        lo = spans[r][0]
        comp2[int(starts[lo])] *= 1.7          # a row in the first level of run r
        inputs = ct.csr_device_inputs(tg, comp2, tm, device=CPU)
        resumed = ct.csr_sweep(inputs, resume=(r, carries[r - 1]))
        full = ct.csr_sweep(inputs)
        for a, b in zip(resumed, full):
            assert torch.equal(a, b)
        _same_result(ct._result(tg, resumed), cj.ceft_jax_csr(g, comp2, m))
    # the kept snapshots were never updated in place by the resumes
    again: list = []
    ct.csr_sweep(ct.csr_device_inputs(tg, comp, tm, device=CPU), keep_carries=again)
    for a, b in zip(carries, again):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
