"""The port's plan cache and straggler loop (``repro_torch.sched``, run on the
CPU) against the reference package's on the same inputs.

Tolerance: exact.  Statuses and counters are equal step for step, partial
re-sweeps are bit-identical to full ones, and the realized ``ceft_cpop``
schedule (instance, start, finish, makespan) is identical to the
reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planners as jplanners  # noqa: E402
from repro.core import uniform_machine  # noqa: E402
from repro.core.ceft_jax import ceft_jax_csr  # noqa: E402
from repro.graphs import rgg  # noqa: E402
from repro.sched import PlanCache as JPlanCache  # noqa: E402
from repro.sched import StragglerMonitor as JStragglerMonitor  # noqa: E402
from repro_torch.core import planners  # noqa: E402
from repro_torch.core.ceft_torch import ceft_torch_csr  # noqa: E402
from repro_torch.core.schedule import validate_schedule  # noqa: E402
from repro_torch.interop import from_reference_arrays  # noqa: E402
from repro_torch.sched import PlanCache, StragglerMonitor  # noqa: E402
from repro_torch.sched import plancache as PC  # noqa: E402
from test_plancache import _layered_graph  # noqa: E402

CPU = "cpu"


def _same_result(a, b):
    np.testing.assert_array_equal(a.ceft, b.ceft)
    np.testing.assert_array_equal(a.pred_task, b.pred_task)
    np.testing.assert_array_equal(a.pred_proc, b.pred_proc)
    assert a.cpl == b.cpl and a.path == b.path


def _same_plan(a, b):
    np.testing.assert_array_equal(a.proc, b.proc)
    np.testing.assert_array_equal(a.start, b.start)
    np.testing.assert_array_equal(a.finish, b.finish)
    assert a.makespan == b.makespan and a.cpl == b.cpl
    assert a.cp_tasks == b.cp_tasks and a.cp_classes == b.cp_classes


def _setup(seed=1):
    rng = np.random.default_rng(seed)
    g, starts = _layered_graph(rng)
    m = uniform_machine(3, bw=1.0, L=0.1)
    comp = rng.uniform(1, 10, (g.n, m.P))
    tg, tm, _ = from_reference_arrays(g, m)
    return rng, g, m, comp, tg, tm, starts


def test_plan_statuses_counters_and_results_match_reference():
    """hit / full / partial in step with the reference, each result
    bit-equal to it and to a from-scratch sweep."""
    rng, g, m, comp, tg, tm, starts = _setup()
    pc, jpc = PlanCache(device=CPU), JPlanCache()
    planes = [comp]
    for row in (int(starts[16]), int(starts[7]), 0):   # deep, mid, source deltas
        c = planes[-1].copy()
        c[row] *= float(rng.uniform(1.1, 2.0))
        planes.append(c)
    c = planes[-1] * np.asarray([1.0, 2.3, 1.0])[None]   # a column rescale
    planes += [c, c, planes[0]]
    statuses = []
    for c in planes:
        res, status, _ = pc.plan(tg, c, tm)
        jres, jstatus, _ = jpc.plan(g, c, m)
        statuses.append(status)
        assert status == jstatus
        _same_result(res, jres)
        _same_result(res, ceft_torch_csr(tg, c, tm, device=CPU))
    assert statuses == ["full", "partial", "partial", "full", "full", "hit", "full"]
    assert pc.snapshot() == jpc.snapshot()


def test_store_false_is_transient():
    rng, g, m, comp, tg, tm, _ = _setup(9)
    pc = PlanCache(device=CPU)
    res0, status0, entry0 = pc.plan(tg, comp, tm, slot="router")
    assert status0 == "full"
    hedged = comp.copy()
    hedged[:, 0] *= 1e6
    res1, _, entry1 = pc.plan(tg, hedged, tm, slot="router", store=False)
    _same_result(res1, ceft_jax_csr(g, hedged, m))
    assert entry1 is not entry0
    res2, status2, entry2 = pc.plan(tg, comp, tm, slot="router")
    assert status2 == "hit" and entry2 is entry0
    _same_result(res2, res0)


def test_invalidate_and_eviction_follow_reference():
    rng, g, m, comp, tg, tm, _ = _setup(4)
    pc = PlanCache(capacity=2, device=CPU)
    _, _, ea = pc.plan(tg, comp, tm, slot="a", classes=[(8, 4)])
    _, _, eb = pc.plan(tg, comp * 2, tm, slot="b", classes=[(16, 4)])
    assert pc.invalidate(wclass=(8, 4)) == 1 and ea.dirty and not eb.dirty
    pc.plan(tg, comp * 3, tm, slot="c")
    assert len(pc) == 2 and pc.invalidate(wclass=(8, 4)) == 0


def test_device_state_keeps_run_tables_on_device():
    _, _, _, _, tg, _, _ = _setup()
    runs, srcs, v_b, spans = PC.device_state(tg, CPU)
    assert PC.device_state(tg, "cpu")[0] is runs
    assert all(lv.tasks.device.type == "cpu" for r in runs for lv in r.levels)
    assert len(spans) == len(runs) >= 3


@pytest.mark.parametrize("planner", ["ceft_cpop", "heft"])
def test_realized_plan_matches_reference(planner):
    """The realized Plan through the cache equals the reference's
    ``planners.realize`` on the same inputs (the float64 host path for
    non-CEFT planners)."""
    wl = rgg("high", 200, 8, np.random.default_rng(3), o=4, alpha=0.75, beta=50)
    g, m, comp = wl.graph, wl.machine, wl.comp
    tg, tm, _ = from_reference_arrays(g, m)
    res, _, _ = PlanCache(device=CPU).plan(tg, comp, tm, planner=planner)
    jres, _, _ = JPlanCache().plan(g, comp, m, planner=planner)
    got = planners.realize(planner, tg, comp, tm, res)
    want = jplanners.realize(planner, g, comp, m, jres)
    _same_plan(got, want)
    validate_schedule(got.schedule, tg, comp, tm)


def test_straggler_steps_match_reference():
    """Quiet, degraded and repeated steps: same schedules, events and cache
    counters as the reference monitor."""
    wl = rgg("high", 150, 4, np.random.default_rng(8), o=4, alpha=0.75, beta=50)
    g, m, comp = wl.graph, wl.machine, wl.comp
    tg, tm, _ = from_reference_arrays(g, m)
    mon, jmon = StragglerMonitor(m.P, device=CPU), JStragglerMonitor(m.P)
    slow = np.ones(m.P)
    slow[2] = 2.5
    for step, times in enumerate([np.ones(m.P), np.ones(m.P), slow, slow, slow]):
        sched, ev = mon.maybe_replan(step, tg, comp, tm, times)
        jsched, jev = jmon.maybe_replan(step, g, comp, m, times)
        _same_plan(sched, jsched)
        assert (ev is None) == (jev is None)
        if ev is not None:
            assert (ev.device_class, ev.slowdown, ev.old_makespan, ev.new_makespan) == (
                jev.device_class, jev.slowdown, jev.old_makespan, jev.new_makespan)
        assert mon.plancache.snapshot() == jmon.plancache.snapshot()
    assert len(mon.events) == 3

