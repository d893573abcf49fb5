"""The port's serving plane (``repro_torch.serve``, planning on the CPU) and
backward deadline propagation against the reference package's on the same
inputs.

Tolerance: exact.  For a fixed snapshot (the same engines, pre-seeded costs,
submissions and measured observations) both routers give the same dispatches,
the same request DAG and bit-equal plans tick by tick; the deadline schedules
are equal array for array; seeded fault plans are the same schedule.  The
chaos soak is held to exactly-once completion, as the reference's is.
Dispatch timings feed the cost table, so ticks are compared with the timings
given, never measured."""
import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serve as jserve  # noqa: E402
from repro.core import ceft as jceft  # noqa: E402
from repro.core import linear_chain  # noqa: E402
from repro.sched import propagate_deadlines as jpropagate  # noqa: E402
from repro.serve.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import ceft as tceft  # noqa: E402
from repro_torch.interop import from_reference_arrays  # noqa: E402
from repro_torch.sched import propagate_deadlines as tpropagate  # noqa: E402
from repro_torch.serve.faults import KINDS, FaultPlan, install_chaos  # noqa: E402
from test_deadlines import _zoo  # noqa: E402

from conftest import REPO  # noqa: E402

CPU = "cpu"


class FakeEngine:
    """Pool member that returns deterministic tokens."""

    def generate(self, prompts, scfg):
        B, P = prompts.shape
        return np.full((B, P + scfg.max_new_tokens), 7, np.int32)


# --------------------------------------------------------------- deadlines
_ZOO = [(2, 0.3, 1, 1), (6, 0.15, 2, 2), (10, 0.3, 3, 3), (14, 0.6, 4, 4),
        (18, 0.3, 3, 11), (12, 0.6, 2, 42)]


@pytest.mark.parametrize("case", _ZOO + ["chain"])
def test_propagate_deadlines_matches_reference(case):
    if case == "chain":
        rng = np.random.default_rng(0)
        from repro.core import random_machine
        g = linear_chain(6, data=2.0)
        comp = rng.uniform(0.5, 4.0, (6, 3))
        m = random_machine(3, rng, bw_range=(0.2, 5.0), L_range=(0.0, 0.5))
    else:
        g, comp, m = _zoo(*case)
    tg, tm, tcomp = from_reference_arrays(g, m, comp)
    jres, tres = jceft(g, comp, m), tceft(tg, tcomp, tm)
    assert tres.path == jres.path and tres.cpl == jres.cpl
    for kw in ({}, {"slo": 0.5 * jres.cpl}, {"sink_slos": {g.n - 1: jres.cpl * 0.9}}):
        want = jpropagate(g, comp, m, jres, **kw)
        got = tpropagate(tg, tcomp, tm, tres, **kw)
        for f in ("classes", "planned_start", "planned_finish", "latest_start",
                  "latest_finish", "slack"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert (got.makespan, got.cpl, got.slo, got.feasible) == \
            (want.makespan, want.cpl, want.slo, want.feasible)


# ------------------------------------------------------------------ router
def _routers(P, classes, *, tiers=None, **kw):
    """A reference router and a port router (device="cpu") over the same
    engines, with the same pre-seeded per-token rates."""
    out = []
    for pkg, extra in ((jserve, {}), (tserve, {"device": CPU})):
        slots = [pkg.EngineSlot(f"e{i}", FakeEngine(), "baseline") for i in range(P)]
        queue = None
        if tiers is not None:
            queue = pkg.AdmissionQueue(tiers={
                name: pkg.TenantTier(name, weight=w, slo=slo)
                for name, (w, slo) in tiers.items()})
        router = pkg.Router(slots, queue=queue, **kw, **extra)
        rng = np.random.default_rng(7)
        for plen in classes:
            for e in range(P):
                router.costs.update((plen, 4), e, float(rng.uniform(0.5e-3, 2e-3)))
        out.append(router)
    return out


def _submit(routers, seed, per_class, classes, tenants=("t0", "t1")):
    for pkg, router in zip((jserve, tserve), routers):
        rng = np.random.default_rng(seed)
        for c, plen in enumerate(classes):
            for k in range(per_class):
                prompt = rng.integers(2, 100, plen - k % 3).astype(np.int32)
                tenant = tenants[(c + k) % len(tenants)]
                assert router.submit(pkg.Request(tenant, prompt, 4, t_submit=100.0))


def _same_result(a, b):
    np.testing.assert_array_equal(a.ceft, b.ceft)
    np.testing.assert_array_equal(a.pred_task, b.pred_task)
    np.testing.assert_array_equal(a.pred_proc, b.pred_proc)
    assert a.cpl == b.cpl and a.path == b.path


def _same_tick(routers):
    jr, tr = routers
    jd, td = jr.tick(), tr.tick()
    key = lambda d: (d.engine, d.wclass, d.on_critical_path, d.node_prefill,  # noqa: E731
                     d.node_decode, d.split, d.deadline, d.slack,
                     [(r.tenant, r.prompt.tobytes(), r.max_new) for r in d.requests])
    assert [key(d) for d in td] == [key(d) for d in jd]
    if jd:
        for a, b in zip(tr.last_dag, jr.last_dag):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        _same_result(tr.last_plan, jr.last_plan)
        assert (tr.last_nominal is None) == (jr.last_nominal is None)
        if jr.last_nominal is not None:
            _same_result(tr.last_nominal, jr.last_nominal)
    assert tr.stats == jr.stats
    return td


ROUTER_CASES = {
    "unsplit": dict(P=3, kw={}),
    "max_split4": dict(P=3, kw={"max_split": 4}),
    "tick_budget": dict(P=2, kw={"tick_budget": 5}),
    "degraded": dict(P=3, kw={"max_split": 2}, degrade=True),
    "tiered": dict(P=3, kw={}, tiers={"gold": (4.0, 0.05), "t1": (1.0, None)},
                   degrade=True),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_matches_reference_tick_by_tick(case):
    spec = ROUTER_CASES[case]
    classes = (8, 16, 32)
    routers = _routers(spec["P"], classes, tiers=spec.get("tiers"), **spec["kw"])
    tenants = ("gold", "t1") if spec.get("tiers") else ("t0", "t1")
    _submit(routers, 1, 4, classes, tenants)
    _same_tick(routers)
    for r in routers:                  # a measured rate dirties the plan
        r.observe(1, (16, 4), 0.004, 100)
    _submit(routers, 2, 3, classes, tenants)
    _same_tick(routers)
    if spec.get("degrade"):            # engine 0 trips the straggler monitor
        for r in routers:
            r.observe_step(np.ones(spec["P"]))
            for _ in range(10):
                r.observe_step(np.r_[5.0, np.ones(spec["P"] - 1)])
        _submit(routers, 3, 3, classes, tenants)
        _same_tick(routers)
        assert routers[1].last_nominal is not None
        assert routers[1].stats["degraded_plans"] >= 1
    for _ in range(12):                # drain what a budget left resident
        if not routers[0].resident:
            break
        _same_tick(routers)
    assert not routers[1].resident


def test_fault_plan_seeded_matches_reference():
    for seed in (7, 23, 101):
        want = JFaultPlan.seeded(seed, 4, calls=8, rate=0.5, hold=0.3)
        got = FaultPlan.seeded(seed, 4, calls=8, rate=0.5, hold=0.3)
        as_tuples = lambda p: {k: (f.worker, f.call, f.kind, f.param)  # noqa: E731
                               for k, f in p._by_slot.items()}
        assert as_tuples(got) == as_tuples(want) and len(got) > 0


@pytest.mark.parametrize("seed", [7, 23])
def test_chaos_soak_every_request_completes_exactly_once(seed):
    """The reference's soak on the port: seeded kills, hangs, delays, drops
    and duplicated replies on a 4-worker pool, planning on the CPU."""
    slots = [tserve.EngineSlot(f"e{i}", FakeEngine(), "baseline") for i in range(4)]
    pool = tserve.EnginePool.from_slots(slots, relaunch_backoff=0.05,
                                        relaunch_backoff_max=0.2)
    inj = install_chaos(pool, seed, calls=8, rate=0.5, hold=0.3)
    inj.hang_timeout = 5.0
    router = tserve.Router(pool, deadline_factor=3.0, min_deadline=0.05,
                           wd_poll=0.005, max_batch=4, device=CPU)
    rng = np.random.default_rng(seed)
    rids = []
    for t, plen in enumerate((8, 16)):
        for _ in range(6):
            r = tserve.Request(f"t{t}", rng.integers(2, 100, plen).astype(np.int32), 4)
            assert router.submit(r)
            rids.append(r.rid)
    try:
        done = router.serve(max_ticks=500)
    finally:
        inj.release()
    assert set(done) == set(rids)
    assert router.stats["completions"] == len(rids)
    assert router.stats["hedges"] <= router.stats["overdue_cp"]
    assert sum(inj.stats[k] for k in KINDS) >= 3, inj.stats
    for rid in rids:
        assert (done[rid] == 7).all()


_PROBE_ENGINE = """
    import sys

    import numpy as np


    class _Probe:
        def generate(self, prompts, scfg):
            import torch
            bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                   or m == "repro" or m.startswith("repro.")]
            B, P = np.asarray(prompts).shape
            out = np.zeros((B, P + scfg.max_new_tokens), np.int32)
            out[0, 0] = len(bad)
            out[0, 1] = int(torch.cuda.is_initialized())
            out[0, 2] = int("repro_torch.serve.pool" in sys.modules)
            return out


    def factory():
        return _Probe()
"""


def test_subprocess_worker_child_loads_no_jax_and_no_reference(tmp_path):
    (tmp_path / "probe_engine.py").write_text(textwrap.dedent(_PROBE_ENGINE))
    env = {"PYTHONPATH": f"{REPO / 'src'}:{tmp_path}"}
    pool = tserve.EnginePool([tserve.WorkerSpec("w0", factory="probe_engine:factory",
                                                backend="subprocess")], child_env=env)
    try:
        out = pool.generate(0, np.zeros((1, 4), np.int32), tserve.ServeConfig(2))
        topo = pool.topology()[0]
    finally:
        pool.close()
    assert out.shape == (1, 6)
    assert out[0, 0] == 0, "the worker child loaded jax or the reference package"
    assert out[0, 1] == 0 and topo["cuda_initialized"] is False
    assert topo["pid"] != os.getpid()
    assert out[0, 2] == 1, "the worker child did not boot from the port"


def test_router_defaults_raise_without_cuda():
    """``Router`` plans on the card unless asked for the CPU: without CUDA its
    default raises, over a slot list and over an ``EnginePool`` alike."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    slots = [tserve.EngineSlot("e0", FakeEngine(), "baseline")]
    for pool in (slots, tserve.EnginePool.from_slots(slots)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.Router(pool)
    assert tserve.Router(slots, device=CPU).plancache.device.type == "cpu"
