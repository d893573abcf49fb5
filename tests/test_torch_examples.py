"""The port's examples (``repro_torch.examples``) against the reference's, on
the CPU: each example's ``run`` returns the figures it prints, and the test
computes the reference's with the same library calls its example makes
(``repro.core``, ``repro.sched.plan_pipeline``, ``build_layer_dag``,
``StragglerMonitor.maybe_replan``, ``repro.serve.Engine``), not by running
its script.

Tolerances: the scheduling figures and the straggler event bit for bit (both
packages plan in float64 numpy, and the port's sweep promises the
reference's bits); the served tokens identical in float32 compute, from the
reference engines' weights (``params_from_reference``); the training run's
loss falls, and a run that loses a node at step 12 and restores the step-0
anchor logs the unfailed run's losses bit for bit (one process, one rank:
the same data stream and state, so nothing may differ)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro_torch.examples import (heterogeneous_pipeline, quickstart,  # noqa: E402
                                  serve_batched, train_100m)


def test_quickstart_matches_reference():
    """CEFT's critical path and partial assignment, CPOP's realized one and
    the three schedules' makespan, speedup, SLR and slack on the seeded
    256-task RGG-high DAG equal the reference's."""
    from repro.core import ceft, ceft_cpop, cpop, heft, slack, slr, speedup
    from repro.core.cpop import cpop_cpl
    from repro.graphs import rgg
    wl = rgg("high", n=256, P=8, rng=np.random.default_rng(0), o=4, c=0.1, alpha=0.75,
             beta=50)
    g, comp, m = wl.graph, wl.comp, wl.machine
    res = ceft(g, comp, m)
    want = dict(cpl=float(res.cpl), cpop_cpl=float(cpop_cpl(g, comp, m)), path=list(res.path),
                schedules={})
    for name, s in (("CEFT-CPOP", ceft_cpop(g, comp, m, res)), ("CPOP", cpop(g, comp, m)),
                    ("HEFT", heft(g, comp, m))):
        want["schedules"][name] = dict(makespan=float(s.makespan),
                                       speedup=float(speedup(s, comp, m)),
                                       slr=float(slr(s, g, comp)),
                                       slack=float(slack(s, g, comp, m)))
    got = quickstart.run()
    assert got == want
    assert got["cpl"] <= got["cpop_cpl"]


def test_heterogeneous_pipeline_matches_reference():
    """Every (arch, cell) plan's critical path, three makespans and stages by
    class, and the glm4-9b straggler's event and classes in use, from
    ``run(device="cpu")``, equal the reference's."""
    from repro.configs.base import SHAPES
    from repro.sched import StragglerMonitor, build_layer_dag, plan_pipeline
    hp = heterogeneous_pipeline
    want = {}
    for arch in hp.ARCHS:
        for cell in hp.CELLS:
            plan = plan_pipeline(JC.get(arch), SHAPES[cell])
            classes: dict[str, int] = {}
            for s in plan.stages:
                classes[s.device_class] = classes.get(s.device_class, 0) + 1
            want[arch, cell] = dict(cpl=plan.cpl, makespan=plan.makespan,
                                    makespan_cpop=plan.makespan_cpop,
                                    makespan_heft=plan.makespan_heft, classes=classes)
    g, comp, m, _ = build_layer_dag(JC.get(hp.STRAGGLER_ARCH), SHAPES[hp.STRAGGLER_CELL],
                                    n_micro=hp.N_MICRO)
    mon = StragglerMonitor(m.P, threshold=1.3)
    for step in range(1, 8):
        times = np.ones(m.P)
        if step >= hp.SLOW_FROM:
            times[hp.SLOW_CLASS] = hp.SLOWDOWN
        sched, ev = mon.maybe_replan(step, g, comp, m, times)
        if ev:
            break
    got = hp.run(device="cpu")
    assert got["plans"] == want
    assert got["straggler"] == dict(
        step=ev.step, device_class=ev.device_class, slowdown=ev.slowdown,
        old_makespan=ev.old_makespan, new_makespan=ev.new_makespan,
        classes=sorted(set(m.inst_class[sched.proc].tolist())))


def test_serve_batched_matches_reference_engines():
    """The three engines (the demo dense model, mixtral smoke with its ring
    cache, mamba2 smoke) in float32 compute from the reference engines'
    weights: every greedy token equals the reference ``Engine``'s on the
    same prompts, each sequence EOS-padded after its first EOS."""
    from repro.configs.base import ArchConfig
    from repro.serve import Engine, ServeConfig
    from repro_torch.interop import params_from_reference
    sb = serve_batched
    jcfgs = {"dense": ArchConfig(**dataclasses.asdict(sb.CFG)),
             "swa": dataclasses.replace(JC.get("mixtral-8x22b", smoke=True), window=8),
             "ssm": JC.get("mamba2-2.7b", smoke=True)}
    params, want = {}, {}
    for name, jcfg in jcfgs.items():
        eng = Engine(dataclasses.replace(jcfg, compute_dtype="float32"))
        x, new = sb.prompts()[name]
        want[name] = np.asarray(eng.generate(x, ServeConfig(max_new_tokens=new, eos_id=sb.EOS)))
        params[name] = params_from_reference(jax.tree.map(np.asarray, eng.params), "cpu")
    got = sb.run(device="cpu", params=params, compute_dtype="float32")
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        toks = got[name]["tokens"]
        assert toks.shape == w.shape and np.array_equal(toks, w), name
        for row in toks[:, sb.prompts()[name][0].shape[1]:]:
            hit = np.flatnonzero(row == sb.EOS)
            assert not hit.size or (row[hit[0]:] == sb.EOS).all(), (name, row)


def test_train_100m_smoke_recovers_bit_for_bit(tmp_path):
    """``main(["--smoke", "--device", "cpu", "--steps", "20", "--fail-at",
    "12"])``: the loss falls, one restart is logged, and every logged
    step's loss equals an unfailed run's bit for bit."""
    args = ["--smoke", "--device", "cpu", "--steps", "20"]
    grouped = torch.distributed.is_initialized()
    failed = train_100m.main([*args, "--fail-at", "12", "--ckpt", str(tmp_path / "failed")])
    whole = train_100m.main([*args, "--ckpt", str(tmp_path / "whole")])
    for run in (failed, whole):
        assert run["losses"][-1]["loss"] < run["losses"][0]["loss"]
        assert run["n_params"] == dataclasses.replace(train_100m.CFG_100M,
                                                      **train_100m.SMOKE).n_params()
    assert failed["restarts"] == 1 and whole["restarts"] == 0
    assert [e["step"] for e in failed["events"] if "restart" in str(e["event"])] == [12]
    la = {m["step"]: m["loss"] for m in whole["losses"]}
    lb = {m["step"]: m["loss"] for m in failed["losses"]}
    assert sorted(la) == sorted(lb) == [10, 20]
    assert la == lb
    # a process group the runs started, they ended
    assert torch.distributed.is_initialized() == grouped
