"""The paper's technique as a runtime feature: plan pipeline stages for the
assigned architectures across a heterogeneous fleet with CEFT, then react to
a straggling class by re-planning (CEFT-CPOP).

The plans are host work; the straggler monitor's re-plans sweep on the card
unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.heterogeneous_pipeline --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import configs as C
from ..configs.base import SHAPES
from ..sched import DEFAULT_FLEET, StragglerMonitor, build_layer_dag, plan_pipeline

ARCHS = ("llama3-405b", "jamba-v0.1-52b", "mamba2-2.7b")
CELLS = ("train_4k", "decode_32k")
STRAGGLER_ARCH, STRAGGLER_CELL, N_MICRO, SLOW_CLASS, SLOW_FROM, SLOWDOWN = \
    "glm4-9b", "train_4k", 4, 0, 4, 3.0


def plans() -> dict:
    """(arch, cell) -> the pipeline plan's CEFT critical path, its CEFT-CPOP,
    CPOP and HEFT makespans (seconds) and its stages by device class."""
    out = {}
    for arch in ARCHS:
        for cell in CELLS:
            plan = plan_pipeline(C.get(arch), SHAPES[cell])
            classes: dict[str, int] = {}
            for s in plan.stages:
                classes[s.device_class] = classes.get(s.device_class, 0) + 1
            out[arch, cell] = dict(cpl=plan.cpl, makespan=plan.makespan,
                                   makespan_cpop=plan.makespan_cpop,
                                   makespan_heft=plan.makespan_heft, classes=classes)
    return out


def straggler(device="cuda") -> dict | None:
    """glm4-9b's training layer DAG under a monitor whose re-plans sweep on
    ``device``; class 0 runs 3x slow from step 4.  The first re-plan's event
    (step, class, slowdown, old and new makespan) and the classes its
    schedule uses, or None when no class trips."""
    g, comp, m, _ = build_layer_dag(C.get(STRAGGLER_ARCH), SHAPES[STRAGGLER_CELL],
                                    n_micro=N_MICRO)
    mon = StragglerMonitor(m.P, threshold=1.3, device=device)
    for step in range(1, 8):
        times = np.ones(m.P)
        if step >= SLOW_FROM:
            times[SLOW_CLASS] = SLOWDOWN
        sched, ev = mon.maybe_replan(step, g, comp, m, times)
        if ev:
            return dict(step=ev.step, device_class=ev.device_class, slowdown=ev.slowdown,
                        old_makespan=ev.old_makespan, new_makespan=ev.new_makespan,
                        classes=sorted(set(m.inst_class[sched.proc].tolist())))
    return None


def run(device="cuda") -> dict:
    return dict(plans=plans(), straggler=straggler(device))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the straggler monitor's re-plans sweep")
    args = ap.parse_args(argv)
    out = run(args.device)
    for (arch, cell), p in out["plans"].items():
        print(f"{arch:16s} {cell:10s} CPL={p['cpl']*1e3:9.2f}ms "
              f"makespan={p['makespan']*1e3:9.2f}ms (cpop {p['makespan_cpop']*1e3:9.2f}, "
              f"heft {p['makespan_heft']*1e3:9.2f})  classes={p['classes']}")
    print(f"\nstraggler: {DEFAULT_FLEET[SLOW_CLASS].name} slice degrades {SLOWDOWN:g}x during "
          f"{STRAGGLER_ARCH} training")
    ev = out["straggler"]
    if ev:
        print(f"  step {ev['step']}: class {ev['device_class']} slowdown {ev['slowdown']:.2f}x "
              f"-> replanned, makespan {ev['old_makespan']*1e3:.1f} -> "
              f"{ev['new_makespan']*1e3:.1f} ms (degraded costs)")
        print(f"  classes now in use: {ev['classes']}")
    return out


if __name__ == "__main__":
    main()
