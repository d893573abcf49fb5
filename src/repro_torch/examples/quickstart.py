"""Quickstart: the paper's algorithm in five minutes.

1. Build a heterogeneous workload (the paper's RGG-high generator).
2. Find the true critical path with CEFT -- length AND partial assignment.
3. Compare against CPOP's estimate; schedule with CEFT-CPOP / CPOP / HEFT.

Host work (numpy), so it takes no ``--device``:

  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import ceft, ceft_cpop, cpop, heft, slack, slr, speedup, validate_schedule
from ..core.cpop import cpop_cpl
from ..graphs import rgg


def run() -> dict:
    """CEFT's critical path of a 256-task RGG-high DAG on 8 processors
    (seed 0), CPOP's realized one, and each scheduler's makespan, speedup,
    SLR and slack."""
    rng = np.random.default_rng(0)
    # a 256-task application DAG on 8 heterogeneous processors, strongly
    # heterogeneous execution times (the paper's RGG-high cost model)
    wl = rgg("high", n=256, P=8, rng=rng, o=4, c=0.1, alpha=0.75, beta=50)
    g, comp, machine = wl.graph, wl.comp, wl.machine

    # the paper's contribution: the critical path and its partial schedule
    res = ceft(g, comp, machine)
    out = dict(cpl=float(res.cpl), cpop_cpl=float(cpop_cpl(g, comp, machine)),
               path=list(res.path), schedules={})
    # extended to full schedules (paper section 6)
    for name, algo in (("CEFT-CPOP", lambda: ceft_cpop(g, comp, machine, res)),
                       ("CPOP", lambda: cpop(g, comp, machine)),
                       ("HEFT", lambda: heft(g, comp, machine))):
        s = algo()
        validate_schedule(s, g, comp, machine)
        out["schedules"][name] = dict(makespan=float(s.makespan),
                                      speedup=float(speedup(s, comp, machine)),
                                      slr=float(slr(s, g, comp)),
                                      slack=float(slack(s, g, comp, machine)))
    return out


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    out = run()
    print(f"CEFT critical-path length : {out['cpl']:10.1f}")
    print(f"CPOP's realized CP length : {out['cpop_cpl']:10.1f}")
    print(f"CP tasks -> classes       : {out['path'][:6]} ...")
    for name, s in out["schedules"].items():
        print(f"{name:10s} makespan={s['makespan']:10.1f}  speedup={s['speedup']:5.2f}  "
              f"SLR={s['slr']:5.2f}  slack={s['slack']:8.1f}")
    return out


if __name__ == "__main__":
    main()
