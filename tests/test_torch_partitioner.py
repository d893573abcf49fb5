"""The port's CEFT pipeline partitioner (``repro_torch.sched.layer_dag`` and
``partitioner``) against the reference's on the same configs and cells.

Tolerance: exact.  The layer DAG's CSR and level arrays, its cost plane,
machine and labels are identical, and so is the ``PipelinePlan``: stages,
critical-path length, the three makespans, the assignment and the labels.
Both packages plan on the host in float64 numpy through their planner
registries, so nothing may differ."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.sched import layer_dag as jld  # noqa: E402
from repro.sched import plan_pipeline as jplan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.sched import (DEFAULT_FLEET, DeviceClass, build_layer_dag,  # noqa: E402
                               fleet_machine, plan_pipeline)

GRAPH_FIELDS = ("cindptr", "cindices", "cdata", "pindptr", "pindices", "pdata", "level")

# an explicit two-class fleet: one flops-rich and one bandwidth-rich class
# whose balances cross, plus a host class; numbers chosen for the test
FLEET = [("fast", 4e15, 2e13, 4e10, 3), ("wide", 2e15, 6e13, 8e10, 2),
         ("host", 1e12, 1e11, 1e10, 8)]


def fleets(kind: str):
    """(reference fleet, port fleet), or (None, None) for the default."""
    if kind == "default":
        return None, None
    return ([jld.DeviceClass(*f) for f in FLEET], [DeviceClass(*f) for f in FLEET])


def same_machine(a, b):
    for f in ("L", "bw", "counts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


def test_default_fleet_is_the_reference_fleet():
    assert [dataclasses.astuple(c) for c in DEFAULT_FLEET] == \
        [dataclasses.astuple(c) for c in jld.DEFAULT_FLEET]
    same_machine(fleet_machine(), jld.fleet_machine())
    jf, tf = fleets("explicit")
    same_machine(fleet_machine(tf), jld.fleet_machine(jf))


@pytest.mark.parametrize("arch,cell", [
    ("minicpm-2b", "train_4k"), ("minicpm-2b", "prefill_32k"), ("minicpm-2b", "decode_32k"),
    ("jamba-v0.1-52b", "train_4k"), ("mixtral-8x22b", "decode_32k"),
    ("mamba2-2.7b", "prefill_32k"), ("whisper-tiny", "train_4k"),
])
@pytest.mark.parametrize("fleet", ["default", "explicit"])
def test_layer_dag_matches_reference(arch, cell, fleet):
    jf, tf = fleets(fleet)
    jg, jcomp, jm, jlabels = jld.build_layer_dag(JC.get(arch), JC.SHAPES[cell], jf)
    g, comp, m, labels = build_layer_dag(TC.get(arch), TC.SHAPES[cell], tf)
    assert g.n == jg.n and labels == jlabels
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
        assert getattr(g, f).dtype == getattr(jg, f).dtype, f
    np.testing.assert_array_equal(comp, jcomp)
    same_machine(m, jm)


@pytest.mark.parametrize("arch,cell", [
    ("llama3-405b", "train_4k"), ("jamba-v0.1-52b", "train_4k"),
    ("mamba2-2.7b", "train_4k"), ("glm4-9b", "train_4k"), ("glm4-9b", "decode_32k"),
])
@pytest.mark.parametrize("fleet", ["default", "explicit"])
def test_plan_pipeline_matches_reference(arch, cell, fleet):
    jf, tf = fleets(fleet)
    want = jplan(JC.get(arch), JC.SHAPES[cell], jf)
    got = plan_pipeline(TC.get(arch), TC.SHAPES[cell], tf)
    assert [dataclasses.astuple(s) for s in got.stages] == \
        [dataclasses.astuple(s) for s in want.stages]
    assert (got.cpl, got.makespan, got.makespan_cpop, got.makespan_heft) == \
        (want.cpl, want.makespan, want.makespan_cpop, want.makespan_heft)
    assert got.assignment == want.assignment and got.labels == want.labels
    assert got.speedup_vs_cpop == want.speedup_vs_cpop
    # the reference's own bounds (tests/test_system.py)
    assert got.makespan >= got.cpl * 0.999 and got.makespan <= got.makespan_cpop * 1.001
