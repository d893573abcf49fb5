"""The port stands alone: importing it loads neither JAX nor the reference
package, and its entry points run on the card unless asked for the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_isolated_script  # noqa: E402


def test_import_loads_no_jax_and_no_reference():
    run_isolated_script("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        assert {"repro_torch.core.ceft_torch", "repro_torch.kernels.ops",
                "repro_torch.kernels.edge_relax_superstep", "repro_torch.kernels.minplus",
                "repro_torch.sched.plancache", "repro_torch.sched.straggler",
                "repro_torch.sched.deadlines", "repro_torch.serve.router",
                "repro_torch.serve.pool", "repro_torch.serve.faults",
                "repro_torch.substrate.compat",
                "repro_torch.interop", "repro_torch.graphs.rgg"} <= set(names), names
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "repro"
                     or m.startswith("repro."))
        assert not bad, bad
        print("IMPORT-OK", len(names))
    """, marker="IMPORT-OK", timeout=120)


def test_cuda_default_raises_without_cuda():
    """The default ``device="cuda"`` raises on a machine without CUDA rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core import ceft_torch as ct
    from repro_torch.core import from_edges, uniform_machine
    from repro_torch.sched import PlanCache, StragglerMonitor

    g = from_edges(3, [(0, 2, 1.0), (1, 2, 1.0)])
    comp = np.ones((3, 2))
    m = uniform_machine(2)
    src, dst, data = np.asarray([0, 1]), np.asarray([2, 2]), np.ones(2)
    calls = [
        lambda: ct.ceft_torch(g, comp, m),
        lambda: ct.ceft_torch_csr(g, comp, m),
        lambda: ct.ceft_batch_csr_results(g, comp[None], m.L[None], m.bw[None]),
        lambda: ct.plan_request_dag(3, src, dst, data, comp, m),
        lambda: ct.plan_request_dags(3, src, dst, data, comp[None], m.L[None], m.bw[None]),
        lambda: PlanCache(),
        lambda: StragglerMonitor(2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert ct.ceft_torch_csr(g, comp, m, device="cpu").cpl == 2.0
