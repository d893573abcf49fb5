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
                "repro_torch.interop", "repro_torch.graphs.rgg",
                "repro_torch.configs", "repro_torch.configs.granite_3_8b",
                "repro_torch.models", "repro_torch.models.common",
                "repro_torch.models.layers", "repro_torch.models.moe",
                "repro_torch.models.transformer", "repro_torch.models.model",
                "repro_torch.models.ssm", "repro_torch.models.encdec",
                "repro_torch.lm_profile",
                "repro_torch.serve.engine", "repro_torch.launch",
                "repro_torch.launch.serve",
                "repro_torch.sched.layer_dag", "repro_torch.sched.partitioner",
                "repro_torch.optim", "repro_torch.optim.adamw",
                "repro_torch.optim.schedules", "repro_torch.data",
                "repro_torch.data.pipeline", "repro_torch.checkpoint",
                "repro_torch.checkpoint.checkpointer", "repro_torch.train",
                "repro_torch.train.trainer", "repro_torch.launch.steps",
                "repro_torch.launch.train", "repro_torch.launch.mesh",
                "repro_torch.launch.pipeline", "repro_torch.optim.grad_compress",
                "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
                "repro_torch.launch.roofline_main",
                "repro_torch.launch.hlo_stats", "repro_torch.examples",
                "repro_torch.examples.quickstart", "repro_torch.examples.serve_batched",
                "repro_torch.examples.train_100m",
                "repro_torch.examples.heterogeneous_pipeline"} <= set(names), names
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
    from repro_torch.configs import get
    from repro_torch.sched import PlanCache, StragglerMonitor
    from repro_torch.serve import Engine, smoke_engine_factory
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import Trainer, TrainerConfig

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
        lambda: Engine(get("granite-3-8b", smoke=True)),
        lambda: Engine(get("mamba2-2.7b", smoke=True)),
        lambda: Engine(get("jamba-v0.1-52b", smoke=True)),
        lambda: smoke_engine_factory("granite-3-8b", "serve"),
        lambda: Trainer(get("minicpm-2b", smoke=True), ShapeCell("t", 16, 2, "train"),
                        TrainerConfig(steps=1)),
        lambda: make_test_mesh(),
        lambda: Trainer(get("minicpm-2b", smoke=True), ShapeCell("t", 16, 2, "train"),
                        TrainerConfig(steps=1), mesh_factory=make_test_mesh),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert ct.ceft_torch_csr(g, comp, m, device="cpu").cpl == 2.0


def test_launcher_defaults_to_the_card(tmp_path):
    """``python -m repro_torch.launch.serve`` (``.train``) and the examples
    ``serve_batched`` and ``train_100m --smoke`` without ``--device`` raise on
    a machine without CUDA rather than serving (training) on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import os
    import subprocess
    import sys

    from conftest import REPO
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for launcher, args in (("launch.serve", ["--max-new", "1"]),
                           ("launch.train", ["--steps", "1"]),
                           ("examples.serve_batched", []),
                           ("examples.train_100m", ["--smoke", "--steps", "1"])):
        r = subprocess.run([sys.executable, "-m", f"repro_torch.{launcher}", *args],
                           env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
        assert r.returncode != 0 and "CUDA is not available" in r.stderr, (launcher, r.stderr)
