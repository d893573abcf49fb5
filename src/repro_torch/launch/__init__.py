"""repro_torch.launch — the serving and training launchers (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``), the
train, prefill and decode steps with their shardings (``steps``), the meshes
(``mesh``), the GPipe forward (``pipeline``), and the analysis tools on a
fake fleet: the multi-pod dry-run (``dryrun``), the roofline
(``roofline``, ``roofline_main``) and the collective inventory
(``hlo_stats``)."""
from .mesh import make_production_mesh, make_test_mesh, mesh_axis_sizes
from .steps import build_decode, build_prefill, build_train

__all__ = ["build_decode", "build_prefill", "build_train",
           "make_production_mesh", "make_test_mesh", "mesh_axis_sizes"]
