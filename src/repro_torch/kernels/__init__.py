"""repro_torch.kernels — hand-written Hopper kernels for the CEFT relaxation.

edge_relax : edge-centric relaxation of the CSR sweep's segment-layout levels
             (``csrc/edge_relax.cu``; plain version in ``edge_relax.py``)
ceft_relax : dense level relaxation of the padded sweep and the dense-layout
             runs (``csrc/ceft_relax.cu``; plain version in ``ceft_relax.py``)
ops        : the wrappers (CPU -> plain version, CUDA -> kernel), launch
             counters and the nvcc build
ref        : PyTorch oracles for all four kernels of the reference package

The reference's ``edge_relax_superstep`` and ``minplus`` kernels are not yet
ported; ``ref`` holds their oracles.
"""
from . import ref
from .ops import LAUNCHES, build_all, ceft_relax, edge_relax, reset_launches

__all__ = ["LAUNCHES", "build_all", "ceft_relax", "edge_relax", "ref",
           "reset_launches"]
