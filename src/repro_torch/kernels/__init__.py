"""repro_torch.kernels — hand-written Hopper kernels, one for each Pallas kernel
of the reference package.

edge_relax           : edge-centric relaxation, the Pallas kernel's (B, E, P)
                       contract (``csrc/edge_relax.cu``)
seg_level            : a whole segment-layout level of the CSR sweep in one
                       launch: gather, relax, segment first-max, comp add and
                       carry write (``csrc/edge_relax.cu``, same arithmetic)
ceft_relax           : dense level relaxation of the padded sweep and the
                       dense-layout runs (``csrc/ceft_relax.cu``)
edge_relax_superstep : the edge relaxation over a fused run's stacked (R, E, P)
                       tables in one launch (``csrc/edge_relax_superstep.cu``);
                       like the reference's, not wired into the sweep
minplus              : tropical (min, +) matrix product, float32 and bf16
                       (``csrc/minplus.cu``); nothing in the package calls it
ops                  : the wrappers (CPU -> plain version, CUDA -> kernel), launch
                       counters and the nvcc build
ref                  : PyTorch oracles for all four kernels of the reference package
probes               : seeded edge-case inputs (NaN, inf, -0.0, ties, adversarial
                       divides and bf16 sums) and a NaN-aware equality

Each kernel's plain PyTorch version sits in the module of its name.
"""
from . import ref
from .ops import (LAUNCHES, build_all, ceft_relax, edge_relax, edge_relax_superstep,
                  minplus, reset_launches, seg_level)

__all__ = ["LAUNCHES", "build_all", "ceft_relax", "edge_relax",
           "edge_relax_superstep", "minplus", "ref", "reset_launches", "seg_level"]
