"""Stacked edge relaxation: the ``edge_relax`` contraction over a fused run's
stacked (R, E, P) edge tables, in one launch.

    minl[r, e, j] = min_l pv[r, e, l] + (L[l] + pdata[r, e] / bw[l, j]) * [l != j]
    argl[r, e, j] = the first-index argmin class

Replaces the Pallas kernel
``src/repro/kernels/ceft_relax.py:_edge_relax_superstep_kernel`` (entry
``edge_relax_superstep_pallas``), which the reference never wires into a
sweep; it is ported at its entry point, ``ops.edge_relax_superstep``.  The CUDA
kernel is ``csrc/edge_relax_superstep.cu``: persistent blocks that stage L, bw
and RN(1/bw) (one machine, shared by every level) once and walk (level, edge
tile) tiles whose pv rows arrive in shared memory by double-buffered
``cp.async``; a thread relaxes one class j of several edges, the class loop
is unrolled for P in {8, 16, 32, 64}, and the divide is Markstein's
correctly rounded form (one multiply, two FMAs) wherever the operands lie in
the exponent window that makes it exact, ``__fdiv_rn`` elsewhere.  It is
bound by issue slots (about ten instructions a candidate), and every slice is
bit-equal to ``edge_relax`` on that level.  Machines wider than P = 160 go
to a second kernel in the same source that stages only bw and L, reads the
pv rows from global memory and divides with ``__fdiv_rn``.

Unlike ``edge_relax``'s batch axis (cost planes sharing one graph's edges),
the ``r`` axis here is the run's levels: ``pdata`` differs per (r, e) and the
machine is shared.
"""
from __future__ import annotations

import ctypes

import torch

#: the widest machine the CUDA kernel takes: a block holds the P² bw values
#: and L in shared memory (above P = 160 without the reciprocals and the pv
#: tiles, which then come from global memory)
MAX_P = 240


def edge_relax_superstep_plain(pv, pdata, L, bw):
    """The plain PyTorch version: the CPU path and the on-card comparison.

    pv (R, E, P), pdata (R, E), L (P,), bw (P, P) -> (minl (R, E, P),
    argl (R, E, P) int32).  Same operation order as the reference oracle, so
    float32 results are bit-equal to it."""
    P = L.shape[-1]
    off = 1.0 - torch.eye(P, dtype=pv.dtype, device=pv.device)
    comm = (L[:, None] + pdata[..., None, None] / bw) * off        # (R,E,Pl,Pj)
    cand = pv[..., :, None] + comm
    minl, argl = torch.min(cand, dim=-2)
    return minl, argl.to(torch.int32)


def edge_relax_superstep_launch(lib: ctypes.CDLL, pv, pdata, L, bw, n_sm: int):
    """Launch ``edge_relax_superstep_f32`` on the current stream, with a few
    persistent blocks on each of the ``n_sm`` SMs.  Inputs are float32,
    contiguous and on one CUDA device, and P <= MAX_P (checked by the
    caller)."""
    R, E, P = pv.shape
    minl = torch.empty((R, E, P), dtype=torch.float32, device=pv.device)
    argl = torch.empty((R, E, P), dtype=torch.int32, device=pv.device)
    stream = torch.cuda.current_stream(pv.device).cuda_stream
    err = lib.edge_relax_superstep_f32(
        pv.data_ptr(), pdata.data_ptr(), L.data_ptr(), bw.data_ptr(),
        minl.data_ptr(), argl.data_ptr(), R, E, P, n_sm, stream)
    if err != 0:
        raise RuntimeError(f"edge_relax_superstep kernel launch failed: CUDA error {err}")
    return minl, argl


def edge_relax_superstep_argtypes(lib: ctypes.CDLL) -> None:
    fn = lib.edge_relax_superstep_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
