"""Edge-centric CEFT relaxation: the inner contraction of the CSR sweep's
segment-layout levels.

    minl[b, e, j] = min_l pv[b, e, l] + (L[b, l] + pdata[e] / bw[b, l, j]) * [l != j]
    argl[b, e, j] = the first-index argmin class

Replaces the Pallas kernel ``src/repro/kernels/ceft_relax.py:_edge_relax_kernel``
(entry ``edge_relax_pallas``).  The CUDA kernel is ``csrc/edge_relax.cu``: one
thread per (b, e, j) output with L and bw staged in shared memory, so the
(E, P, P) candidate tensor that :func:`edge_relax_plain` materializes stays
in registers.  On the H100 the work is bound by its E·P² correctly rounded
divides (float32, no tensor cores: this is a min/argmin scan, not a matrix
product); at the sweep's shapes (E ≤ 2048, P = 64) a call is so small that
launch latency dominates, which is why the sweep's levels are the thing to
fuse next, not this kernel's inner loop.

The leading ``b`` axis is the batch of cost planes / machines of the batched
re-planning sweep; ``pdata`` (the graph's edge data) is shared across it.
"""
from __future__ import annotations

import ctypes

import torch


def edge_relax_plain(pv, pdata, L, bw):
    """The plain PyTorch version: the CPU path and the on-card comparison.

    pv (B, E, P), pdata (E,), L (B, P), bw (B, P, P) ->
    (minl (B, E, P), argl (B, E, P) int32).  Same operation order as the
    reference oracle, so float32 results are bit-equal to it."""
    P = L.shape[-1]
    off = 1.0 - torch.eye(P, dtype=pv.dtype, device=pv.device)
    comm = (L[:, None, :, None] + pdata[None, :, None, None] / bw[:, None]) * off
    cand = pv[..., :, None] + comm                                 # (B,E,Pl,Pj)
    minl, argl = torch.min(cand, dim=2)
    return minl, argl.to(torch.int32)


def edge_relax_launch(lib: ctypes.CDLL, pv, pdata, L, bw):
    """Launch ``edge_relax_f32`` on the current stream.  Inputs are float32,
    contiguous and on one CUDA device (checked by the caller)."""
    B, E, P = pv.shape
    minl = torch.empty((B, E, P), dtype=torch.float32, device=pv.device)
    argl = torch.empty((B, E, P), dtype=torch.int32, device=pv.device)
    stream = torch.cuda.current_stream(pv.device).cuda_stream
    err = lib.edge_relax_f32(
        pv.data_ptr(), pdata.data_ptr(), L.data_ptr(), bw.data_ptr(),
        minl.data_ptr(), argl.data_ptr(), B, E, P, stream)
    if err != 0:
        raise RuntimeError(f"edge_relax kernel launch failed: CUDA error {err}")
    return minl, argl


def edge_relax_argtypes(lib: ctypes.CDLL) -> None:
    fn = lib.edge_relax_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
