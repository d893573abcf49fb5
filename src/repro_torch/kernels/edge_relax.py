"""Edge-centric CEFT relaxation: the inner contraction of the CSR sweep's
segment-layout levels.

    minl[b, e, j] = min_l pv[b, e, l] + (L[b, l] + pdata[e] / bw[b, l, j]) * [l != j]
    argl[b, e, j] = the first-index argmin class

Replaces the Pallas kernel ``src/repro/kernels/ceft_relax.py:_edge_relax_kernel``
(entry ``edge_relax_pallas``).  The CUDA source is ``csrc/edge_relax.cu``, with
two entries that share one device function for the arithmetic:

* ``edge_relax_f32`` keeps the Pallas kernel's (B, E, P) contract: one thread
  per output with L and bw staged in shared memory, so the (E, P, P)
  candidate tensor that :func:`edge_relax_plain` materializes stays in
  registers.
* ``seg_level_f32`` runs a whole segment-layout level of the CSR sweep in one
  launch (:func:`seg_level_plain` is its plain version): it gathers the
  parent rows from the carry, relaxes them, takes each child's first-max
  over its segment of edges, adds ``comp`` and writes the level's carry
  rows.  Edges are tiled; segments inside a tile finish in shared memory and
  segments that cross tiles combine through a packed 64-bit ``atomicMax``
  (value, then first edge).

On the H100 the arithmetic is bound by its E·P² correctly rounded divides
(float32, no tensor cores: this is a min/argmin scan, not a matrix product);
at the sweep's shapes (a few hundred real edges, P = 64) a level is so small
that launches and host work dominate, which is why the level is one launch.

The leading ``b`` axis is the batch of cost planes / machines of the batched
re-planning sweep; the edge tables are shared across it.
"""
from __future__ import annotations

import ctypes

import torch

NEG = -3.4e38  # the masked-edge value (rounds to the reference's float32 NEG)


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


def seg_level_plain(carry, comp_pad, L, bw, tasks, edge_src, edge_data, edge_seg,
                    e_real: int, width: int) -> None:
    """The plain PyTorch version of one segment-layout level, in place on
    ``carry`` = (ceft (B, V, P), pred_task, pred_proc int32).

    Per-edge relaxation of the parent rows ``edge_src`` (E_b,), then the
    per-child max over its contiguous parent segment (``edge_seg``, child
    slot of each edge) with a first-max tie-break in edge order (== ascending
    parent id, matching the dense argmax); only the first ``e_real`` edges
    count.  A NaN wins the max and the first NaN edge is the argmax (the
    reference's multi-segment form, ``core/ceft_jax.py:_superstep_impl``,
    finds no edge equal to a NaN maximum and points at edge ``E_b - 1``;
    ROADMAP Queue 3).  Child slot ``s < len(tasks)`` writes carry row ``tasks[s]``:
    ``comp + max``, the winning edge's parent and its argmin class."""
    ceft_arr, ptask, pproc = carry
    B, _, P = ceft_arr.shape
    E_b, W_b, e = edge_src.shape[0], width, e_real
    pv = ceft_arr.index_select(1, edge_src)                        # (B,E,P)
    minl, argl = edge_relax_plain(pv, edge_data, L, bw)
    masked = e < E_b
    if masked:
        minl[:, e:] = NEG
    if W_b == 1:
        # single segment: the segmented reduction collapses to max/argmax,
        # whose first-max tie-break equals first-max-in-edge-order
        maxk, arg_edge = torch.max(minl, dim=1, keepdim=True)      # (B,1,P)
    else:
        seg = edge_seg.view(1, E_b, 1).expand(B, E_b, P)
        maxk = torch.full((B, W_b, P), -float("inf"), dtype=minl.dtype,
                          device=minl.device)
        maxk.scatter_reduce_(1, seg, minl, "amax")
        # a NaN propagates through amax; the first NaN edge of the segment is
        # its argmax, as in the single-segment branch and the dense argmax
        seg_max = torch.gather(maxk, 1, seg)
        hit = (minl == seg_max) | (minl.isnan() & seg_max.isnan())
        if masked:
            hit[:, e:] = False
        edge_ids = torch.arange(E_b, dtype=torch.int64, device=minl.device)
        is_first = torch.where(hit, edge_ids.view(1, E_b, 1), E_b)
        arg_edge = torch.full((B, W_b, P), E_b, dtype=torch.int64, device=minl.device)
        arg_edge.scatter_reduce_(1, seg, is_first, "amin")
        arg_edge.clamp_max_(E_b - 1)                               # (B,W,P)
    w = tasks.shape[0]
    maxk, arg_edge = maxk[:, :w], arg_edge[:, :w]
    ceft_arr.index_copy_(1, tasks, comp_pad.index_select(1, tasks) + maxk)
    ptask.index_copy_(1, tasks, edge_src[arg_edge].to(torch.int32))
    pproc.index_copy_(1, tasks, torch.gather(argl, 1, arg_edge))


def seg_level_launch(lib: ctypes.CDLL, carry, comp_pad, L, bw, tasks, edge_src,
                     edge_data, edge_seg, e_real: int, width: int, scratch,
                     stream: int) -> None:
    """Launch ``seg_level_f32`` on ``stream``.  Inputs are contiguous and on
    one CUDA device (checked by the caller); ``scratch(n_keys, n_counts)``
    returns zeroed int64 and int32 buffers that the kernel leaves zero."""
    ceft_arr, ptask, pproc = carry
    B, V, P = ceft_arr.shape
    keys, counts = scratch(B * width * P, B)
    err = lib.seg_level_f32(
        ceft_arr.data_ptr(), ptask.data_ptr(), pproc.data_ptr(), comp_pad.data_ptr(),
        L.data_ptr(), bw.data_ptr(), tasks.data_ptr(), edge_src.data_ptr(),
        edge_data.data_ptr(), edge_seg.data_ptr(), keys, counts,
        B, V, P, width, e_real, stream)
    if err != 0:
        raise RuntimeError(f"seg_level kernel launch failed: CUDA error {err}")


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
    fn = lib.seg_level_f32
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
