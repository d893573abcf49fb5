"""Dense CEFT level relaxation: the padded sweep's and the dense-layout runs'
inner contraction (paper Algorithm 1 lines 6-18, batched over a level's tasks).

    maxk[b, w, j] = max_{d valid} min_l pv[b, w, d, l] + (L[b, l] + pdata[w, d] / bw[b, l, j]) * [l != j]
    argk[b, w, j] = the first maximal parent slot; argl = that slot's argmin class

Rows with no valid parent give ``-BIG`` and indices ``-1``.  Replaces the Pallas
kernel ``src/repro/kernels/ceft_relax.py:_relax_kernel`` (entry
``ceft_relax_pallas``).  The CUDA kernel is ``csrc/ceft_relax.cu``.  It is bound
by its valid slots' D·P² correctly rounded divides, and its shapes range from
many narrow tasks (the router's DAGs) to one task with a wide fan-in (the
star's sink, W = 1, D = 4096), so it splits the fan-in D across the slot-lanes
of a block and, when B·W gives too few blocks to fill the card, across blocks
(:func:`ceft_relax_chunks`); partial maxima are combined by (value, first slot)
in shared memory and across blocks through a packed 64-bit ``atomicMax``.
It has a float32 and a bf16 instance, as the Pallas kernel takes either; the
bf16 one rounds after each operation, as :func:`ceft_relax_plain` does in
bf16, and is bit-equal to it.
"""
from __future__ import annotations

import ctypes

import torch

BIG = 3.0e38
#: threads of a block: P j-lanes times 256 // P slot-lanes (``csrc/ceft_relax.cu``)
BLOCK_THREADS = 256


def ceft_relax_plain(pv, pdata, validp, L, bw):
    """The plain PyTorch version: the CPU path and the on-card comparison.

    pv (B, W, D, P), pdata (W, D), validp (W, D) float mask, L (B, P),
    bw (B, P, P) -> (maxk (B, W, P), argk (B, W, P) int32, argl (B, W, P)
    int32).  Same operation order and tie rules as the reference oracle."""
    P = L.shape[-1]
    off = 1.0 - torch.eye(P, dtype=pv.dtype, device=pv.device)
    comm = (L[:, None, None, :, None]
            + pdata[None, :, :, None, None] / bw[:, None, None]) * off
    cand = pv[..., :, None] + comm                                 # (B,W,D,Pl,Pj)
    minl, argl = torch.min(cand, dim=3)                            # (B,W,D,Pj)
    valid = (validp > 0)[None, :, :, None]
    minl = torch.where(valid, minl, torch.full_like(minl, -BIG))
    maxk, argk = torch.max(minl, dim=2)                            # (B,W,Pj)
    argl_sel = torch.gather(argl, 2, argk[:, :, None, :])[:, :, 0, :]
    has = (validp > 0).any(dim=1)[None, :, None]
    argk = torch.where(has, argk, -1)
    argl_sel = torch.where(has, argl_sel, -1)
    return maxk, argk.to(torch.int32), argl_sel.to(torch.int32)


def ceft_relax_chunks(B: int, W: int, D: int, P: int, n_sm: int) -> tuple[int, int]:
    """How the kernel splits the fan-in: (slots per block, blocks per task).

    Enough blocks to give every SM two, but at least one slot per slot-lane
    of a block; a fan-in that fits one block takes one block, with no
    atomics."""
    lanes = max(1, BLOCK_THREADS // P)
    want = max(1, -(-2 * n_sm // max(1, B * W)))
    n_chunks = max(1, min(D // lanes, want))
    chunk = max(1, -(-D // n_chunks))
    return chunk, max(1, -(-D // chunk))


#: the kernel's entry for each input type
ENTRIES = {torch.float32: "ceft_relax_f32", torch.bfloat16: "ceft_relax_bf16"}


def ceft_relax_launch(lib: ctypes.CDLL, pv, pdata, validp, L, bw, scratch, n_sm: int,
                      stream: int):
    """Launch the entry for the inputs' type (:data:`ENTRIES`) on ``stream``.
    Inputs are all float32 or all bf16, contiguous and on one CUDA device
    (checked by the caller); ``scratch(n_keys, n_counts)`` returns zeroed
    int64 and int32 buffers that the kernel leaves zero.  maxk has the
    inputs' type."""
    B, W, D, P = pv.shape
    maxk = torch.empty((B, W, P), dtype=pv.dtype, device=pv.device)
    argk = torch.empty((B, W, P), dtype=torch.int32, device=pv.device)
    argl = torch.empty((B, W, P), dtype=torch.int32, device=pv.device)
    chunk, n_chunks = ceft_relax_chunks(B, W, D, P, n_sm)
    keys, counts = scratch(B * W * P, B * W) if n_chunks > 1 else (0, 0)
    err = getattr(lib, ENTRIES[pv.dtype])(
        pv.data_ptr(), pdata.data_ptr(), validp.data_ptr(), L.data_ptr(),
        bw.data_ptr(), maxk.data_ptr(), argk.data_ptr(), argl.data_ptr(),
        keys, counts, B, W, D, P, chunk, n_chunks, stream)
    if err != 0:
        raise RuntimeError(f"ceft_relax kernel launch failed: CUDA error {err}")
    return maxk, argk, argl


def ceft_relax_argtypes(lib: ctypes.CDLL) -> None:
    for entry in ENTRIES.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
