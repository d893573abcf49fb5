"""Tropical (min-plus) matrix product.

    C[i, j] = min(BIG, min_k A[i, k] + B[k, j]),   BIG = 3.0e38

Replaces the Pallas kernel ``src/repro/kernels/minplus.py:_minplus_kernel``
(entry ``minplus_pallas``), which nothing in the reference calls; it is ported
at its entry point, ``ops.minplus``.  Like the Pallas kernel, the accumulator
starts at ``BIG``, not ``+inf``: an entry whose every sum overflows reads
3.0e38 here and in the reference kernel (the reference's oracle
``ref.minplus_ref`` has no BIG and reads ``inf`` there).  The CUDA kernel is
``csrc/minplus.cu``: 128 x 128 output tiles, an 8 x 8 register micro-tile per
thread read from shared memory with 16-byte loads, K slices of 16 double-
buffered (``cp.async`` for B, registers for A) and the ragged edge masked in
the kernel.  It is bound by issue slots: one add and one NaN-propagating min
per (i, k, j) in float32 (no tensor-core mode computes a (min, +) product,
and no library call does either), and half of that in bf16, whose adds and
minima run on packed pairs.

float32 and bf16 inputs: the plain version takes sums and minima in float32
and rounds the result to the input type once, which equals rounding every
sum (rounding is monotone, and a float32 sum of two bf16 values rounds to the
bf16 sum); the bf16 kernel adds and takes minima in bf16.  NaN propagates
through the minimum, as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

BIG = 3.0e38
#: elements of the (M, chunk, N) temporary the plain version may hold at once
PLAIN_CHUNK_ELEMS = 1 << 28


def minplus_plain(a, b):
    """The plain PyTorch version: the CPU path and the on-card comparison.

    a (M, K), b (K, N) -> (M, N) in a's type.  Walks K in chunks so that the
    (M, chunk, N) sums fit in memory at large shapes; the minimum is exact, so
    the chunking does not change a bit."""
    M, K = a.shape
    N = b.shape[1]
    af, bf = a.float(), b.float()
    out = torch.full((M, N), BIG, dtype=torch.float32, device=a.device)
    step = max(1, PLAIN_CHUNK_ELEMS // max(1, M * N))
    for k0 in range(0, K, step):
        k1 = min(K, k0 + step)
        part = torch.amin(af[:, k0:k1, None] + bf[None, k0:k1, :], dim=1)
        torch.minimum(out, part, out=out)
    return out.to(a.dtype)


def minplus_launch(lib: ctypes.CDLL, a, b):
    """Launch ``minplus_f32`` or ``minplus_bf16`` on the current stream.  Inputs
    share one type, are contiguous and on one CUDA device (checked by the
    caller)."""
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    fn = lib.minplus_f32 if a.dtype == torch.float32 else lib.minplus_bf16
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, K, N, stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    return c


def minplus_argtypes(lib: ctypes.CDLL) -> None:
    for fn in (lib.minplus_f32, lib.minplus_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
