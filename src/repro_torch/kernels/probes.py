"""Seeded inputs that probe the kernels where they are easiest to get wrong,
and a NaN-aware equality to hold the results with.

* :func:`edge_specials`, :func:`cell_specials` — relaxation tables with NaN,
  ``inf`` and signed-zero entries (a NaN must win the minimum or maximum and
  the first NaN's index must be the arg, as in the reference);
* :func:`edge_ties` — tie-heavy edge tables, where a first-index argmin is
  easiest to get wrong;
* :func:`divide_probe` — stacked edge tables at P = 64 whose candidates
  expose ``pdata / bw`` for adversarial operand pairs (all-ones and
  power-of-two significands, zeros, subnormals, values near ``FLT_MAX``,
  quotients near overflow and underflow); :func:`seg_divide_level` lays
  the same pairs out as one segment-layout level;
* :func:`minplus_specials` — (min, +) operands with NaN, ``inf`` and -0.0;
* :func:`minplus_probe` — (min, +) operands whose sums fall on bf16 rounding
  ties, near the largest bf16 and ``BIG``, among subnormals and on ±0;
* :func:`equal_bits` — :func:`equal_nan` that also tells -0.0 from 0.0.

The CPU tests feed them to the JAX reference and the port's plain versions;
the card tests and ``chip_smoke.py`` feed them to the CUDA kernels.  Arrays
are numpy float32 from ``numpy.random.default_rng(seed)``.
"""
from __future__ import annotations

import numpy as np
import torch

#: the special-value modes of :func:`edge_specials` and :func:`cell_specials`
SPECIAL_MODES = ("nan_pv", "nan_bw", "inf", "neg_zero")
#: the operand-pair kinds of :func:`divide_probe`
DIVIDE_KINDS = ("random", "ones", "pow2", "outside")
#: the operand kinds of :func:`minplus_probe`
MINPLUS_KINDS = ("sums_k1", "sums_k2", "pool_k64")

NAN, INF = np.float32(np.nan), np.float32(np.inf)


def equal_nan(a, b) -> bool:
    """Tensors of one shape and type, NaN in the same places and equal
    (``torch.equal``) everywhere else."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.equal(na, nb) and torch.equal(torch.where(na, zero, a),
                                               torch.where(nb, zero, b))


def equal_bits(a, b) -> bool:
    """:func:`equal_nan`, and every entry that is not NaN the same bits
    (so -0.0 differs from 0.0)."""
    if not equal_nan(a, b) or not a.is_floating_point():
        return equal_nan(a, b)
    keep = ~torch.isnan(a)
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a[keep].view(view), b[keep].view(view))


def _bits(u) -> np.ndarray:
    return np.asarray(u, np.uint32).view(np.float32)


def _edge_base(lead, E: int, P: int, rng):
    return (rng.uniform(0, 100, (*lead, E, P)).astype(np.float32),
            rng.uniform(0, 10, (*lead, E)).astype(np.float32),
            rng.uniform(0, 2, (P,)).astype(np.float32),
            rng.uniform(0.5, 2, (P, P)).astype(np.float32))


def edge_specials(shape, mode: str, seed: int):
    """(pv, pdata, L, bw) for edge tables of ``shape`` = (*lead, E, P), E >= 4,
    with ``mode`` written into every leading slice:

    * ``nan_pv``: NaN parent values at classes 2 and 4 of edge 0 (two NaN
      candidates: the first must win) and at the last class of edge E // 2;
    * ``nan_bw``: a NaN link (bw[1, 0]: class 1 -> 0 is NaN for every edge)
      and a NaN data volume (edge 1: every candidate NaN);
    * ``inf``: +inf parent values (one class of edge 1, every class of edge
      3) and an +inf data volume (edge 2: +inf off the diagonal, inf * 0 =
      NaN on it);
    * ``neg_zero``: -0.0 parent rows and data volumes (edges 2 and 3) and
      -0.0 in L."""
    *lead, E, P = shape
    pv, pdata, L, bw = _edge_base(tuple(lead), E, P, np.random.default_rng(seed))
    if mode == "nan_pv":
        pv[..., 0, 2 % P] = NAN
        pv[..., 0, 4 % P] = NAN
        pv[..., E // 2, P - 1] = NAN
    elif mode == "nan_bw":
        bw[1 % P, 0] = NAN
        pdata[..., 1] = NAN
    elif mode == "inf":
        pv[..., 1, 1 % P] = INF
        pv[..., 3, :] = INF
        pdata[..., 2] = INF
    elif mode == "neg_zero":
        pv[..., 2:4, :] = -0.0
        pdata[..., 2:4] = -0.0
        L[0] = -0.0
    else:
        raise ValueError(f"edge_specials: unknown mode {mode!r}")
    return pv, pdata, L, bw


def cell_specials(shape, mode: str, seed: int):
    """(pv, pdata, validp, L, bw) for a dense level of ``shape`` = (W, D, P),
    D >= 4: the :func:`edge_specials` pattern on the parent slots of every
    task, those slots made valid, plus (``nan_pv``) a NaN parent row in an
    invalid slot, which must not leak into the maximum."""
    W, D, P = shape
    rng = np.random.default_rng(seed)
    pv, pdata, L, bw = edge_specials((W, D, P), mode, seed)
    validp = (rng.random((W, D)) < 0.8).astype(np.float32)
    validp[:, :4] = 1.0
    validp[:, D // 2] = 1.0
    if mode == "nan_pv":
        validp[:, D - 1] = 0.0
        pv[:, D - 1, :] = NAN
    return pv, pdata, validp, L, bw


def edge_ties(shape, mode: str, seed: int):
    """Tie-heavy (pv, pdata, L, bw) for ``shape`` = (*lead, E, P) on a
    homogeneous machine: ``ties`` draws small integers, so equal candidates
    are common; ``constant`` makes every parent class of every edge equal,
    so every candidate off the diagonal ties."""
    *lead, E, P = shape
    rng = np.random.default_rng(seed)
    if mode == "ties":
        pv = rng.integers(0, 4, (*lead, E, P)).astype(np.float32)
        pdata = rng.integers(0, 3, (*lead, E)).astype(np.float32)
    elif mode == "constant":
        pv = np.full((*lead, E, P), 2.0, np.float32)
        pdata = np.full((*lead, E), 1.0, np.float32)
    else:
        raise ValueError(f"edge_ties: unknown mode {mode!r}")
    return pv, pdata, np.full(P, 1.0, np.float32), np.full((P, P), 2.0, np.float32)


def _random_exp(rng, n: int, lo: int, hi: int, mant=None) -> np.ndarray:
    """Positive floats with unbiased exponents in [lo, hi] and random (or the
    given) significand bits."""
    e = rng.integers(127 + lo, 127 + hi + 1, n).astype(np.uint32)
    m = rng.integers(0, 1 << 23, n).astype(np.uint32) if mant is None else np.uint32(mant)
    return _bits((e << 23) | m)


def divide_probe(kind: str, R: int, seed: int, E: int = 1024, P: int = 64):
    """(pv, pdata, L, bw) of shape (R, E, P) whose relaxation exposes the
    quotient ``pdata[r, e] / bw[l*, j]`` for every j != l* = (r E + e) mod P
    as ``minl[r, e, j]``: pv is 0 at class l* and +inf elsewhere, and L is 0,
    so R E (P - 1) quotients reach the output (bw's diagonal is 1).

    ``pdata`` comes in runs of 32 edges (one kernel tile at P = 64) of one
    category: random normals within 2^±62, all-ones and power-of-two
    significands, +0 (the padding edges' value), the window's edge
    exponents, and outside it -0.0, subnormals, tiny and huge normals and
    values near FLT_MAX.  ``kind`` picks bw: random normals, all-ones or
    power-of-two significands within 2^±62, or (``outside``) subnormals,
    tiny normals and values near FLT_MAX, whose quotients overflow and
    underflow."""
    rng = np.random.default_rng(seed)
    n = R * E
    cats = [
        lambda k: _random_exp(rng, k, -62, 62),
        lambda k: _random_exp(rng, k, -62, 62, (1 << 23) - 1),
        lambda k: _random_exp(rng, k, -62, 62, 0),
        lambda k: np.zeros(k, np.float32),
        lambda k: _random_exp(rng, k, -62, -62),
        lambda k: _random_exp(rng, k, 62, 62),
        lambda k: _random_exp(rng, k, -8, 8),
        lambda k: np.full(k, -0.0, np.float32),
        lambda k: _bits(rng.integers(1, 1 << 23, k)),
        lambda k: _random_exp(rng, k, -126, -63),
        lambda k: _random_exp(rng, k, 63, 127),
        lambda k: _random_exp(rng, k, 127, 127, (1 << 23) - 1 - rng.integers(0, 64, k)),
    ]
    pdata = np.empty(n, np.float32)
    for i, s in enumerate(range(0, n, 32)):
        k = min(32, n - s)
        pdata[s:s + k] = cats[i % len(cats)](k)
    if kind == "random":
        bw = _random_exp(rng, P * P, -62, 62)
    elif kind == "ones":
        bw = _random_exp(rng, P * P, -62, 62, (1 << 23) - 1)
    elif kind == "pow2":
        bw = _random_exp(rng, P * P, -62, 62, 0)
    elif kind == "outside":
        pick = rng.integers(0, 3, P * P)
        bw = np.where(pick == 0, _bits(rng.integers(1, 1 << 23, P * P)),
                      np.where(pick == 1, _random_exp(rng, P * P, -126, -100),
                               _random_exp(rng, P * P, 100, 127)))
    else:
        raise ValueError(f"divide_probe: unknown kind {kind!r}")
    # a diagonal link of 1 keeps the diagonal candidate (q * 0) off inf * 0
    bw = bw.astype(np.float32).reshape(P, P)
    bw[np.arange(P), np.arange(P)] = 1.0
    star = np.arange(n) % P
    pv = np.full((n, P), INF, np.float32)
    pv[np.arange(n), star] = 0.0
    return pv.reshape(R, E, P), pdata.reshape(R, E), np.zeros(P, np.float32), bw


def seg_divide_level(kind: str, R: int, seed: int, E: int = 1024, P: int = 64):
    """:func:`divide_probe`'s tables as one segment-layout level of one plane:
    (carry, comp, L, bw, tasks, edge_src, edge_data, edge_seg, e_real, width)
    for ``ops.seg_level``.  Each of the n = R E edges is the only edge of
    its own child segment, its parent row is the probe's pv row and comp is
    0, so child e's ceft row is 0 + the probe's minl row: every quotient
    ``pdata / bw[l*, j]`` reaches the carry.  Rows 0 .. n - 1 are the
    parents, n .. 2n - 1 the children, row 2n is zero."""
    pv, pdata, L, bw = divide_probe(kind, R, seed, E, P)
    n = R * E
    ceft = np.zeros((1, 2 * n + 1, P), np.float32)
    ceft[0, :n] = pv.reshape(n, P)
    ids = np.arange(n, dtype=np.int64)
    carry = (ceft, np.full(ceft.shape, -1, np.int32), np.full(ceft.shape, -1, np.int32))
    return (carry, np.zeros(ceft.shape, np.float32), L[None], bw[None], n + ids, ids,
            pdata.reshape(n), ids.copy(), n, n)


def _bf16_pool(rng) -> np.ndarray:
    """float32 values that are exact bf16: ±0, subnormals, the smallest
    normal, values on each other's rounding ties (1, 1 + 2^-7, 2^-8,
    3 * 2^-9), the largest bf16 and its neighbours, bf16 values around
    BIG = 3.0e38, +inf and random normals."""
    top = np.float32(3.0e38).view(np.uint32) >> 16
    hi16 = np.concatenate([
        [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x807F, 0x0080, 0x8080],
        rng.integers(1, 0x80, 8), rng.integers(1, 0x80, 4) | 0x8000,
        [0x3F80, 0x3F81, 0x3B80, 0x3BC0, 0xBF80, 0x3C00, 0x3C40],
        [0x7F7F, 0x7F7E, 0x7F7D, 0x7F70, 0xFF7F, 0xFF7E],
        top + np.arange(-3, 4), [0x7F80],
        rng.integers(0x0080, 0x7F7F, 24), rng.integers(0x0080, 0x7F7F, 8) | 0x8000,
    ]).astype(np.uint32)
    return _bits(hi16 << 16)


def minplus_probe(kind: str, seed: int):
    """(a, b) float32 arrays, every entry an exact bf16 drawn from a pool of
    adversarial values: ``sums_k1`` (2048, 1, 2048) exposes every sum
    a[i] + b[j] as an output, ``sums_k2`` (1024, 2, 1024) the minimum of two
    such sums, ``pool_k64`` (512, 64, 512) a product over K = 64."""
    rng = np.random.default_rng(seed)
    pool = _bf16_pool(rng)
    shape = {"sums_k1": (2048, 1, 2048), "sums_k2": (1024, 2, 1024),
             "pool_k64": (512, 64, 512)}.get(kind)
    if shape is None:
        raise ValueError(f"minplus_probe: unknown kind {kind!r}")
    M, K, N = shape
    return pool[rng.integers(0, len(pool), (M, K))], pool[rng.integers(0, len(pool), (K, N))]


def minplus_specials(shape, seed: int):
    """(a, b) float32 of ``shape`` = (M, K, N), M >= 3, with a NaN in row 0
    of a (that row must read NaN), row 1 of a all +inf (it reads BIG), row 2
    of a -0.0, a NaN in the last row of b (column 1 must read NaN) and a
    -0.0 at b[0, 0]."""
    M, K, N = shape
    rng = np.random.default_rng(seed)
    a = rng.uniform(-5, 5, (M, K)).astype(np.float32)
    b = rng.uniform(-5, 5, (K, N)).astype(np.float32)
    a[0, K // 2] = NAN
    a[1] = INF
    a[2] = -0.0
    b[K - 1, 1 % N] = NAN
    b[0, 0] = -0.0
    return a, b
