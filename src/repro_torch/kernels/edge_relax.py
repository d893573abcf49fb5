"""Edge-centric CEFT relaxation: the inner contraction of the CSR sweep's
segment-layout levels.

    minl[b, e, j] = min_l pv[b, e, l] + (L[b, l] + pdata[e] / bw[b, l, j]) * [l != j]
    argl[b, e, j] = the first-index argmin class

Replaces the Pallas kernel ``src/repro/kernels/ceft_relax.py:_edge_relax_kernel``
(entry ``edge_relax_pallas``).  The CUDA source is ``csrc/edge_relax.cu``, with
two entries that compute the same arithmetic, rounding for rounding:

* ``edge_relax_f32`` keeps the Pallas kernel's (B, E, P) contract, for any
  width: a block takes a tile of edges and a chunk of the child classes j,
  stages the tile's pv rows and the chunk's machine entries in one round
  trip, up to 4 lanes share each (edge, j) cell's class loop and combine in l
  order, each lane storing its own cells; :func:`edge_relax_grid` picks the
  launch on the host.  The (E, P, P) candidate tensor that
  :func:`edge_relax_plain` materializes stays in registers.
* ``seg_level_f32`` runs a whole segment-layout level of the CSR sweep in one
  launch (:func:`seg_level_plain` is its plain version): it gathers the
  parent rows from the carry, relaxes them, takes each child's first-max
  over its segment of edges, adds ``comp`` and writes the level's carry
  rows.  A block takes a tile of edges and a chunk of the child classes j;
  up to 8 lanes share each (edge, j) cell's class loop and combine in l order;
  segments inside a tile finish in shared memory and segments that cross
  tiles combine through a packed 64-bit ``atomicMax`` (value, then first
  edge), decoded by the tile that arrives last.  :func:`seg_level_grid`
  picks the launch on the host so that a level covers the card.

On the H100 the arithmetic is bound by issue slots: E·P² candidates, each a
divide, two adds, a multiply by off and a NaN-aware compare (float32, no
tensor cores: this is a min/argmin scan, not a matrix product).  Both entries
divide by Markstein's correctly rounded form from a staged RN(1/bw) inside an
exponent window and by ``__fdiv_rn`` outside it.  At the sweep's shapes (a few
hundred real edges, P = 64) a level is small, which is why each call is one
launch spread over every SM.

The leading ``b`` axis is the batch of cost planes / machines of the batched
re-planning sweep; the edge tables are shared across it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

NEG = -3.4e38  # the masked-edge value (rounds to the reference's float32 NEG)

#: ``csrc/edge_relax.cu``'s seg_level: edges a thread relaxes for one class j
#: in a pass, the largest block, resident blocks an SM, the farthest a tile
#: boundary moves on to a segment start, and the most lanes sharing a cell
SEG_EPT, SEG_MAX_THREADS, SEG_BLOCKS_PER_SM, SEG_SNAP, SEG_MAX_LANES = 8, 256, 3, 16, 8
#: ``csrc/edge_relax.cu``'s edge_relax: edges a thread relaxes for one class j
#: in a pass, the largest block, resident blocks an SM, and the most lanes
#: sharing a cell (the lanes' combine leaves each ER_EPT / G edges)
ER_EPT, ER_MAX_THREADS, ER_BLOCKS_PER_SM, ER_MAX_LANES = 4, 256, 3, 4
#: shared memory a block may hold on the H100, an SM's, and what each
#: resident block also takes
SMEM_LIMIT, SMEM_SM, SMEM_RESERVED = 227 * 1024, 228 * 1024, 1024


class SegGrid(NamedTuple):
    """A ``seg_level_f32`` launch: ``lanes`` (G) lanes share each (edge, j)
    cell's class loop, a block takes ``jc`` classes j of a tile of ``te``
    edges (before its boundaries snap to segment starts) with ``threads``
    threads, and the grid is (tiles x j-chunks, B)."""
    lanes: int
    jc: int
    threads: int
    te: int
    n_tiles: int
    n_jc: int
    blocks: int
    smem: int


class EdgeGrid(NamedTuple):
    """An ``edge_relax_f32`` launch: ``lanes`` (G) lanes share each (edge, j)
    cell's class loop, a block takes ``jc`` classes j of a tile of ``te``
    edges of one plane with ``threads`` threads, and the grid is B x tiles x
    j-chunks blocks.  ``lanes == 0``: the machine is too wide for any staged
    launch, and one thread per output reads L and bw from global memory."""
    lanes: int
    jc: int
    threads: int
    te: int
    n_tiles: int
    n_jc: int
    blocks: int
    smem: int


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _lane_stride(G: int, lpt: int) -> int:
    """Staged machine entries between two classes j (``csrc/relax.cuh``,
    ``lane_stride``)."""
    return G * lpt + 1 if G >= 8 else G * lpt + ((G - G * lpt) & 7)


def seg_smem(P: int, G: int, jc: int, te: int, threads: int) -> int:
    """Shared memory of a ``seg_level_f32`` block (``csrc/edge_relax.cu``,
    ``SegSmem``): the j-chunk's staged machine entries, the snapped tile's
    parent rows (and a pass's worth past them), the edge tables' window, and
    the per-cell results."""
    cap = te + SEG_SNAP
    nwin, ep = cap + 1, threads // (G * jc) * SEG_EPT
    return (_align16(16 * jc * _lane_stride(G, -(-P // G))) + _align16(4 * (cap + ep) * P)
            + _align16(8 * nwin) + 2 * _align16(4 * nwin) + _align16(4 * cap)
            + 3 * _align16(4 * cap * jc))


def edge_smem(P: int, G: int, jc: int, te: int) -> int:
    """Shared memory of an ``edge_relax_f32`` block (``csrc/edge_relax.cu``,
    ``ErSmem``): the j-chunk's staged machine entries, the tile's pv rows
    (4 floats more, to keep their 16-byte phase) and its edge data."""
    return (_align16(16 * jc * _lane_stride(G, -(-P // G))) + _align16(4 * (te * P + 4))
            + _align16(4 * te))


def _smaller(threads: int, jc: int, G: int):
    """Half the block, and the j-chunk once a block is one group of G * jc
    threads; None at a warp."""
    if threads > max(32, G * jc):
        return threads // 2, jc
    if jc > 1 and threads > 32:
        return threads // 2, jc // 2
    return None


def _j_chunk(P: int) -> int:
    """A block's classes j: a power of two, at most 16 and P, and at most
    4096 staged machine entries where P allows."""
    return min(1 << (P - 1).bit_length(), 16, 1 << max(0, (4096 // P).bit_length() - 1))


@functools.lru_cache(maxsize=4096)
def edge_relax_grid(B: int, E: int, P: int, n_sm: int) -> EdgeGrid:
    """How ``edge_relax_f32`` covers B planes of E edges and P classes on a
    card with ``n_sm`` SMs (the rule was chosen by timing every launch shape
    on the H100 at phase a's shapes and around them, ``PERF.md``).

    G, the lanes that split a cell's class loop, is the least power of two
    that gives every SM a block of 128 threads (ER_EPT cells a thread), at
    most ER_MAX_LANES and at least 2 classes a lane: a lane more costs a
    combine round and shortens each thread's loop, so few lanes are best as
    long as the card has threads.  A j-chunk takes JC of the classes (16 at
    most, and at most 4096 staged entries where P allows); an edge group of
    G * JC threads takes ER_EPT edges a pass; a block of 256 threads halves,
    and then its j-chunk, while its shared memory does not fit, and a warp of
    several edge groups takes more lanes a cell (past that the machine is too
    wide to stage: ``lanes == 0``, P above 2048).  A tile takes as many
    passes as keep the grid within the blocks the card holds at once (as
    many as shared memory lets sit on an SM, at most ER_BLOCKS_PER_SM); a
    call that gives fewer than half the SMs a block halves its block and its
    j-chunk together (each thread still stages its machine entries in one
    round of loads), down to a warp."""
    most = min(ER_MAX_LANES, max(1, P // 2))
    G = 1
    while B * E * P * G < n_sm * 128 * ER_EPT and 2 * G <= most:
        G *= 2
    jc, threads = _j_chunk(P), ER_MAX_THREADS

    def ep(threads, jc):  # edges a pass
        return threads // (G * jc) * ER_EPT

    while edge_smem(P, G, jc, ep(threads, jc)) > SMEM_LIMIT:
        nxt = _smaller(threads, jc, G)
        if nxt is not None:
            threads, jc = nxt
        elif G * jc < 32 and 2 * G <= most:     # a warp of several edge groups:
            G *= 2                              # fewer, with more lanes each
        else:
            n = -(-B * E * P // ER_MAX_THREADS)
            return EdgeGrid(0, 0, ER_MAX_THREADS, 0, 0, 0, n, 0)

    def blocks(threads, jc, passes=1):
        return B * -(-E // (passes * ep(threads, jc))) * -(-P // jc)

    def held(te):  # blocks the card holds at once with tiles of te edges
        per_sm = SMEM_SM // (edge_smem(P, G, jc, te) + SMEM_RESERVED)
        return n_sm * min(ER_BLOCKS_PER_SM, per_sm)

    passes, e1 = 1, ep(threads, jc)
    while (blocks(threads, jc, passes) > held(passes * e1) and passes * e1 < E
           and edge_smem(P, G, jc, (passes + 1) * e1) <= SMEM_LIMIT):
        passes += 1
    while passes == 1 and 2 * blocks(threads, jc) < n_sm and threads > 32:
        if jc > 1 and G * (jc // 2) <= threads // 2:
            threads, jc = threads // 2, jc // 2
        elif threads // 2 >= G * jc:
            threads //= 2
        else:
            break
    te = passes * ep(threads, jc)
    n_tiles, n_jc = -(-E // te), -(-P // jc)
    return EdgeGrid(G, jc, threads, te, n_tiles, n_jc, B * n_tiles * n_jc,
                    edge_smem(P, G, jc, te))


@functools.lru_cache(maxsize=4096)
def seg_level_grid(B: int, e_real: int, P: int, n_sm: int) -> SegGrid:
    """How ``seg_level_f32`` covers a level of ``e_real`` real edges, B planes
    and P classes on a card with ``n_sm`` SMs.

    G, the lanes that split a cell's class loop, is the least power of two
    that gives the card (SEG_BLOCKS_PER_SM blocks of 256 threads an SM)
    enough threads, at most SEG_MAX_LANES and at least 2 classes a lane, so
    small levels spread and large ones spend few shuffles.  A j-chunk takes
    JC of the classes (16 at most, and at most 4096 staged entries); an edge
    group of G * JC threads takes SEG_EPT edges a pass; a block of 256
    threads halves, and then its j-chunk, while a pass's parent rows do not
    fit its shared memory.  A tile takes as many passes as keep the grid
    within the blocks the card holds at once (as many as shared memory lets
    sit on an SM, at most SEG_BLOCKS_PER_SM); a level too small to give every
    SM a block halves the block instead, and then the j-chunk, down to a
    warp."""
    want = SEG_BLOCKS_PER_SM * n_sm * SEG_MAX_THREADS * SEG_EPT / (B * e_real * P)
    G, most = 1, min(SEG_MAX_LANES, max(1, P // 2))
    while G < want and 2 * G <= most:
        G *= 2
    jc, threads = _j_chunk(P), SEG_MAX_THREADS

    def blocks(threads, jc, passes=1):
        return B * -(-e_real // (passes * threads // (G * jc) * SEG_EPT)) * -(-P // jc)

    while seg_smem(P, G, jc, threads // (G * jc) * SEG_EPT, threads) > SMEM_LIMIT:
        threads, jc = _smaller(threads, jc, G)
    ep = threads // (G * jc) * SEG_EPT

    def held(te):  # blocks the card holds at once with tiles of te edges
        per_sm = SMEM_SM // (seg_smem(P, G, jc, te, threads) + SMEM_RESERVED)
        return n_sm * min(SEG_BLOCKS_PER_SM, per_sm)

    passes = 1
    while (blocks(threads, jc, passes) > held(passes * ep) and passes * ep < e_real
           and seg_smem(P, G, jc, (passes + 1) * ep, threads) <= SMEM_LIMIT):
        passes += 1
    while passes == 1 and blocks(threads, jc) < n_sm and _smaller(threads, jc, G):
        threads, jc = _smaller(threads, jc, G)
    te = passes * threads // (G * jc) * SEG_EPT
    n_tiles, n_jc = -(-e_real // te), -(-P // jc)
    return SegGrid(G, jc, threads, te, n_tiles, n_jc, B * n_tiles * n_jc,
                   seg_smem(P, G, jc, te, threads))


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
                     edge_data, edge_seg, e_real: int, width: int, scratch, n_sm: int,
                     stream: int) -> SegGrid:
    """Launch ``seg_level_f32`` on ``stream`` with :func:`seg_level_grid`'s
    shape.  Inputs are contiguous and on one CUDA device (checked by the
    caller); ``scratch(n_keys, n_counts)`` returns zeroed int64 and int32
    buffers that the kernel leaves zero (the keys, then each crossing
    segment's arrival counters).  Returns the launch shape."""
    ceft_arr, ptask, pproc = carry
    B, V, P = ceft_arr.shape
    grid = seg_level_grid(B, e_real, P, n_sm)
    keys, _ = scratch(B * width * (P + grid.n_jc), 0)
    err = lib.seg_level_f32(
        ceft_arr.data_ptr(), ptask.data_ptr(), pproc.data_ptr(), comp_pad.data_ptr(),
        L.data_ptr(), bw.data_ptr(), tasks.data_ptr(), edge_src.data_ptr(),
        edge_data.data_ptr(), edge_seg.data_ptr(), keys,
        B, V, P, width, e_real, grid.lanes, grid.jc, grid.threads, grid.te, stream)
    if err != 0:
        raise RuntimeError(f"seg_level kernel launch failed: CUDA error {err}")
    return grid


def edge_relax_launch(lib: ctypes.CDLL, pv, pdata, L, bw, n_sm: int):
    """Launch ``edge_relax_f32`` on the current stream with
    :func:`edge_relax_grid`'s shape.  Inputs are float32, contiguous, not
    empty and on one CUDA device (checked by the caller)."""
    B, E, P = pv.shape
    grid = edge_relax_grid(B, E, P, n_sm)
    minl = torch.empty((B, E, P), dtype=torch.float32, device=pv.device)
    argl = torch.empty((B, E, P), dtype=torch.int32, device=pv.device)
    stream = torch.cuda.current_stream(pv.device).cuda_stream
    err = lib.edge_relax_f32(
        pv.data_ptr(), pdata.data_ptr(), L.data_ptr(), bw.data_ptr(),
        minl.data_ptr(), argl.data_ptr(), B, E, P, grid.lanes, grid.jc, grid.threads,
        grid.te, stream)
    if err != 0:
        raise RuntimeError(f"edge_relax kernel launch failed: CUDA error {err}")
    return minl, argl


def edge_relax_argtypes(lib: ctypes.CDLL) -> None:
    fn = lib.edge_relax_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.seg_level_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
