"""The port's relaxation oracles and plain kernel versions against the
reference package's JAX oracles (and its Pallas kernels in interpret mode).

Tolerance: float32 results are bit-equal (same operation order, same tie
rules); the bf16 dense relaxation is held at rtol=1e-2 as in the reference's
own ``test_ceft_relax_bf16``, and the bf16 min-plus product at the
reference's rtol=1e-5, compared in float32.  Tests marked ``cuda`` compare the CUDA kernels
with their plain versions on a card; they live in ``test_torch_cuda.py``,
which imports no JAX, so that they also run where JAX is not installed."""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ceft_relax as jax_ceft_relax  # noqa: E402
from repro.kernels import edge_relax as jax_edge_relax  # noqa: E402
from repro.kernels import edge_relax_superstep as jax_edge_relax_superstep  # noqa: E402
from repro.kernels import minplus as jax_minplus  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.core.ceft_jax import xla_relax  # noqa: E402
from repro_torch.kernels import ops, probes, ref  # noqa: E402
from repro_torch.kernels.ceft_relax import (BIG as CELL_BIG, ceft_relax_chunks,  # noqa: E402
                                            ceft_relax_plain)
from repro_torch.kernels.edge_relax import (ER_BLOCKS_PER_SM, ER_EPT,  # noqa: E402
                                            ER_MAX_LANES, ER_MAX_THREADS, SEG_BLOCKS_PER_SM,
                                            SEG_EPT, SEG_MAX_LANES, SMEM_LIMIT, SMEM_RESERVED,
                                            SMEM_SM, edge_relax_grid, edge_relax_plain,
                                            edge_smem, seg_level_grid, seg_level_plain,
                                            seg_smem)
from repro_torch.kernels.edge_relax_superstep import edge_relax_superstep_plain  # noqa: E402
from repro_torch.kernels.minplus import BIG, minplus_plain  # noqa: E402
from test_kernels import CELL_SHAPES, EDGE_SHAPES, SHAPES_MINPLUS, SUPERSTEP_SHAPES  # noqa: E402
from test_torch_cuda import (CELL_TIE_CASES, SEG_CASES, _cell_inputs,  # noqa: E402
                             _cell_tie_inputs, _edge_inputs, _minplus_inputs, _seg_inputs)


def _eq(got, want, name=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", EDGE_SHAPES + [(9, 241), (5, 300)])
def test_edge_relax_matches_jax(shape, ties):
    pv, pdata, L, bw = _edge_inputs(shape, ties)
    want = jref.edge_relax_ref(*map(jnp.asarray, (pv, pdata, L, bw)))
    t = [torch.as_tensor(a) for a in (pv, pdata, L, bw)]
    got_ref = ref.edge_relax_ref(*t)
    got_ops = ops.edge_relax(*t)
    got_plain = edge_relax_plain(t[0][None], t[1], t[2][None], t[3][None])
    for i, name in enumerate(["minl", "argl"]):
        _eq(got_ref[i], want[i], name)
        _eq(got_ops[i], want[i], name)
        _eq(got_plain[i][0], want[i], name)
    assert got_ops[1].dtype == torch.int32


@pytest.mark.parametrize("shape", [(5, 3), (300, 7)])
def test_edge_relax_matches_pallas_interpret(shape):
    pv, pdata, L, bw = _edge_inputs(shape, ties=True)
    want = jax_edge_relax(*map(jnp.asarray, (pv, pdata, L, bw)), interpret=True)
    got = ops.edge_relax(*(torch.as_tensor(a) for a in (pv, pdata, L, bw)))
    for g, w, name in zip(got, want, ["minl", "argl"]):
        _eq(g, w, name)


def test_edge_relax_batched_matches_per_plane():
    """The batched form (per-plane L and bw, shared edge data) equals the
    single form plane by plane."""
    rng = np.random.default_rng(12)
    B, E, P = 3, 40, 5
    pv = torch.as_tensor(rng.uniform(0, 100, (B, E, P)).astype(np.float32))
    pdata = torch.as_tensor(rng.uniform(0, 10, E).astype(np.float32))
    L = torch.as_tensor(rng.uniform(0, 2, (B, P)).astype(np.float32))
    bw = torch.as_tensor(rng.uniform(0.5, 2, (B, P, P)).astype(np.float32))
    minl, argl = ops.edge_relax(pv, pdata, L, bw)
    for b in range(B):
        m1, a1 = ops.edge_relax(pv[b], pdata, L[b], bw[b])
        _eq(minl[b], m1)
        _eq(argl[b], a1)
    with pytest.raises(ValueError):
        ops.edge_relax(pv, pdata[:-1], L, bw)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_ceft_relax_matches_jax(shape, ties):
    args = _cell_inputs(shape, ties)
    want = jref.ceft_relax_ref(*map(jnp.asarray, args))
    t = [torch.as_tensor(a) for a in args]
    got_ref = ref.ceft_relax_ref(*t)
    got_ops = ops.ceft_relax(*t)
    got_plain = ceft_relax_plain(t[0][None], t[1], t[2], t[3][None], t[4][None])
    for i, name in enumerate(["maxk", "argk", "argl"]):
        _eq(got_ref[i], want[i], name)
        _eq(got_ops[i], want[i], name)
        _eq(got_plain[i][0], want[i], name)


@pytest.mark.parametrize("shape", [(8, 3, 4), (16, 7, 13)])
def test_ceft_relax_matches_pallas_interpret(shape):
    args = _cell_inputs(shape, ties=True)
    want = jax_ceft_relax(*map(jnp.asarray, args), interpret=True)
    got = ops.ceft_relax(*(torch.as_tensor(a) for a in args))
    for g, w, name in zip(got, want, ["maxk", "argk", "argl"]):
        _eq(g, w, name)


@pytest.mark.parametrize("shape", [(8, 3, 4), (16, 7, 13)])
def test_ceft_relax_bf16(shape):
    """bf16 plain path against the bf16 JAX oracle, rtol=1e-2 (as the
    reference holds its bf16 kernel)."""
    args = _cell_inputs(shape, ties=False)
    want = jref.ceft_relax_ref(*(jnp.asarray(a, jnp.bfloat16) for a in args))
    got = ops.ceft_relax(*(torch.as_tensor(a).to(torch.bfloat16) for a in args))
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), rtol=1e-2)


@pytest.mark.parametrize("shape", SUPERSTEP_SHAPES)
def test_edge_relax_superstep_ref_matches_jax(shape):
    pv, pdata, L, bw = _edge_inputs(shape, ties=False)
    want = jref.edge_relax_superstep_ref(*map(jnp.asarray, (pv, pdata, L, bw)))
    got = ref.edge_relax_superstep_ref(*(torch.as_tensor(a) for a in (pv, pdata, L, bw)))
    for g, w, name in zip(got, want, ["minl", "argl"]):
        _eq(g, w, name)


@pytest.mark.parametrize("shape", SHAPES_MINPLUS)
def test_minplus_ref_matches_jax(shape):
    m, k, n = shape
    rng = np.random.default_rng(hash(shape) % 2**31)
    a = rng.uniform(-5, 5, (m, k)).astype(np.float32)
    b = rng.uniform(-5, 5, (k, n)).astype(np.float32)
    _eq(ref.minplus_ref(torch.as_tensor(a), torch.as_tensor(b)),
        jref.minplus_ref(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("shape", SUPERSTEP_SHAPES)
def test_edge_relax_superstep_matches_pallas_interpret(shape):
    """The port's wrapper (the plain version, on the CPU) against the
    reference's Pallas kernel in interpret mode, bit-equal."""
    args = _edge_inputs(shape, ties=False)
    want = jax_edge_relax_superstep(*map(jnp.asarray, args), interpret=True)
    got = ops.edge_relax_superstep(*(torch.as_tensor(a) for a in args))
    for g, w, name in zip(got, want, ["minl", "argl"]):
        _eq(g, w, name)
    assert got[1].dtype == torch.int32


def test_edge_relax_superstep_consistent_with_per_level():
    """Each stacked slice equals ``edge_relax`` on that level (the
    reference's consistency case, with ties)."""
    pv, pdata, L, bw = (torch.as_tensor(a) for a in _edge_inputs((4, 96, 5), ties=True))
    minl, argl = ops.edge_relax_superstep(pv, pdata, L, bw)
    for r in range(pv.shape[0]):
        m1, a1 = ops.edge_relax(pv[r], pdata[r], L, bw)
        _eq(minl[r], m1)
        _eq(argl[r], a1)
    with pytest.raises(ValueError):
        ops.edge_relax_superstep(pv, pdata[:, :-1], L, bw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES_MINPLUS)
def test_minplus_matches_pallas_interpret(shape, dtype):
    a, b = _minplus_inputs(shape)
    want = np.asarray(jax_minplus(jnp.asarray(a, dtype), jnp.asarray(b, dtype)),
                      np.float32)
    tdt = getattr(torch, dtype)
    got = ops.minplus(torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt))
    assert got.dtype == tdt and got.shape == want.shape
    if dtype == "float32":
        _eq(got, want)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_minplus_all_overflow_row_reads_big(dtype):
    """An entry whose every sum overflows reads BIG, as the reference kernel's
    accumulator does (its oracle, with no BIG, reads inf there)."""
    a = np.full((3, 5), 1.0, np.float32)
    a[1] = 3.0e38
    b = np.full((5, 4), 3.0e38, np.float32)
    b[:, 2] = 1.0
    want = np.asarray(jax_minplus(jnp.asarray(a, dtype), jnp.asarray(b, dtype)),
                      np.float32)
    tdt = getattr(torch, dtype)
    got = ops.minplus(torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt))
    _eq(got.float(), want)
    assert float(got[1, 0]) == float(torch.tensor(BIG, dtype=tdt))
    assert np.isinf(np.asarray(jref.minplus_ref(jnp.asarray(a), jnp.asarray(b)))[1, 0])


@pytest.mark.parametrize("n", [1, 7, 19])
def test_minplus_semiring_identity(n):
    """The reference test's ``eye`` (0 on the diagonal, 3.0e38 off it) is
    the identity of the product on both sides, as in the reference."""
    a = np.random.default_rng(n).uniform(-5, 5, (n, n)).astype(np.float32)
    eye = np.where(np.eye(n, dtype=bool), 0.0, 3.0e38).astype(np.float32)
    ta, te = torch.as_tensor(a), torch.as_tensor(eye)
    _eq(ops.minplus(ta, te), a)
    _eq(ops.minplus(te, ta), a)
    _eq(ops.minplus(ta, te), jax_minplus(jnp.asarray(a), jnp.asarray(eye)))


def test_minplus_plain_chunks_k_without_changing_a_bit(monkeypatch):
    """The plain version walks K in chunks so that it fits in memory at large
    shapes; the chunking changes no bit of the result."""
    mp = importlib.import_module("repro_torch.kernels.minplus")
    a, b = (torch.as_tensor(x) for x in _minplus_inputs((33, 70, 29)))
    whole = minplus_plain(a, b)
    monkeypatch.setattr(mp, "PLAIN_CHUNK_ELEMS", 33 * 29 * 3)
    _eq(minplus_plain(a, b), whole)


def test_card_test_shapes_are_the_reference_test_shapes():
    """``test_torch_cuda`` keeps its own copy of the reference's test shapes
    (it imports no JAX); the copies must not drift."""
    import test_torch_cuda as tc

    assert (tc.EDGE_SHAPES, tc.CELL_SHAPES, tc.SUPERSTEP_SHAPES, tc.SHAPES_MINPLUS) == \
        (EDGE_SHAPES, CELL_SHAPES, SUPERSTEP_SHAPES, SHAPES_MINPLUS)


@pytest.mark.parametrize("mode", ["ties", "constant", "invalid_rows"])
@pytest.mark.parametrize("shape", [(1, 70, 8), (4, 33, 5), (3, 9, 16)])
def test_ceft_relax_tie_modes_match_jax(shape, mode):
    """The card tests' tie-heavy inputs (every slot tied, rows without a valid
    parent) through the port's wrapper against the JAX oracle, bit-equal;
    parent-less rows read (-BIG, -1, -1)."""
    args = _cell_tie_inputs(shape, mode)
    want = jref.ceft_relax_ref(*map(jnp.asarray, args))
    got = ops.ceft_relax(*(torch.as_tensor(a) for a in args))
    for g, w, name in zip(got, want, ["maxk", "argk", "argl"]):
        _eq(g, w, name)
    if mode == "invalid_rows":
        assert (got[0][::3] == np.float32(-CELL_BIG)).all() and (got[1][::3] == -1).all()
    if mode == "constant":
        first = np.argmax(args[2] > 0, axis=1)
        _eq(got[1], np.broadcast_to(first[:, None], got[1].shape), "first tied slot")


@pytest.mark.parametrize("shape,mode", CELL_TIE_CASES)
def test_ceft_relax_card_split(shape, mode):
    """How the card kernel splits the fan-in at the card tests' shapes (132
    SMs): the chunks cover D exactly once, every slot-lane has a slot, a
    wide fan-in with one task spans many blocks, and a wide level does not
    split."""
    W, D, P = shape
    chunk, n = ceft_relax_chunks(1, W, D, P, 132)
    assert (n - 1) * chunk < D <= n * chunk
    assert n == 1 or chunk >= min(D, max(1, 256 // P))
    if W == 1 and D >= 1000:
        assert n >= 64
    # tasks enough to give every SM two blocks: one block per task, no atomics
    assert ceft_relax_chunks(1, 264, D, P, 132) == (D, 1)


@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_level_plain_matches_dense_relax(case, ties):
    """The fused level's plain version (the wrapper on the CPU) against an
    independent formulation: each child's segment laid out as dense parent
    slots in edge order and relaxed by the dense plain version (first
    maximal slot == first maximal edge).  Bit-equal, rows outside the
    level untouched."""
    _check_seg_level_against_dense(*_seg_inputs(case, ties))


def _check_seg_level_against_dense(carry, comp, L, bw, tasks, src, data, seg, e_real, width):
    t = [torch.as_tensor(a) for a in (comp, L, bw, tasks, src, data, seg)]
    got = tuple(torch.as_tensor(c.copy()) for c in carry)
    ops.seg_level(got, *t, e_real, width)
    w = len(tasks)
    lens = np.bincount(seg[:e_real], minlength=w)
    D = int(lens.max())
    par = np.full((w, D), carry[0].shape[1] - 1, np.int64)
    pdat = np.zeros((w, D), np.float32)
    valid = np.zeros((w, D), np.float32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for c in range(w):
        par[c, :lens[c]] = src[starts[c]:starts[c] + lens[c]]
        pdat[c, :lens[c]] = data[starts[c]:starts[c] + lens[c]]
        valid[c, :lens[c]] = 1.0
    ceft = torch.as_tensor(carry[0])
    pv = ceft[:, torch.as_tensor(par).reshape(-1)].view(ceft.shape[0], w, D, -1)
    maxk, argk, argl = ceft_relax_plain(pv, torch.as_tensor(pdat), torch.as_tensor(valid),
                                        t[1], t[2])
    rows = t[3]
    _eq(got[0][:, rows], torch.as_tensor(comp)[:, rows] + maxk, "ceft")
    _eq(got[1][:, rows], torch.as_tensor(par)[torch.arange(w)[:, None], argk.long()], "pred_task")
    _eq(got[2][:, rows], argl, "pred_proc")
    others = np.setdiff1d(np.arange(carry[0].shape[1]), tasks)
    for g, c in zip(got, carry):
        _eq(g[:, others], c[:, others])


@pytest.mark.parametrize("B,e_real", [(1, 385), (1, 1005), (1, 1611), (8, 1005)])
def test_seg_level_grid_covers_the_card(B, e_real):
    """The fused level's launch at the n = 16384 graph's level sizes (P = 64,
    132 SMs): the mean level and the widest put a block on every SM and no
    more than the card holds at once, the tiles cover the real edges exactly
    once in whole passes; single levels split each cell's class loop over 8
    lanes, the batch of 8 over fewer."""
    grid = seg_level_grid(B, e_real, 64, 132)
    assert grid.lanes == (8 if B == 1 else 2)
    assert (grid.n_tiles - 1) * grid.te < e_real <= grid.n_tiles * grid.te
    assert grid.te % (grid.threads // (grid.lanes * grid.jc) * SEG_EPT) == 0
    per_sm = min(SEG_BLOCKS_PER_SM, SMEM_SM // (grid.smem + SMEM_RESERVED))
    assert 132 <= grid.blocks == B * grid.n_tiles * grid.n_jc <= per_sm * 132
    assert grid.smem == seg_smem(64, grid.lanes, grid.jc, grid.te, grid.threads)


def test_seg_level_grid_takes_every_width():
    """Every P up to the packed keys' 256, level sizes from one edge up, 1 and
    8 planes, SM counts from 1 to 132: a launch shape the kernel accepts (a
    power of two of lanes, at most P and 8, an even number of classes each
    for P = 8, 16, 32, 64; whole edge groups of lanes x classes in a block;
    j-chunks covering P; whole warps, at most 256 threads; whole passes),
    tiles covering e_real once, shared memory within a block's 227 KB; a
    level too small for the card halves its block only while that adds
    blocks."""
    for P in range(1, ops.MAX_KEY_P + 1):
        for B, e_real, n_sm in ((1, 1, 132), (1, 7, 132), (1, 385, 132), (8, 1611, 132),
                                (1, 5000, 1)):
            g = seg_level_grid(B, e_real, P, n_sm)
            grp = g.lanes * g.jc
            assert g.lanes & (g.lanes - 1) == 0 and g.lanes <= min(P, SEG_MAX_LANES)
            if P in (8, 16, 32, 64):
                assert (P // g.lanes) % 2 == 0
            assert grp & (grp - 1) == 0 and g.threads % grp == 0
            assert (g.n_jc - 1) * g.jc < P <= g.n_jc * g.jc
            assert g.threads % 32 == 0 and g.threads <= 256
            assert g.te % (g.threads // grp * SEG_EPT) == 0
            assert (g.n_tiles - 1) * g.te < e_real <= g.n_tiles * g.te
            assert g.smem <= SMEM_LIMIT
            if g.threads < 256 and g.te == g.threads // grp * SEG_EPT:
                # a block twice as large gives too few blocks or too much memory
                assert (B * -(-e_real // (2 * g.te)) * g.n_jc < n_sm
                        or seg_smem(P, g.lanes, g.jc, 2 * g.te, 2 * g.threads) > SMEM_LIMIT)


def test_edge_relax_grid_matches_the_kernel_source():
    """The host's copies of ``csrc/edge_relax.cu``'s edge_relax constants."""
    src = (Path(ops.CSRC) / "edge_relax.cu").read_text()
    for name, value in (("ER_MAX_THREADS", ER_MAX_THREADS), ("ER_BLOCKS_PER_SM", ER_BLOCKS_PER_SM),
                        ("ER_EPT", ER_EPT)):
        assert int(re.search(rf"#define {name} (\d+)", src).group(1)) == value, name
    assert re.search(r"#define ER_MAX_LANES ER_EPT", src) and ER_MAX_LANES == ER_EPT


@pytest.mark.parametrize("B,E,P,G", [(1, 1024, 64, 2), (1, 2048, 64, 1), (8, 1024, 64, 1)])
def test_edge_relax_grid_covers_the_card(B, E, P, G):
    """``edge_relax_f32`` at its timed shapes (132 SMs): the fewest lanes that
    give every SM a 128-thread block's worth of threads, 256-thread blocks,
    no more blocks than the card holds at once, tiles covering the edges
    once in whole passes, and the cells spread so evenly that the busiest
    SM holds at most 4 % more than an even split (at (1, 1024, 64): 128
    blocks of 512 cells on 132 SMs, where an even split is 496)."""
    grid = edge_relax_grid(B, E, P, 132)
    assert grid.lanes == G and grid.threads == ER_MAX_THREADS
    assert (grid.n_tiles - 1) * grid.te < E <= grid.n_tiles * grid.te
    assert grid.te % (grid.threads // (grid.lanes * grid.jc) * ER_EPT) == 0
    per_sm = min(ER_BLOCKS_PER_SM, SMEM_SM // (grid.smem + SMEM_RESERVED))
    assert grid.blocks == B * grid.n_tiles * grid.n_jc <= per_sm * 132
    assert -(-grid.blocks // 132) * grid.te * grid.jc <= 1.04 * B * E * P / 132
    assert grid.smem == edge_smem(P, grid.lanes, grid.jc, grid.te)


def _edge_relax_stores(B, E, P, g):
    """How often ``edge_relax_kernel`` (``csrc/edge_relax.cu``) stores each
    (b, e, j) output under launch ``g``: the block and thread index
    arithmetic of the source, each pass, and the lanes' reduce-scatter that
    leaves lane gl with edges k0 .. k0 + ER_EPT / G - 1 of its thread's
    ER_EPT."""
    count = np.zeros(B * E * P, np.int64)
    if g.lanes == 0:          # one thread per output
        idx = np.arange(g.blocks * g.threads)
        np.add.at(count, idx[idx < B * E * P], 1)
        return count.reshape(B, E, P)
    G, JC, t = g.lanes, g.jc, np.arange(g.threads)
    gl, cj, grp = t & (G - 1), (t // G) & (JC - 1), t // (G * JC)
    k0 = np.zeros_like(t)
    for r in range(ER_EPT.bit_length() - 1):
        o, h = 1 << r, ER_EPT >> (r + 1)
        if o >= G:
            break
        k0 += np.where(gl & o, h, 0)
    blk = np.arange(g.blocks)
    jc, bt = blk % g.n_jc, blk // g.n_jc
    b, e0 = bt // g.n_tiles, bt % g.n_tiles * g.te
    ne, j0 = np.minimum(g.te, E - e0), jc * JC
    nj = np.minimum(JC, P - j0)
    ep = g.threads // (G * JC) * ER_EPT
    for p0 in range(0, g.te, ep):
        for i in range(ER_EPT // G):
            r = p0 + grp[None, :] * ER_EPT + k0[None, :] + i               # (blocks, threads)
            ok = (p0 < ne[:, None]) & (r < ne[:, None]) & (cj[None, :] < nj[:, None])
            out = ((b[:, None] * E + e0[:, None] + r) * P + j0[:, None] + cj[None, :])
            np.add.at(count, out[ok], 1)
    return count.reshape(B, E, P)


def test_edge_relax_grid_takes_every_width():
    """Every P from 1 to 300 (past the 240 at which the kernel once raised),
    1, 2 and 8 planes, edge counts from one up, SM counts of 132 and 1: a
    launch shape the kernel accepts (a power of two of lanes, at most P,
    ER_MAX_LANES and ER_EPT, an even number of classes each for P = 8, 16,
    32, 64; whole edge groups of lanes x classes in a block; whole warps, at
    most 256 threads; whole passes), shared memory within a block's 227 KB,
    and every (b, e, j) output stored by exactly one thread of one block."""
    for P in range(1, 301):
        for B, E, n_sm in ((1, 1, 132), (2, 13, 132), (8, 100, 132), (1, 37, 1)):
            g = edge_relax_grid(B, E, P, n_sm)
            assert g.lanes > 0 and g.smem <= SMEM_LIMIT
            grp = g.lanes * g.jc
            assert g.lanes & (g.lanes - 1) == 0 and g.lanes <= min(P, ER_MAX_LANES, ER_EPT)
            if P in (8, 16, 32, 64):
                assert (P // g.lanes) % 2 == 0
            assert grp & (grp - 1) == 0 and g.threads % grp == 0
            assert g.threads % 32 == 0 and g.threads <= ER_MAX_THREADS
            assert g.te % (g.threads // grp * ER_EPT) == 0
            assert (g.n_tiles - 1) * g.te < E <= g.n_tiles * g.te
            assert (g.n_jc - 1) * g.jc < P <= g.n_jc * g.jc
            assert g.blocks == B * g.n_tiles * g.n_jc
            assert g.smem == edge_smem(P, g.lanes, g.jc, g.te)
            assert (_edge_relax_stores(B, E, P, g) == 1).all(), (P, B, E, n_sm, g)


@pytest.mark.parametrize("B,E,P", [(1, 5, 2048), (3, 9, 2049), (1, 2, 5000)])
def test_edge_relax_grid_past_the_staged_widths(B, E, P):
    """Up to P = 2048 a staged launch fits a block's shared memory; above it
    the grid is one thread per output, each stored once."""
    g = edge_relax_grid(B, E, P, 132)
    assert (g.lanes > 0) == (P <= 2048)
    assert g.smem <= SMEM_LIMIT
    assert (_edge_relax_stores(B, E, P, g) == 1).all()


def test_launch_sweep_times_the_default_launch():
    """``repro_torch.launch_sweep`` times only shapes the kernel accepts, and
    at ``chip_smoke.py``'s timed shapes the launch ``edge_relax_grid`` picks
    is among them."""
    from repro_torch import launch_sweep

    for i, (B, E, P) in enumerate(launch_sweep.EDGE_SHAPES):
        cands = list(launch_sweep.shapes(P, E, ER_EPT, ER_MAX_LANES,
                                         lambda G, jc, threads, te: edge_smem(P, G, jc, te)))
        g = edge_relax_grid(B, E, P, 132)
        assert i >= 3 or (g.lanes, g.jc, g.threads, g.te) in cands
        for G, jc, threads, te in cands:
            assert G & (G - 1) == 0 and G <= ER_MAX_LANES and (G * jc) & (G * jc - 1) == 0
            assert threads % 32 == 0 and threads % (G * jc) == 0
            assert te % (threads // (G * jc) * ER_EPT) == 0


def test_seg_level_profile_anchors_match_the_kernel():
    """``repro_torch.seg_level_profile`` marks the phases of the kernel's
    source at fixed lines: every anchor is found once, so the instrumented
    copy has all seven clock marks and both timers."""
    from repro_torch import seg_level_profile

    src = seg_level_profile.instrument((Path(ops.CSRC) / "edge_relax.cu").read_text())
    assert src.count("= clock64();") == 7 and src.count("%%globaltimer") == 2
    assert "seg_probe_read" in src


def test_seg_divide_level_exposes_every_quotient():
    """``probes.seg_divide_level`` lays the divide probe out as a level of
    single-edge segments: through the fused level's plain version every
    child's row off its parent's class l* is the probe's quotient
    pdata / bw[l*, j] (+0 for -0), its pred_task the parent, its pred_proc
    l* (class 0 where the quotient overflows)."""
    carry, *rest, e_real, width = probes.seg_divide_level("random", 1, 59)
    pdata, bw, tasks, src = rest[5], rest[2][0], rest[3], rest[4]
    got = tuple(torch.as_tensor(c.copy()) for c in carry)
    ops.seg_level(got, *(torch.as_tensor(a) for a in rest), e_real, width)
    P = bw.shape[0]
    star = np.arange(e_real) % P
    with np.errstate(over="ignore"):
        want = (pdata[:, None].astype(np.float64) / bw[star].astype(np.float64)).astype(
            np.float32)
    want[np.arange(e_real), star] = 0.0
    _eq(got[0][0, tasks], want + np.float32(0.0), "ceft")
    _eq(got[1][0, tasks], np.broadcast_to(src[:, None], (e_real, P)), "pred_task")
    # a quotient that overflows ties every class at +inf: the first wins
    _eq(got[2][0, tasks], np.where(np.isinf(want), 0, star[:, None]), "pred_proc")
    assert np.isinf(want).any() and (want == 0).sum() > e_real


def test_seg_level_rejects_bad_shapes():
    carry, comp, L, bw, tasks, src, data, seg, e_real, width = _seg_inputs("padded", True)
    t = [torch.as_tensor(a) for a in (comp, L, bw, tasks, src, data, seg)]
    c = tuple(torch.as_tensor(x) for x in carry)
    for bad in ({"e_real": 0}, {"e_real": len(src) + 1}, {"width": len(tasks) - 1}):
        kw = {"e_real": e_real, "width": width, **bad}
        with pytest.raises(ValueError):
            ops.seg_level(c, *t, kw["e_real"], kw["width"])
    with pytest.raises(ValueError):
        ops.seg_level(c, t[0][:, :-1], *t[1:], e_real, width)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.seg_level(tuple(x.to("meta") for x in c), *(x.to("meta") for x in t),
                      e_real, width)


def _nan_parent_rows(carry, src, e_real):
    """NaN into the parent rows of the level's first edge (class 2) and of
    the edge in the middle (every class), in every plane."""
    ceft = carry[0].copy()
    P = ceft.shape[-1]
    ceft[:, src[0], 2 % P] = np.nan
    ceft[:, src[e_real // 2], :] = np.nan
    return (ceft, *carry[1:])


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_level_plain_nan_matches_dense_relax(case):
    """NaN parent values through the fused level's plain version against the
    dense formulation: a segment holding a NaN candidate reads NaN, its
    first NaN edge is the argmax and that edge's first NaN class the
    argmin, in one segment or many."""
    carry, *rest = _seg_inputs(case, False)
    src, e_real = rest[4], rest[7]
    carry = _nan_parent_rows(carry, src, e_real)
    _check_seg_level_against_dense(carry, *rest)
    got = tuple(torch.as_tensor(c.copy()) for c in carry)
    ops.seg_level(got, *(torch.as_tensor(a) for a in rest[:7]), e_real, rest[8])
    assert torch.isnan(got[0]).any()


@pytest.mark.parametrize("mode", probes.SPECIAL_MODES)
@pytest.mark.parametrize("shape", [(16, 7), (64, 64)])
def test_edge_relax_specials_match_jax(shape, mode):
    """NaN, inf and -0.0 candidates: the plain version and the wrapper give
    the JAX oracle's and the Pallas kernel's (interpret mode) min and argmin:
    a NaN candidate wins and the first NaN's class is the argmin."""
    args = probes.edge_specials(shape, mode, 31)
    want = jref.edge_relax_ref(*map(jnp.asarray, args))
    pallas = jax_edge_relax(*map(jnp.asarray, args), interpret=True)
    t = [torch.as_tensor(a) for a in args]
    plain = edge_relax_plain(t[0][None], t[1], t[2][None], t[3][None])
    got = ops.edge_relax(*t)
    for i, name in enumerate(["minl", "argl"]):
        _eq(pallas[i], want[i], name)
        _eq(plain[i][0], want[i], name)
        _eq(got[i], want[i], name)
    if mode == "nan_pv":
        assert torch.isnan(got[0][0]).all() and (got[1][0] == 2).all()


@pytest.mark.parametrize("mode", probes.SPECIAL_MODES)
@pytest.mark.parametrize("shape", [(3, 40, 7), (2, 64, 64)])
def test_edge_relax_superstep_specials_match_jax(shape, mode):
    args = probes.edge_specials(shape, mode, 32)
    want = jref.edge_relax_superstep_ref(*map(jnp.asarray, args))
    pallas = jax_edge_relax_superstep(*map(jnp.asarray, args), interpret=True)
    got = ops.edge_relax_superstep(*(torch.as_tensor(a) for a in args))
    for i, name in enumerate(["minl", "argl"]):
        _eq(pallas[i], want[i], name)
        _eq(got[i], want[i], name)
    if mode == "nan_pv":
        assert torch.isnan(got[0][:, 0]).all() and (got[1][:, 0] == 2).all()


@pytest.mark.parametrize("mode", probes.SPECIAL_MODES)
@pytest.mark.parametrize("shape", [(5, 9, 7), (3, 33, 64)])
def test_ceft_relax_specials_match_jax(shape, mode):
    """NaN, inf and -0.0 candidates through the dense relaxation: the plain
    version and the wrapper give the JAX oracle's and the reference sweep's
    default relaxation's (``xla_relax``) max, argmax slot and argmin class:
    a valid NaN slot wins the max and the first one is the argmax, a NaN in
    an invalid slot is masked."""
    args = probes.cell_specials(shape, mode, 33)
    want = jref.ceft_relax_ref(*map(jnp.asarray, args))
    sweep = xla_relax(*map(jnp.asarray, args[:2]), jnp.asarray(args[2] > 0),
                      *map(jnp.asarray, args[3:]))
    t = [torch.as_tensor(a) for a in args]
    plain = ceft_relax_plain(t[0][None], t[1], t[2], t[3][None], t[4][None])
    got = ops.ceft_relax(*t)
    for i, name in enumerate(["maxk", "argk", "argl"]):
        _eq(sweep[i], want[i], name)
        _eq(plain[i][0], want[i], name)
        _eq(got[i], want[i], name)
    if mode == "nan_pv":
        assert torch.isnan(got[0]).all() and (got[1] == 0).all() and (got[2] == 2).all()


def test_ceft_relax_pallas_kernel_lets_no_nan_win_the_max():
    """The reference's Pallas dense kernel folds parent slots with a strict
    '>' from -BIG, so a NaN slot never wins its max; its oracle and the
    sweeps' default relaxation (``xla_relax``) let the NaN win.  The port
    follows the oracle; this pins the reference's own disagreement."""
    args = probes.cell_specials((5, 9, 7), "nan_pv", 33)
    pallas = jax_ceft_relax(*map(jnp.asarray, args), interpret=True)
    want = jref.ceft_relax_ref(*map(jnp.asarray, args))
    assert np.isnan(np.asarray(want[0])).all()
    assert not np.isnan(np.asarray(pallas[0])).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 3, 5), (300, 37, 260)])
def test_minplus_specials_match_pallas_interpret(shape, dtype):
    """NaN, inf and -0.0 operands through the product: a NaN propagates
    through the minimum (a row of A holding one reads NaN everywhere), an
    all-inf row reads BIG, as in the reference kernel."""
    a, b = probes.minplus_specials(shape, 34)
    want = np.asarray(jax_minplus(jnp.asarray(a, dtype), jnp.asarray(b, dtype)), np.float32)
    tdt = getattr(torch, dtype)
    got = ops.minplus(torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt))
    _eq(got.float(), want)
    assert torch.isnan(got[0]).all() and torch.isnan(got[:, 1]).all()
    assert float(got[1, 0]) == float(torch.tensor(BIG, dtype=tdt))


def _fma32(a, b, c):
    """RN_float32(a * b + c), exactly, for float32 arrays: the product is
    exact in float64, TwoSum gives the float64 sum's error, and a sum that
    lands on a float32 midpoint is rounded toward the error's side."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    toward = np.where(s > r64, np.float32(np.inf), np.float32(-np.inf)).astype(np.float32)
    other = np.nextafter(r, toward)
    mid = (r64 + other.astype(np.float64)) / 2
    wrong_side = (s == mid) & (r64 != s) & (err != 0) & (np.sign(err) != np.sign(r64 - s))
    return np.where(wrong_side, other, r)


def test_superstep_markstein_divide_is_correctly_rounded():
    """The divide of ``csrc/edge_relax_superstep.cu`` and ``seg_level``
    (``csrc/relax.cuh``) emulated exactly on the CPU: inside the source's
    exponent window, q0 = RN(d * RN(1/b)), rem = fma(-q0, b, d),
    q = fma(rem, RN(1/b), q0) is RN(d / b) (float64 division rounded to
    float32 is correctly rounded: 53 >= 2 * 24 + 2) for about 3 million
    adversarial pairs; the kernels send pairs outside the window through
    __fdiv_rn, and the card tests hold both to the plain version."""
    src = (Path(ops.CSRC) / "relax.cuh").read_text()
    lo = int(re.search(r"#define SS_EXP_LO \(127 - (\d+)\)", src).group(1))
    hi = int(re.search(r"#define SS_EXP_HI \(127 \+ (\d+)\)", src).group(1))

    def biased(x):
        return ((x.view(np.uint32) >> 23) & 0xFF).astype(np.int64)

    for i, kind in enumerate(("random", "ones", "pow2")):
        _, d, _, bw = probes.divide_probe(kind, 3, 40 + i)
        d, bw = d.reshape(-1), bw.reshape(-1)
        d = d[(d.view(np.uint32) == 0) | ((biased(d) >= 127 - lo) & (biased(d) <= 127 + hi))]
        assert len(d) > 1000 and (biased(bw) >= 127 - lo).all() and (biased(bw) <= 127 + hi).all()
        dd, bb = np.meshgrid(d, bw[:1024], indexing="ij")
        dd, bb = dd.reshape(-1), bb.reshape(-1)
        rb = (1.0 / bb.astype(np.float64)).astype(np.float32)
        q0 = (dd.astype(np.float64) * rb.astype(np.float64)).astype(np.float32)
        q = _fma32(rb, _fma32(-q0, bb, dd), q0)
        want = (dd.astype(np.float64) / bb.astype(np.float64)).astype(np.float32)
        assert np.array_equal(q.view(np.uint32), want.view(np.uint32)), kind
        if kind == "random":
            assert not np.array_equal(q0, want)   # the correction step matters
