"""The CUDA kernels against their plain PyTorch versions on a card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX (the card's machine need not have it), so it keeps its own
copy of the reference's test shapes from ``tests/test_kernels.py``;
``test_torch_kernels.py`` checks that the copies match.  It also holds the
seeded input builders that the CPU parity tests share.  Tolerance: exact
(``torch.equal``), float32 and bf16 alike; where an output holds NaN, the NaN
positions must match and the rest be ``torch.equal`` (``probes.equal_nan``).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, probes  # noqa: E402
from repro_torch.kernels.ceft_relax import ceft_relax_plain  # noqa: E402
from repro_torch.kernels.edge_relax import edge_relax_plain, seg_level_plain  # noqa: E402
from repro_torch.kernels.edge_relax_superstep import edge_relax_superstep_plain  # noqa: E402
from repro_torch.kernels.minplus import minplus_plain  # noqa: E402

# the reference's test shapes (tests/test_kernels.py)
EDGE_SHAPES = [(5, 3), (128, 16), (300, 7), (1, 1), (257, 13), (64, 64)]
CELL_SHAPES = [(8, 3, 4), (5, 1, 2), (16, 7, 13), (33, 9, 64), (64, 2, 128), (1, 1, 1)]
SUPERSTEP_SHAPES = [(1, 5, 3), (4, 128, 16), (3, 300, 7), (2, 64, 64), (1, 1, 1)]
SHAPES_MINPLUS = [(4, 3, 5), (128, 16, 128), (300, 37, 260), (1, 1, 1),
                  (257, 129, 255), (16, 256, 16)]


# the superstep's other instances: P = 8 and 32 (unrolled, E not a multiple
# of the edge tile), the run-time-P instance above P = 64, and the kernel for
# machines wider than P = 160, up to the widest it takes
SUPERSTEP_WIDTHS = [(3, 300, 8), (5, 100, 32), (2, 70, 128), (2, 9, 161), (2, 40, 200),
                    (1, 17, 240)]


def _edge_inputs(shape, ties: bool):
    """(pv, pdata, L, bw) as numpy float32; ``ties`` draws small integers on
    a homogeneous machine so equal candidates are common."""
    *lead, E, P = shape
    rng = np.random.default_rng(hash((shape, ties)) % 2**31)
    if ties:
        pv = rng.integers(0, 4, (*lead, E, P)).astype(np.float32)
        pdata = rng.integers(0, 3, (*lead, E)).astype(np.float32)
        L = np.full(P, 1.0, np.float32)
        bw = np.full((P, P), 2.0, np.float32)
    else:
        pv = rng.uniform(0, 100, (*lead, E, P)).astype(np.float32)
        pdata = rng.uniform(0, 10, (*lead, E)).astype(np.float32)
        L = rng.uniform(0, 2, (P,)).astype(np.float32)
        bw = rng.uniform(0.5, 2, (P, P)).astype(np.float32)
    return pv, pdata, L, bw


# edge_relax past the widths its kernel once held whole in shared memory
# (P <= 240), up to and past the widest staged launch (edge_relax_grid: P =
# 2048, above it one thread per output); batches of planes; edge counts that
# leave the last tile ragged; every templated instance
EDGE_WIDE_CASES = [(9, 241), (40, 256), (5, 300), (6, 2048), (3, 2049), (8, 1024, 64),
                   (8, 100, 241), (3, 9, 2049), (1, 1029, 64), (2, 1001, 64), (3, 77, 32),
                   (2, 45, 16), (1, 33, 8), (4, 130, 7)]


def _edge_batch_inputs(shape):
    """(pv, pdata, L, bw) as numpy float32 for ``shape`` = (E, P), or (B, E,
    P) with a machine for each plane and the edge data shared."""
    *lead, E, P = shape
    rng = np.random.default_rng(zlib.crc32(repr(shape).encode()))
    return (rng.uniform(0, 100, (*lead, E, P)).astype(np.float32),
            rng.uniform(0, 10, E).astype(np.float32),
            rng.uniform(0, 2, (*lead, P)).astype(np.float32),
            rng.uniform(0.5, 2, (*lead, P, P)).astype(np.float32))


def _cell_inputs(shape, ties: bool, dtype=np.float32):
    W, D, P = shape
    rng = np.random.default_rng(hash((shape, ties)) % 2**31)
    pv, pdata, L, bw = _edge_inputs((W, D, P), ties)
    validp = (rng.random((W, D)) < 0.8).astype(np.float32)
    return pv, pdata, validp, L, bw


# tie-heavy dense relaxations whose fan-in spans several blocks on the card
# (the kernel splits D when B·W is small): "ties" draws small integers on a
# homogeneous machine, "constant" makes every valid slot tie, and
# "invalid_rows" also leaves the first task and every third one without a
# valid parent
CELL_TIE_CASES = [((1, 4096, 64), "ties"), ((1, 4096, 8), "ties"), ((2, 1000, 128), "ties"),
                  ((3, 300, 64), "constant"), ((8, 28, 64), "ties"), ((5, 40, 8), "constant"),
                  ((4, 700, 64), "invalid_rows"), ((6, 90, 8), "invalid_rows"),
                  ((1, 33, 128), "invalid_rows")]


def _cell_tie_inputs(shape, mode: str):
    W, D, P = shape
    rng = np.random.default_rng(zlib.crc32(repr((shape, mode)).encode()))
    pv = rng.integers(0, 4, (W, D, P)).astype(np.float32)
    pdata = rng.integers(0, 3, (W, D)).astype(np.float32)
    validp = (rng.random((W, D)) < 0.9).astype(np.float32)
    if mode == "constant":
        pv[:] = 2.0
        pdata[:] = 1.0
    if mode == "invalid_rows":
        validp[::3] = 0.0
    return (pv, pdata, validp, np.full(P, 1.0, np.float32),
            np.full((P, P), 2.0, np.float32))


# fused segment-layout levels: (B, P, segment lengths, padded edges past
# e_real, segment slots past the real children).  The card's edge tile
# (``seg_level_grid``) is 4 to 128 edges, so "long" has a segment far longer
# than a tile, "crossing" has many segments across tile boundaries, "single"
# is W_b == 1, "padded" has e_real < E_b and W_b > w, "batch8" is a batch of
# eight planes at the n = 16384 graph's level shape; "p8", "p16", "p32" take
# those instances of the kernel, "p24" and "p200" its run-time P (200: a
# j-chunk of two classes, 32 lanes a cell, some with no class), "tiles" has
# the n = 16384 graph's segment lengths over many 16-edge tiles (most
# segments cross one or more tile boundaries).
SEG_CASES = {
    "long": (1, 64, [3, 3000, 1, 40], 0, 0),
    "crossing": (2, 8, "random:60:300", 5, 0),
    "single": (1, 64, [500], 12, 0),
    "single_padded": (3, 16, [70], 3, 0),
    "padded": (1, 16, "random:30:90", 17, 3),
    "batch8": (8, 64, "random:100:12", 600, 0),
    "p128": (2, 128, "random:12:40", 1, 2),
    "one_edge": (1, 8, [1], 0, 0),
    "p8": (3, 8, "random:50:40", 2, 1),
    "p16": (1, 16, "random:70:30", 0, 0),
    "p32": (2, 32, "random:40:25", 4, 2),
    "p24": (2, 24, "random:30:20", 3, 1),
    "p200": (1, 200, "random:6:12", 0, 1),
    "tiles": (1, 64, "random:130:15", 0, 0),
}


def _seg_inputs(case: str, ties: bool):
    """One segment-layout level as numpy arrays: carry (ceft, pred_task,
    pred_proc) over V rows (parents in the first half, the level's tasks in
    the second, the last row the zero scratch row), comp, L, bw, tasks,
    edge_src, edge_data, edge_seg, e_real, width."""
    B, P, lens, pad_e, pad_w = SEG_CASES[case]
    rng = np.random.default_rng(zlib.crc32(repr((case, ties)).encode()))
    if isinstance(lens, str):
        _, w, most = lens.split(":")
        lens = rng.integers(1, int(most) + 1, int(w))
    lens = np.asarray(lens)
    w, e_real = len(lens), int(lens.sum())
    V = 2 * max(w, 64) + 1
    if ties:
        ceft = rng.integers(0, 4, (B, V, P)).astype(np.float32)
        data = rng.integers(0, 3, e_real).astype(np.float32)
        L = np.full((B, P), 1.0, np.float32)
        bw = np.full((B, P, P), 2.0, np.float32)
    else:
        ceft = rng.uniform(0, 100, (B, V, P)).astype(np.float32)
        data = rng.uniform(0, 10, e_real).astype(np.float32)
        L = rng.uniform(0, 2, (B, P)).astype(np.float32)
        bw = rng.uniform(0.5, 2, (B, P, P)).astype(np.float32)
    ceft[:, V - 1] = 0.0
    comp = rng.integers(1, 4, (B, V, P)).astype(np.float32)
    width = w + pad_w
    E_b = e_real + pad_e
    edge_src = np.full(E_b, V - 1, np.int64)
    edge_src[:e_real] = rng.integers(0, V // 2, e_real)
    edge_data = np.zeros(E_b, np.float32)
    edge_data[:e_real] = data
    edge_seg = np.full(E_b, width - 1, np.int64)
    edge_seg[:e_real] = np.repeat(np.arange(w), lens)
    tasks = (V // 2 + rng.permutation(V // 2)[:w]).astype(np.int64)
    carry = (ceft, np.full((B, V, P), -1, np.int32), np.full((B, V, P), -1, np.int32))
    return carry, comp, L, bw, tasks, edge_src, edge_data, edge_seg, e_real, width


def _minplus_inputs(shape):
    m, k, n = shape
    rng = np.random.default_rng(hash(shape) % 2**31)
    return (rng.uniform(-5, 5, (m, k)).astype(np.float32),
            rng.uniform(-5, 5, (k, n)).astype(np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES + [(1024, 64), (2048, 64)])
def test_edge_relax_kernel_matches_plain(cuda, shape):
    pv, pdata, L, bw = (torch.as_tensor(a, device=cuda)
                        for a in _edge_inputs(shape, ties=False))
    before = ops.LAUNCHES["edge_relax"]
    got = ops.edge_relax(pv, pdata, L, bw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["edge_relax"] == before + 1
    want = edge_relax_plain(pv[None], pdata, L[None], bw[None])
    for g, w in zip(got, want):
        assert torch.equal(g, w[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_WIDE_CASES)
def test_edge_relax_kernel_widths_and_batches(cuda, shape):
    """Machines wider than 240 classes (which the kernel once refused), a
    batch of planes each with its own machine, ragged last tiles and every
    templated width: one launch, bit-equal to the plain version."""
    pv, pdata, L, bw = _t(_edge_batch_inputs(shape), cuda)
    before = ops.LAUNCHES["edge_relax"]
    got = ops.edge_relax(pv, pdata, L, bw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["edge_relax"] == before + 1
    b = (lambda t: t) if len(shape) == 3 else (lambda t: t[None])
    want = edge_relax_plain(b(pv), pdata, b(L), b(bw))
    for g, w in zip(got, want):
        assert torch.equal(b(g), w)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ties", "constant"])
@pytest.mark.parametrize("shape", [(1024, 64), (300, 7), (257, 13), (40, 256), (100, 8)])
def test_edge_relax_kernel_ties(cuda, shape, mode):
    """Tie-heavy rows and constant rows (every candidate off the diagonal
    equal): the first-index argmin survives the lanes' combine."""
    pv, pdata, L, bw = _t(probes.edge_ties(shape, mode, 53), cuda)
    got = ops.edge_relax(pv, pdata, L, bw)
    want = edge_relax_plain(pv[None], pdata, L[None], bw[None])
    for g, w in zip(got, want):
        assert torch.equal(g, w[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", probes.DIVIDE_KINDS)
def test_edge_relax_kernel_divide_probe(cuda, kind):
    """The divide probe's 16 levels as one call of 16384 edges at P = 64:
    about a million adversarial (pdata, bw) quotients each reach the output,
    bit-equal to the plain version's correctly rounded CUDA division."""
    pv, pdata, L, bw = _t(probes.divide_probe(kind, 16, 57), cuda)
    pv, pdata = pv.reshape(-1, pv.shape[-1]), pdata.reshape(-1)
    got = ops.edge_relax(pv, pdata, L, bw)
    want = edge_relax_plain(pv[None], pdata, L[None], bw[None])
    for g, w in zip(got, want):
        assert probes.equal_nan(g, w[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CELL_SHAPES + [(1, 4096, 64), (8, 28, 64)])
def test_ceft_relax_kernel_matches_plain(cuda, shape):
    args = [torch.as_tensor(a, device=cuda) for a in _cell_inputs(shape, ties=False)]
    before = ops.LAUNCHES["ceft_relax"]
    got = ops.ceft_relax(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ceft_relax"] == before + 1
    want = ceft_relax_plain(args[0][None], args[1], args[2], args[3][None], args[4][None])
    for g, w in zip(got, want):
        assert torch.equal(g, w[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SUPERSTEP_SHAPES + [(192, 1024, 64), (12, 2048, 64)]
                         + SUPERSTEP_WIDTHS)
def test_edge_relax_superstep_kernel_matches_plain(cuda, shape):
    pv, pdata, L, bw = (torch.as_tensor(a, device=cuda)
                        for a in _edge_inputs(shape, ties=False))
    before = ops.LAUNCHES["edge_relax_superstep"]
    got = ops.edge_relax_superstep(pv, pdata, L, bw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["edge_relax_superstep"] == before + 1
    want = edge_relax_superstep_plain(pv, pdata, L, bw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for r in range(shape[0]):
        assert torch.equal(got[0][r], ops.edge_relax(pv[r], pdata[r], L, bw)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES_MINPLUS + [(1024, 512, 768)])
def test_minplus_kernel_matches_plain(cuda, shape, dtype):
    a, b = (torch.as_tensor(x, device=cuda).to(getattr(torch, dtype))
            for x in _minplus_inputs(shape))
    before = ops.LAUNCHES["minplus"]
    got = ops.minplus(a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["minplus"] == before + 1
    assert torch.equal(got, minplus_plain(a, b))


def _scratch_is_zero():
    return all(not k.any() and not c.any() for k, c in ops._SCRATCH.values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mode", CELL_TIE_CASES)
def test_ceft_relax_kernel_ties_across_blocks(cuda, shape, mode):
    """Tie-heavy fan-ins split across blocks: first-max slot, all-invalid
    rows (-BIG, -1, -1), bit-equal to the plain version; the scratch the
    kernel combines blocks through is left zero."""
    args = [torch.as_tensor(a, device=cuda) for a in _cell_tie_inputs(shape, mode)]
    before = ops.LAUNCHES["ceft_relax"]
    got = ops.ceft_relax(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ceft_relax"] == before + 1
    want = ceft_relax_plain(args[0][None], args[1], args[2], args[3][None], args[4][None])
    for g, w in zip(got, want):
        assert torch.equal(g, w[0])
    assert _scratch_is_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_level_kernel_matches_plain(cuda, case, ties):
    """The fused level on the card against its plain version, carry for
    carry; one launch, scratch left zero."""
    carry, comp, L, bw, tasks, src, data, seg, e_real, width = _seg_inputs(case, ties)
    host = [torch.as_tensor(a) for a in (comp, L, bw, tasks, src, data, seg)]
    want = tuple(torch.as_tensor(c.copy()) for c in carry)
    seg_level_plain(want, *host, e_real, width)
    got = tuple(torch.as_tensor(c, device=cuda) for c in carry)
    before = ops.LAUNCHES["seg_level"]
    ops.seg_level(got, *(t.to(cuda) for t in host), e_real, width)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["seg_level"] == before + 1
    for g, w, name in zip(got, want, ("ceft", "pred_task", "pred_proc")):
        assert torch.equal(g.cpu(), w), name
    assert _scratch_is_zero()


def _t(arrays, device):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", probes.SPECIAL_MODES)
@pytest.mark.parametrize("shape", [(16, 7), (64, 64), (1024, 64), (64, 300), (8, 2049)])
def test_edge_relax_kernel_specials(cuda, shape, mode):
    """NaN, inf and -0.0 candidates: the kernel gives its plain version's
    min and argmin (a NaN wins, the first NaN's class is the argmin)."""
    pv, pdata, L, bw = _t(probes.edge_specials(shape, mode, 51), cuda)
    got = ops.edge_relax(pv, pdata, L, bw)
    want = edge_relax_plain(pv[None], pdata, L[None], bw[None])
    for g, w in zip(got, want):
        assert probes.equal_nan(g, w[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", probes.SPECIAL_MODES)
@pytest.mark.parametrize("shape", [(5, 9, 7), (3, 33, 64), (1, 4096, 64), (2, 1000, 8)])
def test_ceft_relax_kernel_specials(cuda, shape, mode):
    """The dense kernel with NaN, inf and -0.0 candidates, in one block and
    split across blocks (the packed keys carry one canonical NaN above
    +inf): bit-equal to its plain version, NaN positions included; the
    scratch is left zero."""
    args = _t(probes.cell_specials(shape, mode, 52), cuda)
    got = ops.ceft_relax(*args)
    want = ceft_relax_plain(args[0][None], args[1], args[2], args[3][None], args[4][None])
    for g, w in zip(got, want):
        assert probes.equal_nan(g, w[0])
    assert _scratch_is_zero()


def _check_bf16(arrays, device):
    """The bf16 kernel on ``arrays`` against the plain version in bf16: maxk
    bit for bit, argk and argl equal, one launch, the scratch left zero."""
    args = [torch.as_tensor(a, device=device).to(torch.bfloat16) for a in arrays]
    before = ops.LAUNCHES["ceft_relax_bf16"]
    got = ops.ceft_relax(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ceft_relax_bf16"] == before + 1
    want = ceft_relax_plain(args[0][None], args[1], args[2], args[3][None], args[4][None])
    assert got[0].dtype == torch.bfloat16
    assert probes.equal_bits(got[0], want[0][0])
    assert torch.equal(got[1], want[1][0]) and torch.equal(got[2], want[2][0])
    assert _scratch_is_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 3, 4), (16, 7, 13)])
def test_ceft_relax_kernel_bf16(cuda, shape):
    """The bf16 instance at the shapes of the reference's bf16 test
    (``tests/test_kernels.py``), which it holds at rtol 1e-2: bit-equal to
    the plain version's bf16 arithmetic here."""
    _check_bf16(_cell_inputs(shape, ties=False), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", probes.SPECIAL_MODES)
@pytest.mark.parametrize("shape", [(16, 7, 13), (3, 33, 64), (1, 4096, 64), (2, 1000, 8)])
def test_ceft_relax_kernel_bf16_specials(cuda, shape, mode):
    """The bf16 instance with NaN, inf and -0.0 candidates, in one block and
    split across blocks: bit-equal to the plain version in bf16."""
    _check_bf16(probes.cell_specials(shape, mode, 58), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_level_kernel_nan(cuda, case):
    """NaN parent values through the fused level, in segments inside a tile
    and across tiles: bit-equal to the plain version (a NaN segment max,
    its first NaN edge's parent and class), scratch left zero."""
    carry, comp, L, bw, tasks, src, data, seg, e_real, width = _seg_inputs(case, False)
    ceft = carry[0].copy()
    ceft[:, src[0], 2 % ceft.shape[-1]] = np.nan
    ceft[:, src[e_real // 2], :] = np.nan
    carry = (ceft, *carry[1:])
    host = [torch.as_tensor(a) for a in (comp, L, bw, tasks, src, data, seg)]
    want = tuple(torch.as_tensor(c.copy()) for c in carry)
    seg_level_plain(want, *host, e_real, width)
    got = tuple(torch.as_tensor(c, device=cuda) for c in carry)
    ops.seg_level(got, *(t.to(cuda) for t in host), e_real, width)
    torch.cuda.synchronize()
    assert torch.isnan(want[0]).any()
    for g, w, name in zip(got, want, ("ceft", "pred_task", "pred_proc")):
        assert probes.equal_nan(g.cpu(), w), name
    assert _scratch_is_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", probes.SPECIAL_MODES)
@pytest.mark.parametrize("shape", [(3, 40, 7), (2, 64, 64), (12, 2048, 64)]
                         + SUPERSTEP_WIDTHS)
def test_edge_relax_superstep_kernel_specials(cuda, shape, mode):
    pv, pdata, L, bw = _t(probes.edge_specials(shape, mode, 53), cuda)
    got = ops.edge_relax_superstep(pv, pdata, L, bw)
    want = edge_relax_superstep_plain(pv, pdata, L, bw)
    for g, w in zip(got, want):
        assert probes.equal_nan(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 3, 5), (300, 37, 260), (256, 256, 256)])
def test_minplus_kernel_specials(cuda, shape, dtype):
    a, b = (x.to(getattr(torch, dtype)) for x in _t(probes.minplus_specials(shape, 54), cuda))
    got = ops.minplus(a, b)
    assert probes.equal_nan(got, minplus_plain(a, b))
    assert torch.isnan(got[0]).all() and torch.isnan(got[:, 1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ties", "constant"])
@pytest.mark.parametrize("shape", [(4, 128, 16), (3, 300, 7), (158, 1024, 64)]
                         + SUPERSTEP_WIDTHS)
def test_edge_relax_superstep_kernel_ties(cuda, shape, mode):
    """Tie-heavy tables (small integers, or every off-diagonal candidate
    equal) on a homogeneous machine: the first-index argmin of every edge a
    thread carries, bit-equal to the plain version and slice by slice to
    ``edge_relax``."""
    pv, pdata, L, bw = _t(probes.edge_ties(shape, mode, 55), cuda)
    got = ops.edge_relax_superstep(pv, pdata, L, bw)
    want = edge_relax_superstep_plain(pv, pdata, L, bw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for r in range(shape[0]):
        m1, a1 = ops.edge_relax(pv[r], pdata[r], L, bw)
        assert torch.equal(got[0][r], m1) and torch.equal(got[1][r], a1)


@pytest.mark.cuda
def test_edge_relax_superstep_kernel_rejects_wider_machines(cuda):
    """P = 241 would not fit bw and L in a block's shared memory: the wrapper
    raises before launching."""
    pv, pdata, L, bw = (torch.as_tensor(a, device=cuda)
                        for a in _edge_inputs((1, 4, 241), ties=False))
    before = ops.LAUNCHES["edge_relax_superstep"]
    with pytest.raises(ValueError, match="P <= 240"):
        ops.edge_relax_superstep(pv, pdata, L, bw)
    assert ops.LAUNCHES["edge_relax_superstep"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", probes.DIVIDE_KINDS)
def test_edge_relax_superstep_kernel_divide_probe(cuda, kind):
    """About a million adversarial (pdata, bw) quotients each reach the
    output at P = 64: the kernel's divide (Markstein inside its exponent
    window, __fdiv_rn outside) equals the plain version's correctly rounded
    CUDA division, bit for bit."""
    pv, pdata, L, bw = _t(probes.divide_probe(kind, 16, 56), cuda)
    got = ops.edge_relax_superstep(pv, pdata, L, bw)
    want = edge_relax_superstep_plain(pv, pdata, L, bw)
    for g, w in zip(got, want):
        assert probes.equal_nan(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", probes.DIVIDE_KINDS)
def test_seg_level_kernel_divide_probe(cuda, kind):
    """The divide probe's adversarial (pdata, bw) pairs as one level of
    16384 single-edge segments: every quotient reaches the carry through
    the fused level's divide (Markstein inside its exponent window,
    __fdiv_rn outside), bit-equal to the plain version's CUDA division,
    scratch left zero."""
    carry, *rest, e_real, width = probes.seg_divide_level(kind, 16, 58)
    args = [torch.as_tensor(a, device=cuda) for a in rest]
    want = tuple(torch.as_tensor(c, device=cuda) for c in carry)
    seg_level_plain(want, *args, e_real, width)
    got = tuple(torch.as_tensor(c, device=cuda) for c in carry)
    ops.seg_level(got, *args, e_real, width)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("ceft", "pred_task", "pred_proc")):
        assert probes.equal_nan(g, w), name
    assert _scratch_is_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", probes.MINPLUS_KINDS)
def test_minplus_kernel_probe(cuda, kind, dtype):
    """Sums on bf16 rounding ties, near the largest bf16 and BIG, among
    subnormals and on ±0, each exposed as an output (K = 1), in pairs
    (K = 2) and in a product: bit-equal to the plain version's float32 sums
    rounded once."""
    a, b = (x.to(getattr(torch, dtype)) for x in _t(probes.minplus_probe(kind, 57), cuda))
    assert probes.equal_nan(ops.minplus(a, b), minplus_plain(a, b))


# ------------------------------------------------------------ the LM engine
@pytest.mark.cuda
@pytest.mark.parametrize("arch,P", [("granite-3-8b", 24), ("minicpm-2b", 16),
                                    ("mixtral-8x22b", 40), ("glm4-9b", 8),
                                    ("mamba2-2.7b", 20), ("jamba-v0.1-52b", 16)])
def test_engine_on_the_card_matches_the_cpu(cuda, arch, P):
    """A smoke engine on the card against the same engine (the same weights,
    made on the CPU) on the CPU: float32 compute with TF32 off, identical
    greedy tokens; mixtral's 40-token prompt takes the SWA ring, mamba2's
    20-token prompt a padded SSM chunk."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.common import tree_to
    from repro_torch.serve import Engine, ServeConfig

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(configs.get(arch, smoke=True), compute_dtype="float32")
    cpu = Engine(cfg, seed=0, device="cpu")
    card = Engine(cfg, params=tree_to(cpu.params, cuda), device=cuda)
    prompts = np.random.default_rng(P).integers(2, cfg.vocab, (3, P)).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=16)
    got = card.generate(prompts, scfg)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, cpu.generate(prompts, scfg))


@pytest.mark.cuda
def test_whisper_on_the_card_matches_the_cpu(cuda):
    """whisper-smoke's ``Model.prefill`` on zero frames (the reference
    engine's stub) and 8 teacher-forced ``Model.decode`` steps on the card
    against the CPU, float32 with TF32 off: logits within 1e-4."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build, init_params
    from repro_torch.models.common import tree_to

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(configs.get("whisper-tiny", smoke=True), compute_dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    B, P, steps = 2, 8, 8
    tok = torch.as_tensor(np.random.default_rng(0).integers(2, cfg.vocab, (B, P + steps)))
    frames = torch.zeros((B, cfg.enc_seq, cfg.d_model))
    logits = {}
    for dev, p in (("cpu", params), (cuda, tree_to(params, cuda))):
        with torch.inference_mode():
            pf, first = model.prefill(p, {"frames": frames.to(dev), "tokens": tok[:, :P].to(dev)})
            cache = init_params(model.cache_specs(B, P + steps), None, dev)
            for n in ("k", "v"):
                cache["self"][n][:, :, :P] = pf["self"][n]
                cache["cross"][n].copy_(pf["cross"][n])
            out = [first]
            for t in range(P, P + steps):
                out.append(model.decode(p, cache, tok[:, t:t + 1].to(dev), t)[0])
        logits[dev] = [x.float().cpu() for x in out]
    for got, want in zip(logits[cuda], logits["cpu"]):
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4


# ---------------------------------------------------------- the train step
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x22b", "mamba2-2.7b",
                                  "jamba-v0.1-52b", "whisper-tiny"])
def test_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Three ``TrainStep``s of a smoke config on the card against the same
    weights and batches on the CPU, float32 compute with TF32 off: losses
    within 1e-5 relative, grad norms within 1e-4."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train
    from repro_torch.models import build
    from repro_torch.models.common import tree_to

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(configs.get(arch, smoke=True), compute_dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    data = SyntheticLM(DataConfig(cfg.vocab, 64, 2, 0))
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    metrics = {}
    for dev in (cuda, "cpu"):      # the CPU run last: it updates ``params`` in place
        step, opt, _ = build_train(model, None, 10, 5e-3)
        p = tree_to(params, dev)
        state = opt.init(p)
        out = []
        for i in range(3):
            batch = data.device_batch(i, dev)
            if cfg.family == "encdec":
                batch["frames"] = frames.to(dev)
            p, state, m = step(p, state, batch)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        metrics[dev] = out
    for (l1, g1), (l2, g2) in zip(metrics[cuda], metrics["cpu"]):
        assert abs(l1 - l2) <= 1e-5 * abs(l2) and abs(g1 - g2) <= 1e-4 * abs(g2)
