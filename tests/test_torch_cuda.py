"""The CUDA kernels against their plain PyTorch versions on a card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX (the card's machine need not have it), so it keeps its own
copy of the reference's test shapes from ``tests/test_kernels.py``;
``test_torch_kernels.py`` checks that the copies match.  It also holds the
seeded input builders that the CPU parity tests share.  Tolerance: exact
(``torch.equal``), float32 and bf16 alike.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ceft_relax import ceft_relax_plain  # noqa: E402
from repro_torch.kernels.edge_relax import edge_relax_plain  # noqa: E402
from repro_torch.kernels.edge_relax_superstep import edge_relax_superstep_plain  # noqa: E402
from repro_torch.kernels.minplus import minplus_plain  # noqa: E402

# the reference's test shapes (tests/test_kernels.py)
EDGE_SHAPES = [(5, 3), (128, 16), (300, 7), (1, 1), (257, 13), (64, 64)]
CELL_SHAPES = [(8, 3, 4), (5, 1, 2), (16, 7, 13), (33, 9, 64), (64, 2, 128), (1, 1, 1)]
SUPERSTEP_SHAPES = [(1, 5, 3), (4, 128, 16), (3, 300, 7), (2, 64, 64), (1, 1, 1)]
SHAPES_MINPLUS = [(4, 3, 5), (128, 16, 128), (300, 37, 260), (1, 1, 1),
                  (257, 129, 255), (16, 256, 16)]


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


def _cell_inputs(shape, ties: bool, dtype=np.float32):
    W, D, P = shape
    rng = np.random.default_rng(hash((shape, ties)) % 2**31)
    pv, pdata, L, bw = _edge_inputs((W, D, P), ties)
    validp = (rng.random((W, D)) < 0.8).astype(np.float32)
    return pv, pdata, validp, L, bw


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
@pytest.mark.parametrize("shape", SUPERSTEP_SHAPES + [(192, 1024, 64), (12, 2048, 64)])
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
