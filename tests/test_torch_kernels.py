"""The port's relaxation oracles and plain kernel versions against the
reference package's JAX oracles (and its Pallas kernels in interpret mode).

Tolerance: float32 results are bit-equal (same operation order, same tie
rules); the bf16 dense relaxation is held at rtol=1e-2 as in the reference's
own ``test_ceft_relax_bf16``.  Tests marked ``cuda`` compare the CUDA kernels
with their plain versions on a card and skip without one."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ceft_relax as jax_ceft_relax  # noqa: E402
from repro.kernels import edge_relax as jax_edge_relax  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ceft_relax import ceft_relax_plain  # noqa: E402
from repro_torch.kernels.edge_relax import edge_relax_plain  # noqa: E402
from test_kernels import CELL_SHAPES, EDGE_SHAPES, SHAPES_MINPLUS, SUPERSTEP_SHAPES  # noqa: E402


def _eq(got, want, name=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)


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


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
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


# ----------------------------------------------------------- on a card only
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
