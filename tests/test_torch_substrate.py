"""The port's distribution substrate against the reference's, in one process:
the logical -> mesh rules resolved for every architecture at its published
widths (shapes only: no mesh, no allocation), the input specs of every
cell, greedy degradation, the constraints outside a mesh, a one-rank mesh,
each rank's rows under a tuple of mesh axes against JAX's own device map,
and the int8 error-feedback compression bit for bit.

Tolerances: specs and rows are exact; the compression is bit-equal to the
reference's (``torch.round`` and ``jnp.round`` both round half to even);
the ported invariant and convergence tests keep the reference's own bounds.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.substrate as jsub  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import substrate  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.optim import grad_compress as gc  # noqa: E402

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 16, "expert": 8, "tp": 2}]
PROFILES = common.profile_names()


def flat(tree, path=""):
    """(path, leaf) pairs of a nested-dict tree, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def ref_entries(spec) -> tuple:
    """A reference PartitionSpec as the port's tuple of entries."""
    return tuple(spec)


def test_profiles_match_reference():
    assert PROFILES == jcommon.profile_names()
    for name in PROFILES:
        assert dict(common.resolve_profile(name).rules) == dict(jcommon.resolve_profile(name).rules)


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_logical_pspecs_match_reference(arch):
    """Every parameter leaf, and every leaf of the decode cache at each
    decode cell of the arch, resolves to the reference's spec under every
    profile on each mesh shape."""
    model, jmodel = build(TC.get(arch)), jbuild(JC.get(arch))
    trees = [(model.specs(), jmodel.specs())]
    for name in TC.cells_for(TC.get(arch)):
        cell = TC.SHAPES[name]
        if cell.kind == "decode":
            trees.append((model.cache_specs(cell.global_batch, cell.seq_len),
                          jmodel.cache_specs(cell.global_batch, cell.seq_len)))
    n = 0
    for profile in PROFILES:
        for ms in MESHES:
            for tspec, jspec in trees:
                got = flat(common.logical_pspecs(tspec, ms, profile=profile))
                want = flat(jcommon.logical_pspecs(jspec, ms, profile=profile))
                assert [p for p, _ in got] == [p for p, _ in want]
                for (path, g), (_, w) in zip(got, want):
                    assert g == ref_entries(w), (arch, profile, ms, path, g, w)
                    n += 1
    assert n > 0


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_input_specs_match_reference(arch):
    """``resolve_spec`` over ``INPUT_LOGICAL`` of ``Model.input_specs``
    gives the reference's input specs for every cell of the arch, every
    profile and mesh shape."""
    assert steps.INPUT_LOGICAL == jsteps.INPUT_LOGICAL
    model, jmodel = build(TC.get(arch)), jbuild(JC.get(arch))
    for name in TC.cells_for(TC.get(arch)):
        got_in = model.input_specs(TC.SHAPES[name])
        want_in = jmodel.input_specs(JC.SHAPES[name])
        assert sorted(got_in) == sorted(want_in)
        for profile in PROFILES:
            for ms in MESHES:
                for k, v in got_in.items():
                    assert tuple(v.shape) == tuple(want_in[k].shape)
                    got = common.resolve_spec(tuple(v.shape), steps.INPUT_LOGICAL[k], ms,
                                              profile=profile)
                    want = jcommon.resolve_spec(want_in[k].shape, jsteps.INPUT_LOGICAL[k],
                                                ms, profile=profile)
                    assert got == ref_entries(want), (arch, name, k, profile, ms)


def test_degrade_spec_matches_reference():
    rng = np.random.default_rng(0)
    axes = ["pod", "data", "model", "expert", "tp", "none"]
    for _ in range(500):
        nd = int(rng.integers(0, 5))
        shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 36, 128])) for _ in range(nd))
        cands = [tuple(rng.choice(axes, size=int(rng.integers(0, 4)), replace=False))
                 for _ in range(nd)]
        sizes = {a: int(rng.choice([1, 2, 4, 8, 16])) for a in axes[:5] if rng.random() < 0.8}
        assert substrate.degrade_spec(shape, cands, sizes) == \
            ref_entries(jsub.degrade_spec(shape, cands, sizes)), (shape, cands, sizes)


def test_constrain_no_mesh_is_identity():
    x = torch.ones(4, 4)
    assert substrate.current_abstract_mesh() is None and substrate.current_axis_sizes() is None
    assert substrate.constrain(x, "data", "model") is x
    assert substrate.constrain_spec(x, ("data", None)) is x
    assert common.constrain(x, "batch", "embed_d") is x


def test_local_slices_match_jax_devices_indices_map():
    """Each rank's slice under a spec, a tuple of mesh axes on one dimension
    included, is the index JAX's ``NamedSharding`` gives that device, on a
    (2, 2) and a (2, 2, 2) mesh of fake devices."""
    from conftest import run_isolated_script
    cases = [((2, 2), ("data", "model"), (8, 4), spec) for spec in
             [("data", "model"), (("model", "data"), None), (("data", "model"), None),
              (None, ("model", "data")), ("model", None), (None, None)]]
    cases += [((2, 2, 2), ("pod", "data", "model"), (16, 8), spec) for spec in
              [(("pod", "data"), "model"), (("model", "data"), "pod"),
               (("model", "pod", "data"), None), (("data", "model", "pod"), None)]]
    r = run_isolated_script(f"""
        import json
        import numpy as np
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec
        out = []
        for mshape, axes, shape, spec in {cases!r}:
            n = int(np.prod(mshape))
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(mshape), axes)
            m = NamedSharding(mesh, PartitionSpec(*spec)).devices_indices_map(shape)
            out.append({{d.id: [[s.start or 0, s.stop if s.stop is not None else dim]
                                for s, dim in zip(idx, shape)] for d, idx in m.items()}})
        print("MAP", json.dumps(out))
    """, fake_devices=8, marker="MAP", timeout=120)
    maps = json.loads(r.stdout.split("MAP", 1)[1])
    for (mshape, axes, shape, spec), m in zip(cases, maps):
        sizes = dict(zip(axes, mshape))
        for rank, coord in enumerate(np.ndindex(*mshape)):
            got = substrate.local_slices(shape, spec, sizes, dict(zip(axes, coord)))
            assert [[s.start, s.stop] for s in got] == m[str(rank)], (spec, coord)


@pytest.fixture
def one_rank():
    """A gloo world of this one process, torn down after the test."""
    import torch.distributed as dist
    substrate.init_group("gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_and_context(one_rank):
    mesh = substrate.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    assert substrate.mesh_axis_sizes(mesh) == {"data": 1, "model": 1}
    assert make_test_mesh(device_type="cpu").mesh_dim_names == ("data", "model")
    with substrate.mesh_context(mesh):
        assert substrate.current_abstract_mesh() is mesh
        assert substrate.current_axis_sizes() == {"data": 1, "model": 1}
        x = torch.arange(8.0).reshape(4, 2)
        sh = substrate.Sharding(mesh, ("data", "model"))
        d = substrate.distribute(x, sh)
        assert d.to_local().data_ptr() == x.data_ptr()     # one rank: no copy
        assert substrate.full_value(substrate.constrain(d, "model", None)).equal(x)
    assert substrate.current_axis_sizes() is None
    # the reference's parameters carried onto the mesh by Model.shardings
    from repro_torch.interop import params_onto_mesh
    jparams = jax.tree.map(np.asarray, jbuild(JC.get("minicpm-2b", smoke=True)).init(
        jax.random.PRNGKey(0)))
    on_mesh = params_onto_mesh(jparams, build(TC.get("minicpm-2b", smoke=True)).shardings(mesh))
    leaves = common.sorted_leaves(on_mesh)
    assert len(leaves) == len(jax.tree.leaves(jparams))
    for got, want in zip(leaves, jax.tree.leaves(jparams)):
        assert isinstance(got, DTensor) and got.device_mesh is mesh
        np.testing.assert_array_equal(bits(substrate.full_value(got)), bits(want))
    with pytest.raises(RuntimeError, match="need 65536 devices, have 1"):
        substrate.make_mesh((1024, 64), ("data", "model"), device_type="cpu")
    with pytest.raises(RuntimeError, match="need 512 devices, have 1"):
        make_production_mesh(multi_pod=True, device_type="cpu")


# ------------------------------------------------------------ compression
def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8)


def test_ef_quantize_is_bit_equal_to_reference():
    """50 rounds of error feedback on a heavy-tailed gradient, with exact
    halves and a zero tensor: the int8 payload, the scale, g_hat and the new
    residual bit for bit at every round."""
    rng = np.random.default_rng(1)
    g = (rng.standard_t(2, size=4096) * 10).astype(np.float32)
    g[:64] = np.arange(64, dtype=np.float32) - 31.5        # ties at the half
    ef_t, ef_j = torch.zeros(4096), jnp.zeros(4096)
    for _ in range(50):
        gh_t, ef_t = gc.ef_quantize(torch.as_tensor(g), ef_t)
        gh_j, ef_j = jgc.ef_quantize(jnp.asarray(g), ef_j)
        np.testing.assert_array_equal(bits(gh_t), bits(gh_j))
        np.testing.assert_array_equal(bits(ef_t), bits(ef_j))
    for x in (g, np.zeros(7, np.float32)):
        q, s = gc._quant(torch.as_tensor(x))
        jq, js = jgc._quant(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(bits(s), bits(js))


def test_ef_tree_and_init_are_bit_equal_to_reference():
    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(8, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(3,)).astype(np.float32)}}
    t = {"w": torch.as_tensor(tree["w"]), "b": {"c": torch.as_tensor(tree["b"]["c"])}}
    ef = gc.init_ef(t)
    jef = jgc.init_ef(jax.tree.map(jnp.asarray, tree))
    for a, b in zip(common.sorted_leaves(ef), jax.tree.leaves(jef)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(bits(a), bits(b))
    for _ in range(3):
        gh, ef = gc.ef_quantize_tree(t, ef)
        jgh, jef = jgc.ef_quantize_tree(jax.tree.map(jnp.asarray, tree), jef)
        for a, b in zip(common.sorted_leaves(gh) + common.sorted_leaves(ef),
                        jax.tree.leaves(jgh) + jax.tree.leaves(jef)):
            np.testing.assert_array_equal(bits(a), bits(b))


def test_error_feedback_invariant():
    """g + ef == g_hat + new_ef exactly (per step), so the accumulated
    quantization error never grows (the reference's test, on the port)."""
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.normal(size=(512,)) * 10, dtype=torch.float32)
    ef = torch.zeros(512)
    for _ in range(50):
        gh, ef2 = gc.ef_quantize(g, ef)
        np.testing.assert_allclose((g + ef).numpy(), (gh + ef2).numpy(), rtol=1e-5, atol=1e-4)
        ef = ef2
    assert float(ef.abs().max()) < float(g.abs().max()) / 127 * 2


def test_ef_tree_and_sgd_convergence_with_compression():
    """SGD with EF-int8 compressed grads converges to the same optimum (the
    reference's test, on the port)."""
    target = torch.tensor([1.0, -2.0, 0.5, 3.0])
    params = {"w": torch.zeros(4)}
    ef = gc.init_ef(params)
    for _ in range(400):
        g = {"w": 2 * (params["w"] - target)}
        gh, ef = gc.ef_quantize_tree(g, ef)
        params = {"w": params["w"] - 0.05 * gh["w"]}
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)
