"""The dense family's tensor- and sequence-parallel train step
(``launch.steps.ShardedTrainStep``, ``models.tensor_parallel``) on a gloo
group of 4 spawned CPU ranks, against the port's one-device step on the same
weights (the reference's ``Model.init``, carried over by
``params_from_reference``) and batches, and against the reference's loss.

Cases: granite smoke on (data 2, model 2) (its 2 kv heads split) and on
(1, 4) (each rank's q head uses a kv head of the whole ``wk``); llama3 smoke
on (1, 4) (2 q heads a rank in one GQA group); minicpm smoke on (1, 4) (6
heads on 4 ranks: each rank runs every head on its query slice of the
sequence, k and v over all of it, and an all-to-all brings the output to
``wo``'s rows; tied embeddings over a split vocabulary) and under ``serve``
on (2, 2) (the query slice over both axes); granite smoke under the
``serve`` profile on (2, 2) (heads,
MLP and vocabulary over both axes, the batch and sequence whole); granite smoke
under ``opt1`` on (2, 2) (baseline's layout but the (un)embedding tables'
``d_model`` axis whole: on (1, 4) the two profiles are one layout).  Each
case's tables resolve to the reference's ``resolve_spec`` under its profile.

Tolerances (``test_torch_distributed.py``'s for the sharded step): the loss
within 1e-5 relative, the grad norm within 1e-4, each gradient leaf within
1e-4 of its largest entry; the step-1 loss within 1e-5 of the reference's
``Model.loss`` in float32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from test_torch_distributed import (SMOKE, check_tables, rel, smoke_cfg, spawn,  # noqa: E402
                                    table_specs)

CASES = {  # name: (arch, mesh shape, profile)
    "granite-2x2": ("granite-3-8b", (2, 2), "baseline"),
    "granite-1x4": ("granite-3-8b", (1, 4), "baseline"),
    "llama3-1x4": ("llama3-405b", (1, 4), "baseline"),
    "minicpm-1x4": ("minicpm-2b", (1, 4), "baseline"),
    "granite-serve-2x2": ("granite-3-8b", (2, 2), "serve"),
    "granite-opt1-2x2": ("granite-3-8b", (2, 2), "opt1"),
    "minicpm-serve-2x2": ("minicpm-2b", (2, 2), "serve"),
}
STEPS = 3


def tp_rank_job(rank, world, init, tmp, weights):
    """Every case on one 4-rank gloo group, three steps from the reference's
    weights; before each, the port's one-device step on this rank, from the
    parameters and optimizer state the tensor-parallel step holds, gathered
    whole.  Then one rank's MLP FLOPs under the counter, on (1, 4) and on
    one device."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.interop import params_onto_mesh
    from repro_torch.launch.steps import build_train, input_shardings
    from repro_torch.models import build
    from repro_torch.models.common import sharding_profile, sorted_leaves
    from repro_torch.models.layers import mlp
    from repro_torch.models.tensor_parallel import tensor_parallel
    from repro_torch.optim import AdamWState
    from repro_torch.optim.adamw import tree_map_sorted
    from repro_torch.substrate import CostCounter, full_value, init_group, make_mesh
    torch.set_num_threads(2)
    init_group("gloo", rank, world, init)
    cell = ShapeCell("smoke", **SMOKE)

    def whole(tree):
        return tree_map_sorted(lambda t: full_value(t).clone(), tree)
    out = {}
    for name, (arch, shape, profile) in CASES.items():
        cfg = smoke_cfg(arch)
        model = build(cfg)
        data = SyntheticLM(DataConfig(cfg.vocab, cell.seq_len, cell.global_batch, 0))
        one, one_opt, _ = build_train(model, None, 10, 5e-3)
        rows = []
        with sharding_profile(profile):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            step, opt, sh = build_train(model, mesh, 10, 5e-3)
            params = params_onto_mesh(weights[arch], sh["params"])
            state = opt.init(params)
            in_sh = input_shardings(model.input_specs(cell), mesh)
            tp = tensor_parallel(cfg, model.specs(), mesh, in_sh["labels"].spec)
            for i in range(STEPS):
                p1 = whole(params)
                s1 = AdamWState(full_value(state.count).clone(), whole(state.m), whole(state.v))
                lr = float(one_opt.lr(s1.count + 1))
                loss1, grads1 = one.loss_and_grads(p1, data.device_batch(i, "cpu"))
                p1, _, gn1 = one_opt.update(grads1, s1, p1)
                batch = data.sharded_batch(i, in_sh)
                _, grads = step.loss_and_grads(params, batch)
                params, state, m = step(params, state, batch)
                rows.append(dict(
                    loss=(float(m["loss"]), float(loss1)), grad_norm=(float(m["grad_norm"]),
                                                                      float(gn1)),
                    grad_leaf=max(rel(full_value(g), w) for g, w in
                                  zip(sorted_leaves(grads), sorted_leaves(grads1))),
                    params_in_lr=max(float((full_value(a) - b).abs().max()) for a, b in
                                     zip(sorted_leaves(params), sorted_leaves(p1))) / lr))
        out[name] = dict(steps=rows, plan=(tp.q_local, tp.kv_local, tp.q_slice_axes,
                                           tp.vocab_axes, tp.seq_axes),
                         tables=table_specs(sh["params"]))

    cfg = smoke_cfg("granite-3-8b")
    mesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
    tp = tensor_parallel(cfg, build(cfg).specs(), mesh, (("data",), ("model",)))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(SMOKE["global_batch"], SMOKE["seq_len"], cfg.d_model, generator=gen)
    p = {k: torch.randn(s, generator=gen) for k, s in
         (("wg", (cfg.d_model, cfg.d_ff)), ("wu", (cfg.d_model, cfg.d_ff)),
          ("wd", (cfg.d_ff, cfg.d_model)))}
    cols = slice(rank * cfg.d_ff // 4, (rank + 1) * cfg.d_ff // 4)
    local = {"wg": p["wg"][:, cols], "wu": p["wu"][:, cols], "wd": p["wd"][cols]}
    seq = slice(rank * SMOKE["seq_len"] // 4, (rank + 1) * SMOKE["seq_len"] // 4)
    one, split = CostCounter(), CostCounter()
    with one:
        want = mlp(p, x, cfg)
    with split:
        got = mlp(local, x[:, seq], cfg, tp)
    out["mlp"] = dict(one=one.flops, split=split.flops, err=rel(got, want[:, seq]),
                      kinds=sorted({k for k, _, _ in split.collectives}))
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """Per architecture: the reference's ``Model.init`` weights (seed 0) in
    float32 compute, and its ``Model.loss`` on the first batch."""
    import jax
    import jax.numpy as jnp
    import repro.configs as JC
    from repro.models import build as jbuild
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import DataConfig, SyntheticLM
    out = {}
    for arch in sorted({a for a, _, _ in CASES.values()}):
        jcfg = dataclasses.replace(JC.get(arch, smoke=True), compute_dtype="float32")
        model = jbuild(jcfg)
        params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
        cell = ShapeCell("smoke", **SMOKE)
        batch = SyntheticLM(DataConfig(jcfg.vocab, cell.seq_len, cell.global_batch, 0)).batch(0)
        loss = float(model.loss(params, {k: jnp.asarray(v) for k, v in batch.items()}))
        out[arch] = (params, loss)
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return spawn(tp_rank_job, 4, tmp, {a: w for a, (w, _) in reference.items()})


PLANS = {  # name: (q heads split, kv heads split, the axes the queries' sequence splits
    #         over where the q heads do not, vocabulary axes, sequence axes)
    "granite-2x2": (True, True, (), ("model",), ("model",)),
    "granite-1x4": (True, False, (), ("model",), ("model",)),
    "llama3-1x4": (True, False, (), ("model",), ("model",)),
    "minicpm-1x4": (False, False, ("model",), ("model",), ("model",)),
    "granite-serve-2x2": (True, False, (), ("model", "data"), ()),
    "granite-opt1-2x2": (True, True, (), ("model",), ("model",)),
    "minicpm-serve-2x2": (False, False, ("model", "data"), ("model", "data"), ()),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_step_matches_one_device_step(ranks, reference, name):
    """Three steps from the reference's weights.  At each, on every rank,
    the tensor-parallel step's loss, grad norm and gradients (each leaf)
    against the one-device step's from the same parameters and optimizer
    state, and its updated parameters within two learning rates of the
    one-device update's (Adam's first steps are about the gradient's sign,
    which a near-zero gradient entry summed in another order may flip: the
    card-against-CPU bound of ``chip_smoke.py`` phase g1); the first step's
    loss against the reference's.  Each case takes the head and vocabulary
    branch it names."""
    _, ref_loss = reference[CASES[name][0]]
    rows = [row for r in ranks for row in r[name]["steps"]]
    print(name, {k: max(abs(row[k][0] - row[k][1]) / abs(row[k][1]) for row in rows)
                 for k in ("loss", "grad_norm")},
          {k: max(row[k] for row in rows) for k in ("grad_leaf", "params_in_lr")})
    for r in ranks:
        got = r[name]
        assert got["plan"] == PLANS[name]
        check_tables(got["tables"], CASES[name][0], ("data", "model"), *CASES[name][1:])
        assert abs(got["steps"][0]["loss"][1] - ref_loss) <= 1e-5 * abs(ref_loss)
        for row in got["steps"]:
            (gl, wl), (gn, wn) = row["loss"], row["grad_norm"]
            assert abs(gl - wl) <= 1e-5 * abs(wl) and abs(gn - wn) <= 1e-4 * abs(wn), row
            assert row["grad_leaf"] <= 1e-4 and row["params_in_lr"] <= 2.01, row
        assert [s["loss"][0] for s in got["steps"]] == [s["loss"][0] for s in ranks[0][name]["steps"]]


def test_a_rank_computes_its_share_of_the_mlp(ranks):
    """On (1, 4) a rank's MLP products run on its quarter of the hidden
    columns over its rows' whole sequence: a quarter of the one-device
    FLOPs, the sequence gathered and the output reduce-scattered back into
    the rank's slice, within 1e-5 of the one-device MLP's rows there."""
    for r in ranks:
        m = r["mlp"]
        assert m["split"] * 4 == m["one"]
        assert m["kinds"] == ["all-gather", "reduce-scatter"]
        assert m["err"] < 1e-5


@pytest.mark.parametrize("heads, n, want", [
    ((32, 8), 16, (True, False)),     # granite-3-8b on 16: a rank's q pair in one kv group
    ((32, 8), 8, (True, True)),       # both split whole
    ((36, 36), 16, (False, False)),   # minicpm-2b: 2.25 heads a rank
    ((12, 6), 4, (False, False)),     # 3 q heads a rank would straddle two kv groups
    ((4, 2), 1, (True, True)),        # one rank: nothing splits
])
def test_head_split_rule(heads, n, want):
    """``head_split``'s branches: q heads split where they divide and each
    rank's q heads use whole kv heads or lie in one GQA group; kv heads
    where they divide too."""
    from repro_torch.models.tensor_parallel import head_split
    assert head_split(*heads, n) == want
