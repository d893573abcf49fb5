"""The MoE family on a mesh: the tensor-, sequence- and expert-parallel
``ShardedTrainStep``, ``PrefillStep`` and ``DecodeStep``
(``models.tensor_parallel``, ``models.moe`` on a plan) on a gloo group of 4
spawned CPU ranks, from the reference's weights (``Model.init``, carried over
by ``params_onto_mesh``), in float32.

Cases: dbrx smoke (8 experts) on (data 2, model 2) and (1, 4), its experts
apart on ``model``; mixtral smoke (4 experts) on (1, 4), one expert a rank;
mixtral smoke under ``moe_ep`` on (data, expert, tp) = (1, 2, 2), two experts
a rank on ``expert`` and their hidden columns on ``tp``; mixtral smoke with 6
experts on (1, 4), which do not divide the axis: every expert on every rank,
its hidden columns gathered in the layer (mixtral-8x22b's 8 experts on a
16-way ``model`` axis take that branch); mixtral smoke under ``moe_ep`` with 4
kv heads, which split over (expert, tp) as the cache's sequence does, so
prefill lays its cache out by one all-to-all over both axes (mixtral-8x22b's
8 kv heads on (16, 8, 2) do the same).  At S = 64 (train) and P = 8 or 40
(serving) one token group spans every rank; the ``s512`` cases run S = 512,
whose groups of 256 fall whole on a rank of (2, 2) and span two ranks of
``moe_ep``'s four.  The mixtral prompts of 40 and 512 tokens are longer than
its 32-token window, so the ring wraps in ``seed_cache`` and in decode.
dbrx and mixtral smoke under ``serve`` on (2, 2): the experts on ``model``,
their hidden columns on what the experts leave of (``model``, ``data``), so
``data``, and the tokens replicated over ``data`` with the sequence whole,
as the reference's ``resolve_spec`` lays them out; dbrx smoke under
``opt1`` on (2, 2), baseline's layout with the (un)embedding tables whole
over ``data``.  Each case's tables resolve to the reference's specs under
its profile.  mixtral smoke under ``serve`` with 4 kv heads, which split
over (``model``, ``data``), prefills one row, which ``data`` does not
divide: the cache is whole over ``data``, so prefill gathers the heads over
``data`` and trades them for the sequence over ``model`` (mixtral-8x22b's 8
kv heads and (1, 5120) prompt on the card's (2, 2) do the same).  dbrx and
mixtral smoke (with 4 and 6 experts) serve one row under the baseline on
(2, 2) (``*-b1-2x2``): the row leaves ``data`` whole, so the decode plan
keeps every weight, the router and the experts' too, on its ``data`` shard
(``stationary_axes``) and moves the token, as XLA partitions the
reference's step.

Held, at ``test_torch_tensor_parallel.py``'s and
``test_torch_sharded_serve.py``'s bounds: three train steps against the
port's one-device step at the same parameters and optimizer state (loss
1e-5, grad norm 1e-4, each gradient leaf 1e-4 of its largest entry; the
first loss 1e-5 of the reference's ``Model.loss``); the sharded prefill,
``seed_cache`` and 6 greedy decode steps against the reference's
``Model.prefill``, its engine's cache seeding and ``Model.decode`` (tokens
identical, logits 1e-5 of the largest, each rank's prefill and decode cache
shard 1e-6 of the reference's slice).  Beside them: a split group's ``keep``
mask and capacity positions bit for bit against the reference's lines on
the whole group, and the autograd all-to-all's gradient against its
adjoint.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from test_torch_distributed import check_tables, rel, smoke_cfg, spawn, table_specs  # noqa: E402

CASES = {  # name: (arch, mesh shape, profile, config changes, train (B, S), serve (B, P, T))
    "dbrx-2x2": ("dbrx-132b", (2, 2), "baseline", {}, (4, 64), (4, 8, 16)),
    "dbrx-1x4": ("dbrx-132b", (1, 4), "baseline", {}, (4, 64), (4, 8, 16)),
    "mixtral-1x4": ("mixtral-8x22b", (1, 4), "baseline", {}, (4, 64), (4, 40, 48)),
    "mixtral-ep-1x2x2": ("mixtral-8x22b", (1, 2, 2), "moe_ep", {}, (4, 64), (4, 40, 48)),
    "mixtral-e6-1x4": ("mixtral-8x22b", (1, 4), "baseline", {"n_experts": 6}, (4, 64),
                       (4, 40, 48)),
    "mixtral-ep-kv4-1x2x2": ("mixtral-8x22b", (1, 2, 2), "moe_ep", {"n_kv_heads": 4}, (4, 64),
                             (4, 40, 48)),
    "dbrx-2x2-s512": ("dbrx-132b", (2, 2), "baseline", {}, (2, 512), (2, 512, 520)),
    "mixtral-ep-1x2x2-s512": ("mixtral-8x22b", (1, 2, 2), "moe_ep", {}, (2, 512),
                              (2, 512, 520)),
    "dbrx-serve-2x2": ("dbrx-132b", (2, 2), "serve", {}, (4, 64), (4, 8, 16)),
    "mixtral-serve-2x2": ("mixtral-8x22b", (2, 2), "serve", {}, (4, 64), (4, 40, 48)),
    "dbrx-opt1-2x2": ("dbrx-132b", (2, 2), "opt1", {}, (4, 64), (4, 8, 16)),
    "mixtral-serve-kv4-b1-2x2": ("mixtral-8x22b", (2, 2), "serve", {"n_kv_heads": 4},
                                 (4, 64), (1, 40, 48)),
    # one row under the baseline: the row leaves data whole, so the decode
    # plan keeps every weight (the router's and the experts' too) on its data
    # shard and moves the token (mixtral's prompt wraps the window's ring)
    "dbrx-b1-2x2": ("dbrx-132b", (2, 2), "baseline", {}, (4, 64), (1, 8, 16)),
    "mixtral-b1-2x2": ("mixtral-8x22b", (2, 2), "baseline", {}, (4, 64), (1, 40, 48)),
    "mixtral-b1-e6-2x2": ("mixtral-8x22b", (2, 2), "baseline", {"n_experts": 6}, (4, 64),
                          (1, 40, 48)),
}
# the one-row cases' decode plans keep the weights on their data shards
STATIONARY = {"dbrx-b1-2x2": ("data",), "mixtral-b1-2x2": ("data",),
              "mixtral-b1-e6-2x2": ("data",)}
PLANS = {  # name: (expert axes, the experts' hidden-column axes, the train stream's sequence)
    "dbrx-2x2": (("model",), (), ("model",)),
    "dbrx-1x4": (("model",), (), ("model",)),
    "mixtral-1x4": (("model",), (), ("model",)),
    "mixtral-ep-1x2x2": (("expert",), ("tp",), ("expert", "tp")),
    "mixtral-e6-1x4": ((), ("model",), ("model",)),
    "mixtral-ep-kv4-1x2x2": (("expert",), ("tp",), ("expert", "tp")),
    "dbrx-2x2-s512": (("model",), (), ("model",)),
    "mixtral-ep-1x2x2-s512": (("expert",), ("tp",), ("expert", "tp")),
    "dbrx-serve-2x2": (("model",), ("data",), ()),
    "mixtral-serve-2x2": (("model",), ("data",), ()),
    "dbrx-opt1-2x2": (("model",), (), ("model",)),
    "mixtral-serve-kv4-b1-2x2": (("model",), ("data",), ()),
    "dbrx-b1-2x2": (("model",), (), ("model",)),
    "mixtral-b1-2x2": (("model",), (), ("model",)),
    "mixtral-b1-e6-2x2": (("model",), (), ("model",)),
}
STEPS, NEW = 3, 6
# the keep-mask probe: (B, S) tokens on (1, 4), groups of 64 (one over every
# rank) and of 32 (each over two ranks), K of E experts, C slots an expert
SLOTS = dict(B=3, S=64, K=2, E=4, C=12)


def axes_of(shape) -> tuple[str, ...]:
    return ("data", "model") if len(shape) == 2 else ("data", "expert", "tp")


def model_key(arch: str, kw: dict) -> str:
    return arch + "".join(f"-{k}{v}" for k, v in sorted(kw.items()))


def prompts_for(vocab: int, B: int, P: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (B, P)).astype(np.int32)


def slots_mask() -> np.ndarray:
    """Random top-K one-hot choices (B, S, K, E), distinct experts a token."""
    rng = np.random.default_rng(11)
    B, S, K, E = (SLOTS[k] for k in "BSKE")
    idx = np.argsort(rng.random((B, S, E)), axis=-1)[..., :K]
    return np.eye(E, dtype=np.float32)[idx]


def serve_one_device(model, params, tokens, T: int) -> dict:
    """The port's one-device prefill, the engine's cache seeding (the ring
    slots of ``ring_positions``) and NEW greedy decode steps: the prefill's
    and the final decode cache's leaves (sorted order) and every step's
    logits."""
    from repro_torch.launch.steps import DecodeStep, PrefillStep, ring_positions
    from repro_torch.models.common import init_params, sorted_leaves
    P = tokens.shape[1]
    pcache, logits = PrefillStep(model)(params, {"tokens": tokens})
    cache = init_params(model.cache_specs(tokens.shape[0], T), None, "cpu")
    for pos, entry in cache.items():
        for n, dst in entry.items():
            where = ring_positions(P, dst.shape[2], model.cfg.window)
            held = where >= 0
            dst[:, :, held] = pcache[pos][n][:, :, where[held]]
    dec, steps = DecodeStep(model), [logits]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    for i in range(NEW):
        tok, logits, cache = dec(params, cache, {"tokens": tok[:, None], "pos": P + i})
        steps.append(logits)
    return dict(prefill=sorted_leaves(pcache), decode=sorted_leaves(cache), steps=steps)


def moe_rank_job(rank, world, init, tmp, weights):
    """Every case on one 4-rank gloo group: three train steps, each beside
    the one-device step from the parameters and optimizer state the sharded
    step holds, gathered whole; then prefill, ``seed_cache`` and NEW greedy
    decode steps, with this rank's cache shards.  Then the keep-mask probe
    and the all-to-all's adjoint."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.interop import params_onto_mesh
    from repro_torch.launch.steps import (build_decode, build_prefill, build_train,
                                          input_shardings, seed_cache)
    from repro_torch.models import build
    from repro_torch.models.common import sharding_profile, sorted_leaves
    from repro_torch.models.moe import slots
    from repro_torch.models.tensor_parallel import plan_train
    from repro_torch.optim import AdamWState
    from repro_torch.optim.adamw import tree_map_sorted
    from repro_torch.substrate import (all_to_all_over, full_value, gather_full, init_group,
                                       make_mesh)
    torch.set_num_threads(1)
    init_group("gloo", rank, world, init)

    def whole(tree):
        return tree_map_sorted(lambda t: full_value(t).clone(), tree)

    def shards(cache, sh):
        return [(x.to_local().clone(), s.spec) for x, s in zip(sorted_leaves(cache),
                                                                 sorted_leaves(sh))]
    out = {}
    for name, (arch, shape, profile, kw, (B, S), (Bs, P, T)) in CASES.items():
        cfg = smoke_cfg(arch, **kw)
        model = build(cfg)
        cell = ShapeCell("smoke", S, B, "train")
        data = SyntheticLM(DataConfig(cfg.vocab, S, B, 0))
        one, one_opt, _ = build_train(model, None, 10, 5e-3)
        rows = []
        with sharding_profile(profile):
            mesh = make_mesh(shape, axes_of(shape), device_type="cpu")
            step, opt, sh = build_train(model, mesh, 10, 5e-3)
            params = params_onto_mesh(weights[model_key(arch, kw)], sh["params"])
            state = opt.init(params)
            in_sh = input_shardings(model.input_specs(cell), mesh)
            for i in range(STEPS):
                p1 = whole(params)
                s1 = AdamWState(full_value(state.count).clone(), whole(state.m), whole(state.v))
                loss1, grads1 = one.loss_and_grads(p1, data.device_batch(i, "cpu"))
                _, _, gn1 = one_opt.update(grads1, s1, p1)
                batch = data.sharded_batch(i, in_sh)
                _, grads = step.loss_and_grads(params, batch)
                params, state, m = step(params, state, batch)
                rows.append(dict(
                    loss=(float(m["loss"]), float(loss1)),
                    grad_norm=(float(m["grad_norm"]), float(gn1)),
                    grad_leaf=max(rel(full_value(g), w) for g, w in
                                  zip(sorted_leaves(grads), sorted_leaves(grads1)))))
            (tp, _, _), = step._plans.values()

            fwd, psh = build_prefill(model, mesh)
            dec, dsh = build_decode(model, mesh, ShapeCell("serve", T, Bs, "decode"))
            params = params_onto_mesh(weights[model_key(arch, kw)], psh["params"])
            tokens = torch.as_tensor(prompts_for(cfg.vocab, Bs, P))
            pcache, logits = fwd(params, {"tokens": tokens})
            logits = gather_full(logits)
            prefill_shards = shards(pcache, fwd.plan(tokens)[2])
            cache = seed_cache(pcache, dsh["cache"], T, cfg.window)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            steps = [(logits, tok)]
            for i in range(NEW):
                tok, logits, cache = dec(params, cache, {"tokens": tok[:, None], "pos": P + i})
                logits = gather_full(logits)
                steps.append((logits, tok))
            (plan, _), = dec._plans.values()
            one_device = serve_one_device(model, whole(params), tokens, T)
        out[name] = dict(train=rows, steps=steps, prefill=prefill_shards,
                         decode=shards(cache, dsh["cache"]),
                         one_device=one_device if rank == 0 else None,
                         coords=dict(zip(axes_of(shape), mesh.get_coordinate())),
                         plan=(tp.expert_axes, tp.expert_ffn_axes, tp.seq_axes),
                         stationary=plan.stationary_axes,
                         tables=table_specs(sh["params"]))

    # a split group's keep mask and positions: this rank's 16 tokens of each row
    B, S, K, E, C = (SLOTS[k] for k in "BSKEC")
    mesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
    tp = plan_train(smoke_cfg("dbrx-132b"), build(smoke_cfg("dbrx-132b")).specs(), mesh, (B, S))
    mask = torch.as_tensor(slots_mask())[:, rank * S // 4:(rank + 1) * S // 4]
    got = {}
    for gs in (64, 32):
        share = gs // (S // 4)
        m = mask[:, None]                                              # (B, 1, 16, K, E)
        before = tp.group_before(m.sum((2, 3))[:, :, None], share)
        got[gs] = slots(m, C, before)
    out["slots"] = got

    # the all-to-all over (data, model) against its adjoint: <y, g> = <x, dx>
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn(3, 8, 5, 2, generator=gen, dtype=torch.float64, requires_grad=True)
    g = torch.randn(3, 2, 20, 2, generator=gen, dtype=torch.float64)
    y = all_to_all_over(x, mesh, ("data", "model"), 1, 2)
    dx, = torch.autograd.grad(y, x, g)
    back = all_to_all_over(y.detach(), mesh, ("data", "model"), 1, 2, reverse=True)
    # chunk j of x's dimension 1 goes to the rank at chunk index j = 2 * data + model
    j = 2 * mesh.get_local_rank("data") + mesh.get_local_rank("model")
    every = [torch.randn(3, 8, 5, 2, generator=torch.Generator().manual_seed(r),
                         dtype=torch.float64) for r in range(4)]
    want = torch.cat([e[:, 2 * j:2 * j + 2] for e in every], 2)
    out["a2a"] = dict(shape=tuple(y.shape), y_g=float((y * g).sum()),
                      x_dx=float((x * dx).sum()), round_trip=bool(back.equal(x.detach())),
                      chunks=bool(y.detach().equal(want)),
                      dx_reverse=bool(dx.equal(all_to_all_over(g, mesh, ("data", "model"),
                                                               1, 2, reverse=True))))
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """Per model: the reference's ``Model.init`` weights (seed 0) in float32
    compute; per case its ``Model.loss`` on the first train batch, and its
    greedy serving run: the prefill's logits and cache, the cache seeded as
    its engine seeds it (``Engine._seed_cache``), NEW ``Model.decode`` steps'
    logits and tokens, and the final cache."""
    import jax
    import jax.numpy as jnp
    import repro.configs as JC
    from repro.models import build as jbuild
    from repro.serve.engine import Engine
    from repro_torch.data import DataConfig, SyntheticLM
    weights, cases = {}, {}
    for name, (arch, _, _, kw, (B, S), (Bs, P, T)) in CASES.items():
        jcfg = dataclasses.replace(JC.get(arch, smoke=True), compute_dtype="float32", **kw)
        model = jbuild(jcfg)
        key = model_key(arch, kw)
        if key not in weights:
            weights[key] = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
        params = weights[key]
        batch = SyntheticLM(DataConfig(jcfg.vocab, S, B, 0)).batch(0)
        loss = float(model.loss(params, {k: jnp.asarray(v) for k, v in batch.items()}))
        pcache, logits = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(
            prompts_for(jcfg.vocab, Bs, P))})
        cache = Engine(jcfg, params)._seed_cache(pcache, Bs, T, P)
        dec = jax.jit(model.decode)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        steps = [(np.asarray(logits), np.asarray(tok))]
        for i in range(NEW):
            logits, cache = dec(params, cache, tok[:, None], jnp.int32(P + i))
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            steps.append((np.asarray(logits), np.asarray(tok)))
        cases[name] = dict(loss=loss, steps=steps,
                           prefill=[np.asarray(x) for x in jax.tree.leaves(pcache)],
                           decode=[np.asarray(x) for x in jax.tree.leaves(cache)])
    return weights, cases


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    return spawn(moe_rank_job, 4, tmp, reference[0], timeout=600.0)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_train_step_matches_one_device_step(ranks, reference, name):
    """Three steps from the reference's weights: on every rank the sharded
    step's loss, grad norm and gradients (each leaf) against the one-device
    step's at the same parameters and optimizer state, and the first loss
    against the reference's; the plan takes the branch the case names."""
    ref = reference[1][name]
    arch, shape, profile, kw = CASES[name][:4]
    rows = [row for r in ranks for row in r[name]["train"]]
    print(name, {k: max(abs(row[k][0] - row[k][1]) / abs(row[k][1]) for row in rows)
                 for k in ("loss", "grad_norm")}, max(row["grad_leaf"] for row in rows))
    for r in ranks:
        got = r[name]
        assert got["plan"] == PLANS[name]
        check_tables(got["tables"], arch, axes_of(shape), shape, profile, **kw)
        assert abs(got["train"][0]["loss"][1] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        for row in got["train"]:
            (gl, wl), (gn, wn) = row["loss"], row["grad_norm"]
            assert abs(gl - wl) <= 1e-5 * abs(wl) and abs(gn - wn) <= 1e-4 * abs(wn), row
            assert row["grad_leaf"] <= 1e-4, row
        assert [s["loss"][0] for s in got["train"]] == \
            [s["loss"][0] for s in ranks[0][name]["train"]]


def _slice_err(local, spec, full, coords, shape) -> float:
    from repro_torch.substrate import local_slices
    sizes = dict(zip(axes_of(shape), shape))
    want = full[local_slices(full.shape, spec, sizes, coords)]
    assert tuple(local.shape) == want.shape
    return rel(local, want)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_sharded_serve_matches_reference(ranks, reference, name):
    """Prefill, ``seed_cache`` and NEW greedy decode steps on the mesh: on
    every rank the tokens equal the reference's and the logits lie within
    1e-5 of its largest; each rank's prefill and decode cache shards within
    1e-6 of the matching slices of the port's one-device caches (the mixtral
    prompts wrap the window's ring), and of the reference's within 1e-6
    beyond the one-device caches' own distance from them.  That distance is
    float32 rounding (XLA's products and PyTorch's on the CPU; 0.9e-6 on
    dbrx smoke's decode cache, 1.1e-6 on mixtral smoke's), so the
    reference's caches alone cannot hold the shards to 1e-6."""
    shape = CASES[name][1]
    ref = reference[1][name]
    one = ranks[0][name]["one_device"]
    floor = {kind: max(rel(a, b) for a, b in zip(one[kind], ref[kind]))
             for kind in ("prefill", "decode")}
    errs = {"logits": 0.0, "prefill": 0.0, "decode": 0.0, "prefill_one": 0.0, "decode_one": 0.0}
    for r in ranks:
        got = r[name]
        # the one-row cases' rows leave data whole; the others' no embed axis
        assert got["stationary"] == STATIONARY.get(name, ())
        for (lg, tok), (wl, wt) in zip(got["steps"], ref["steps"]):
            assert tuple(lg.shape) == wl.shape
            assert np.array_equal(tok.numpy(), wt)
            errs["logits"] = max(errs["logits"], rel(lg, wl))
        for kind in ("prefill", "decode"):
            assert len(got[kind]) == len(ref[kind]) == len(one[kind])
            for (local, spec), full, mine in zip(got[kind], ref[kind], one[kind]):
                errs[kind] = max(errs[kind], _slice_err(local, spec, full, got["coords"], shape))
                errs[f"{kind}_one"] = max(errs[f"{kind}_one"], _slice_err(
                    local, spec, mine.numpy(), got["coords"], shape))
    print(name, errs, "one device from the reference", floor)
    assert errs["logits"] <= 1e-5, errs
    for kind in ("prefill", "decode"):
        assert errs[f"{kind}_one"] <= 1e-6 and errs[kind] <= floor[kind] + 1e-6, (errs, floor)


@pytest.mark.parametrize("gs", [64, 32])
def test_split_group_keep_mask_matches_reference(ranks, gs):
    """A token group split over the 4 ranks of (1, 4) (64 tokens, one group
    over all of them; 32, each group over two): every rank's ``keep`` mask
    and capacity positions, from its share of the choices and the group's
    earlier ranks' counts, equal the reference's (``moe.py``'s cumulative
    count over the whole group, in JAX) on its tokens bit for bit, with some
    tokens dropped past capacity."""
    import jax.numpy as jnp
    B, S, K, E, C = (SLOTS[k] for k in "BSKEC")
    mask = jnp.asarray(slots_mask()).reshape(B, S // gs, gs, K, E)
    # the reference's lines, src/repro/models/moe.py
    flat = mask.reshape(B, S // gs, gs * K, E)
    pos = (jnp.cumsum(flat, axis=2) - 1.0).reshape(B, S // gs, gs, K, E)
    keep = (pos < C) & (mask > 0)
    pos = jnp.clip(pos, 0, C - 1).astype(jnp.int32)
    keep, pos = (np.asarray(t).reshape(B, S, K, E) for t in (keep, pos))
    assert not keep.sum() == mask.sum()          # capacity drops some choices
    for rank, r in enumerate(ranks):
        got_keep, got_pos = (t.numpy().reshape(B, S // 4, K, E) for t in r["slots"][gs])
        own = slice(rank * S // 4, (rank + 1) * S // 4)
        assert np.array_equal(got_keep, keep[:, own])
        assert np.array_equal(got_pos, pos[:, own])


def test_all_to_all_gradient_is_its_adjoint(ranks):
    """``all_to_all_over`` over (data, model) on (2, 2), float64: the rank
    at chunk index j (data major) holds chunk j of every rank's x, joined in
    rank order; summed over the ranks, <y, g> equals <x, dx> (the backward
    is the adjoint); dx is the reverse all-to-all of g, and the reverse of y
    gives x back."""
    assert all(r["a2a"]["shape"] == (3, 2, 20, 2) for r in ranks)
    assert all(r["a2a"]["chunks"] and r["a2a"]["round_trip"] and r["a2a"]["dx_reverse"]
               for r in ranks)
    y_g = sum(r["a2a"]["y_g"] for r in ranks)
    x_dx = sum(r["a2a"]["x_dx"] for r in ranks)
    assert abs(y_g - x_dx) <= 1e-12 * abs(y_g), (y_g, x_dx)
