"""The hybrid (jamba) and the VLM (qwen2-vl) on a mesh: the planned
``ShardedTrainStep``, ``PrefillStep``, ``seed_cache`` and ``DecodeStep``
(``models.tensor_parallel`` through the stack whose attention, MLP, MoE and
SSD blocks already run on a plan) on a gloo group of 4 spawned CPU ranks,
from the reference's weights (``Model.init``, carried over by
``params_onto_mesh``), in float32.

Cases: jamba smoke (8 layers: 6 SSM, 2 attention, 4 MoE of 4 experts) and
qwen2-vl smoke (M-RoPE sections (2, 3, 3), fed seeded ``embeds`` and (3, B,
S) positions whose three rows differ, as an image grid's (temporal, h, w)
do) on (data 1, model 4) and (2, 2) under the baseline profile and on (2,
2) under ``serve`` and under ``opt1`` (the (un)embedding tables whole over
``data``, as the reference's ``resolve_spec`` lays them out).  Prompts of 8, 40 and 64 tokens seeded into decode
caches of 16, 46 and 72 positions: 46 does not divide 4, so on (1, 4) the
decode cache is whole where the prefill's is split over ``model``, and
``seed_cache`` moves the rows from the one split into the other.  Beside
them, granite smoke's prompt of 40 into 46 positions on (1, 4), the dense
family's case of the same move; and jamba and qwen2-vl smoke (its M-RoPE
positions too) serving one row (the first prompt) on (2, 2) under the
baseline (``ONE_ROW``): the row leaves ``data`` whole, so the decode plan
keeps every weight on its embed shard there (``stationary_axes``) and
moves the token; the cases of SERVE_B rows keep none.

Held, at ``test_torch_ssm_parallel.py``'s bounds: three train steps against
the port's one-device step at the same parameters and optimizer state (loss
1e-5, grad norm 1e-4, each gradient leaf 1e-4 of its largest entry; the
first loss 1e-5 of the reference's ``Model.loss``); the sharded prefill,
``seed_cache`` and 6 greedy decode steps against the reference's
``Model.prefill``, its engine's cache seeding (the VLM's: the same, by hand,
as neither engine serves a VLM) and ``Model.decode`` with the positions
(tokens identical, logits 1e-5 of the largest; every rank's prefill and
final decode cache shards within 1e-6 a layer of the model's depth of the
port's one-device caches' slices, and of the reference's within as much
beyond the one-device caches' own distance from them: float32 sums in
another order, whose rounding grows with depth, from 0 in jamba's first
layer to 4.5e-6 in its eighth).  The decode plan reads the cache's length from an attention
leaf (jamba's first leaf is an SSM block's conv history).  And a fake
8-rank trace of each smoke model's cells under both profiles: product
FLOPs equal to the hand counts (``hand_*_flops``, by the layer pattern),
and no all-gather above a rank's working layouts, its cache shards or its
rows' gathered sequence.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from test_torch_distributed import check_tables, rel, smoke_cfg, spawn, table_specs  # noqa: E402

ARCHS = {"jamba": "jamba-v0.1-52b", "qwen2vl": "qwen2-vl-72b"}
MESHES = {"1x4": ((1, 4), "baseline"), "2x2": ((2, 2), "baseline"),
          "serve-2x2": ((2, 2), "serve"), "opt1-2x2": ((2, 2), "opt1")}
CASES = {f"{a}-{m}": (arch, shape, profile)
         for a, arch in ARCHS.items() for m, (shape, profile) in MESHES.items()}
# the decode cache's sequence split over model, whole, and over model; the
# attention heads, the SSM heads and the experts as each case's plan lays them out
PLANS = {  # name: (cache rows beyond the stream's, cache sequence, SSM heads, experts)
    "jamba-1x4": ({16: (), 46: (), 72: ()}, {16: ("model",), 46: (), 72: ("model",)},
                  ("model",), ("model",)),
    "jamba-2x2": ({16: (), 46: (), 72: ()},
                  {16: ("model",), 46: ("model",), 72: ("model",)}, ("model",), ("model",)),
    "jamba-serve-2x2": ({16: ("data",), 46: ("data",), 72: ("data",)},
                        {16: ("model",), 46: ("model",), 72: ("model",)}, ("model",),
                        ("model",)),
    "qwen2vl-1x4": ({16: (), 46: (), 72: ()}, {16: ("model",), 46: (), 72: ("model",)}, (), ()),
    "qwen2vl-2x2": ({16: (), 46: (), 72: ()},
                    {16: ("model",), 46: ("model",), 72: ("model",)}, (), ()),
    "qwen2vl-serve-2x2": ({16: ("data",), 46: ("data",), 72: ("data",)},
                          {16: ("model",), 46: ("model",), 72: ("model",)}, (), ()),
    "jamba-opt1-2x2": ({16: (), 46: (), 72: ()},
                       {16: ("model",), 46: ("model",), 72: ("model",)}, ("model",),
                       ("model",)),
    "qwen2vl-opt1-2x2": ({16: (), 46: (), 72: ()},
                         {16: ("model",), 46: ("model",), 72: ("model",)}, (), ()),
}
ONE_ROW = {"jamba-b1-2x2": ("jamba-v0.1-52b", (2, 2), "baseline"),
           "qwen2vl-b1-2x2": ("qwen2-vl-72b", (2, 2), "baseline")}
TRAIN = (4, 64)                    # (B, S)
PROMPTS = {8: 16, 40: 46, 64: 72}  # prompt: decode cache positions
SERVE_B, NEW, STEPS = 4, 6, 3
SEED_ARCH, SEED_MESH, SEED_P = "granite-3-8b", (1, 4), 40
CACHE_RTOL_PER_LAYER = 1e-6


def prompts_for(vocab: int, P: int) -> np.ndarray:
    return np.random.default_rng(7 + P).integers(0, vocab, (SERVE_B, P)).astype(np.int32)


def grid_positions(B: int, S: int) -> np.ndarray:
    """(3, B, S) M-RoPE positions of a stream of 4 x 4 patches a frame: the
    frame (temporal), the patch's row (h) and column (w), each row of the
    batch offset by its index, so the three rows differ."""
    s = np.arange(S)
    grid = np.stack([s // 16, s // 16 + (s % 16) // 4, s // 16 + s % 4])
    return (grid[:, None, :] + np.arange(B)[None, :, None]).astype(np.int32)


def embeds_for(cfg, B: int, S: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def train_batch(cfg, i: int) -> dict:
    """Train batch ``i`` as numpy arrays: the synthetic tokens and labels, or
    for the VLM seeded embeds, the labels and the grid's positions."""
    from repro_torch.data import DataConfig, SyntheticLM
    B, S = TRAIN
    batch = SyntheticLM(DataConfig(cfg.vocab, S, B, 0)).batch(i)
    if cfg.family != "vlm":
        return batch
    return {"embeds": embeds_for(cfg, B, S, 100 + i), "labels": batch["labels"],
            "positions": grid_positions(B, S)}


def prefill_inputs(cfg, P: int, rows: int = SERVE_B) -> dict:
    """The first ``rows`` of the SERVE_B prompts of length P."""
    if cfg.family != "vlm":
        return {"tokens": prompts_for(cfg.vocab, P)[:rows]}
    return {"embeds": embeds_for(cfg, SERVE_B, P, 200 + P)[:rows],
            "positions": np.ascontiguousarray(grid_positions(SERVE_B, P)[:, :rows])}


def decode_positions(cfg, P: int, i: int, rows: int = SERVE_B):
    """The (3, rows, 1) positions of decode step ``i`` (the grid continued),
    or None for a model without M-RoPE."""
    if cfg.family != "vlm":
        return None
    return np.ascontiguousarray(grid_positions(SERVE_B, P + NEW)[:, :rows, P + i:P + i + 1])


def serve_one_device(model, params, P: int, T: int, rows: int = SERVE_B) -> dict:
    """The port's one-device prefill, the decode cache seeded as its engine
    seeds it, NEW greedy decode steps: the prefill's and the final decode
    cache's leaves (sorted order)."""
    from repro_torch.launch.steps import DecodeStep, PrefillStep
    from repro_torch.models.common import sorted_leaves
    from repro_torch.serve.engine import Engine
    cfg = model.cfg
    pcache, logits = PrefillStep(model)(params, {k: torch.as_tensor(v) for k, v in
                                                 prefill_inputs(cfg, P, rows).items()})
    prefill = [t.clone() for t in sorted_leaves(pcache)]
    cache = Engine(cfg, params=params, device="cpu")._seed_cache(pcache, rows, T, P)
    dec = DecodeStep(model)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    for i in range(NEW):
        inputs = {"tokens": tok[:, None], "pos": P + i}
        if (pos := decode_positions(cfg, P, i, rows)) is not None:
            inputs["positions"] = torch.as_tensor(pos)
        tok, logits, cache = dec(params, cache, inputs)
    return dict(prefill=prefill, decode=sorted_leaves(cache))


def serve_on_mesh(model, mesh, params, P: int, T: int, one_device, rows: int = SERVE_B) -> dict:
    """The sharded prefill of ``rows`` prompts, ``seed_cache`` into T
    positions and NEW greedy decode steps: each step's logits and tokens,
    this rank's prefill and final decode cache shards with their specs, the
    decode plan's cache layout and stationary axes, and (``one_device``:
    rank 0) the one-device run's caches."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.steps import build_decode, build_prefill, seed_cache
    from repro_torch.models.common import sorted_leaves
    from repro_torch.optim.adamw import tree_map_sorted
    from repro_torch.substrate import full_value, gather_full

    def shards(cache, sh):
        return [(x.to_local().clone(), s.spec) for x, s in zip(sorted_leaves(cache),
                                                                 sorted_leaves(sh))]
    cfg = model.cfg
    fwd, _ = build_prefill(model, mesh)
    dec, dsh = build_decode(model, mesh, ShapeCell("serve", T, rows, "decode"))
    inputs = {k: torch.as_tensor(v) for k, v in prefill_inputs(cfg, P, rows).items()}
    pcache, logits = fwd(params, inputs)
    logits = gather_full(logits)
    prefill_shards = shards(pcache, fwd.plan(next(iter(inputs.values())))[2])
    cache = seed_cache(pcache, dsh["cache"], T)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    steps = [(logits, tok)]
    for i in range(NEW):
        step_in = {"tokens": tok[:, None], "pos": P + i}
        if (pos := decode_positions(cfg, P, i, rows)) is not None:
            step_in["positions"] = torch.as_tensor(pos)
        tok, logits, cache = dec(params, cache, step_in)
        logits = gather_full(logits)
        steps.append((logits, tok))
    (tp, _), = dec._plans.values()
    every = tree_map_sorted(lambda t: full_value(t).clone(), params)   # a collective: every rank
    return dict(steps=steps, prefill=prefill_shards, decode=shards(cache, dsh["cache"]),
                planned=bool(fwd._plans) and bool(dec._plans),
                plan=(tp.cache_row_axes, tp.cache_seq_axes, tp.stationary_axes),
                one_device=serve_one_device(model, every, P, T, rows) if one_device else None)


def rank_job(rank, world, init, tmp, weights):
    """Every case on one 4-rank gloo group: three train steps, each beside
    the one-device step from the parameters and optimizer state the sharded
    step holds, gathered whole; then per prompt length the sharded serving
    run (:func:`serve_on_mesh`).  Then the one-row cases' serving runs, and
    granite smoke's prompt of 40 into 46 positions on (1, 4)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.interop import params_onto_mesh
    from repro_torch.launch.steps import build_prefill, build_train, input_shardings
    from repro_torch.models import build
    from repro_torch.models.common import sharding_profile, sorted_leaves
    from repro_torch.optim import AdamWState
    from repro_torch.optim.adamw import tree_map_sorted
    from repro_torch.substrate import distribute, full_value, init_group, make_mesh
    torch.set_num_threads(1)
    init_group("gloo", rank, world, init)
    B, S = TRAIN

    def whole(tree):
        return tree_map_sorted(lambda t: full_value(t).clone(), tree)
    out = {}
    for name, (arch, shape, profile) in CASES.items():
        cfg = smoke_cfg(arch)
        model = build(cfg)
        cell = ShapeCell("smoke", S, B, "train")
        one, one_opt, _ = build_train(model, None, 10, 5e-3)
        rows = []
        with sharding_profile(profile):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            step, opt, sh = build_train(model, mesh, 10, 5e-3)
            params = params_onto_mesh(weights[arch], sh["params"])
            state = opt.init(params)
            in_sh = input_shardings(model.input_specs(cell), mesh)
            for i in range(STEPS):
                host = train_batch(cfg, i)
                p1 = whole(params)
                s1 = AdamWState(full_value(state.count).clone(), whole(state.m), whole(state.v))
                loss1, grads1 = one.loss_and_grads(p1, {k: torch.as_tensor(v)
                                                        for k, v in host.items()})
                _, _, gn1 = one_opt.update(grads1, s1, p1)
                batch = {k: distribute(torch.as_tensor(v), in_sh[k]) for k, v in host.items()}
                _, grads = step.loss_and_grads(params, batch)
                params, state, m = step(params, state, batch)
                rows.append(dict(
                    loss=(float(m["loss"]), float(loss1)),
                    grad_norm=(float(m["grad_norm"]), float(gn1)),
                    grad_leaf=max(rel(full_value(g), w) for g, w in
                                  zip(sorted_leaves(grads), sorted_leaves(grads1)))))
            (tp, _, _), = step._plans.values()
            _, psh = build_prefill(model, mesh)
            params = params_onto_mesh(weights[arch], psh["params"])
            serve = {P: serve_on_mesh(model, mesh, params, P, T, rank == 0)
                     for P, T in PROMPTS.items()}
        out[name] = dict(train=rows, serve=serve, planned=bool(step._plans),
                         coords=dict(zip(("data", "model"), mesh.get_coordinate())),
                         plan=(tp.ssm_head_axes, tp.expert_axes),
                         tables=table_specs(sh["params"]))
    for name, (arch, shape, profile) in ONE_ROW.items():
        model = build(smoke_cfg(arch))
        with sharding_profile(profile):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            _, psh = build_prefill(model, mesh)
            params = params_onto_mesh(weights[arch], psh["params"])
            out[name] = dict(serve={P: serve_on_mesh(model, mesh, params, P, T, rank == 0, 1)
                                    for P, T in PROMPTS.items()},
                             coords=dict(zip(("data", "model"), mesh.get_coordinate())))

    model = build(smoke_cfg(SEED_ARCH))
    mesh = make_mesh(SEED_MESH, ("data", "model"), device_type="cpu")
    _, psh = build_prefill(model, mesh)
    params = params_onto_mesh(weights[SEED_ARCH], psh["params"])
    out["seed"] = serve_on_mesh(model, mesh, params, SEED_P, PROMPTS[SEED_P], rank == 0)
    out["seed"]["coords"] = dict(zip(("data", "model"), mesh.get_coordinate()))
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def _reference_run(model, params, jcfg, P: int, T: int, rows: int = SERVE_B) -> dict:
    """The reference's greedy serving run of ``rows`` prompts:
    ``Model.prefill``, the cache seeded as its engine seeds it
    (``Engine._seed_cache``; the VLM's the same by hand, k and v at [0, P),
    as no engine serves a VLM), NEW ``Model.decode`` steps with the
    positions; the steps' logits and tokens, the prefill's and the final
    cache's leaves."""
    import jax
    import jax.numpy as jnp
    from repro.serve.engine import Engine
    batch = {k: jnp.asarray(v) for k, v in prefill_inputs(jcfg, P, rows).items()}
    pcache, logits = jax.jit(model.prefill)(params, batch)
    if jcfg.family == "vlm":
        cache = jax.tree.map(lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, T - P), (0, 0), (0, 0))),
                             pcache)
    else:
        cache = Engine(jcfg, params)._seed_cache(pcache, rows, T, P)
    dec = jax.jit(model.decode)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    steps = [(np.asarray(logits), np.asarray(tok))]
    for i in range(NEW):
        pos = decode_positions(jcfg, P, i, rows)
        logits, cache = dec(params, cache, tok[:, None], jnp.int32(P + i),
                            None if pos is None else jnp.asarray(pos))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        steps.append((np.asarray(logits), np.asarray(tok)))
    return dict(steps=steps, prefill=[np.asarray(x) for x in jax.tree.leaves(pcache)],
                decode=[np.asarray(x) for x in jax.tree.leaves(cache)])


@pytest.fixture(scope="module")
def reference():
    """Per architecture (and granite smoke): the reference's ``Model.init``
    weights (seed 0) in float32 compute, its ``Model.loss`` on the first
    train batch and its greedy serving run per prompt length (of the first
    row alone too, ``one_row``, where a ``ONE_ROW`` case serves it)."""
    import jax
    import jax.numpy as jnp
    import repro.configs as JC
    from repro.models import build as jbuild
    out = {}
    for arch in (*ARCHS.values(), SEED_ARCH):
        jcfg = dataclasses.replace(JC.get(arch, smoke=True), compute_dtype="float32")
        model = jbuild(jcfg)
        params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
        if arch == SEED_ARCH:
            out[arch] = dict(params=params, serve={SEED_P: _reference_run(
                model, params, jcfg, SEED_P, PROMPTS[SEED_P])})
            continue
        loss = float(model.loss(params, {k: jnp.asarray(v)
                                         for k, v in train_batch(jcfg, 0).items()}))
        out[arch] = dict(params=params, loss=loss,
                         serve={P: _reference_run(model, params, jcfg, P, T)
                                for P, T in PROMPTS.items()})
        if any(a == arch for a, _, _ in ONE_ROW.values()):
            out[arch]["one_row"] = {P: _reference_run(model, params, jcfg, P, T, 1)
                                    for P, T in PROMPTS.items()}
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid_vlm")
    return spawn(rank_job, 4, tmp, {a: r["params"] for a, r in reference.items()},
                 timeout=900.0)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_one_device_step(ranks, reference, name):
    """Three steps from the reference's weights: on every rank the planned
    step's loss, grad norm and gradients (each leaf) against the one-device
    step's at the same parameters and optimizer state, and the first loss
    against the reference's; the plan splits the SSM heads and the experts
    as the case names."""
    arch = CASES[name][0]
    rows = [row for r in ranks for row in r[name]["train"]]
    print(name, {k: max(abs(row[k][0] - row[k][1]) / abs(row[k][1]) for row in rows)
                 for k in ("loss", "grad_norm")}, max(row["grad_leaf"] for row in rows))
    want = reference[arch]["loss"]
    for r in ranks:
        got = r[name]
        assert got["planned"]
        assert got["plan"] == PLANS[name][2:]
        check_tables(got["tables"], arch, ("data", "model"), *CASES[name][1:])
        assert abs(got["train"][0]["loss"][1] - want) <= 1e-5 * abs(want)
        for row in got["train"]:
            (gl, wl), (gn, wn) = row["loss"], row["grad_norm"]
            assert abs(gl - wl) <= 1e-5 * abs(wl) and abs(gn - wn) <= 1e-4 * abs(wn), row
            assert row["grad_leaf"] <= 1e-4, row
        assert [s["loss"][0] for s in got["train"]] == \
            [s["loss"][0] for s in ranks[0][name]["train"]]


def _slice_err(local, spec, full, coords, shape) -> float:
    from repro_torch.substrate import local_slices
    want = full[local_slices(full.shape, spec, dict(zip(("data", "model"), shape)), coords)]
    assert tuple(local.shape) == want.shape
    return rel(local, want)


def _check_serving(runs: list, ref: dict, shape, layers: int) -> dict:
    """Every rank's serving run (:func:`serve_on_mesh`) against the
    reference's and the port's one-device run (rank 0's): tokens identical,
    logits within 1e-5, each cache shard within ``CACHE_RTOL_PER_LAYER``
    times the model's ``layers`` of the one-device cache's slice and of the
    reference's within as much beyond the one-device cache's own distance
    from it.  Returns the errors."""
    bound = CACHE_RTOL_PER_LAYER * layers
    one = runs[0][1]["one_device"]
    floor = {kind: max(rel(a, b) for a, b in zip(one[kind], ref[kind]))
             for kind in ("prefill", "decode")}
    errs = {"logits": 0.0, "prefill": 0.0, "decode": 0.0, "prefill_one": 0.0, "decode_one": 0.0}
    for coords, got in runs:
        assert got["planned"]
        assert len(got["steps"]) == len(ref["steps"]) == NEW + 1
        for (lg, tok), (wl, wt) in zip(got["steps"], ref["steps"]):
            assert tuple(lg.shape) == wl.shape
            assert np.array_equal(tok.numpy(), wt)
            errs["logits"] = max(errs["logits"], rel(lg, wl))
        for kind in ("prefill", "decode"):
            assert len(got[kind]) == len(ref[kind]) == len(one[kind])
            for (local, spec), full, mine in zip(got[kind], ref[kind], one[kind]):
                errs[kind] = max(errs[kind], _slice_err(local, spec, full, coords, shape))
                errs[f"{kind}_one"] = max(errs[f"{kind}_one"], _slice_err(
                    local, spec, mine.numpy(), coords, shape))
    print(errs, "one device from the reference", floor)
    assert errs["logits"] <= 1e-5, errs
    for kind in ("prefill", "decode"):
        assert errs[f"{kind}_one"] <= bound and errs[kind] <= floor[kind] + bound, (errs, floor)
    return errs


@pytest.mark.parametrize("P", list(PROMPTS))
@pytest.mark.parametrize("name", list(CASES) + list(ONE_ROW))
def test_sharded_serve_matches_reference(ranks, reference, name, P):
    """Prefill, ``seed_cache`` into ``PROMPTS[P]`` positions and NEW greedy
    decode steps on the mesh, the steps planned, against the reference's
    run (:func:`_check_serving`); the decode plan's cache layout is the one
    the true cache length resolves (46 positions on (1, 4): whole).  The
    one-row cases' plans keep the weights on their ``data`` shards, the
    others' on none."""
    arch, shape, _ = {**CASES, **ONE_ROW}[name]
    for r in ranks:
        got = r[name]["serve"][P]
        if name in ONE_ROW:
            assert got["plan"] == ((), ("model",), ("data",)), got["plan"]
        else:
            rows, seq = PLANS[name][0][PROMPTS[P]], PLANS[name][1][PROMPTS[P]]
            assert got["plan"] == (rows, seq, ()), got["plan"]
    ref = reference[arch]["one_row" if name in ONE_ROW else "serve"][P]
    _check_serving([(r[name]["coords"], r[name]["serve"][P]) for r in ranks], ref, shape,
                   smoke_cfg(arch).n_layers)


def test_seed_cache_across_sequence_splits(ranks, reference):
    """granite smoke on (1, 4): a prompt of 40 tokens, its prefill cache
    split over ``model``, seeded into a 46-position decode cache that does
    not split (46 does not divide 4), then NEW greedy steps: against the
    reference as :func:`_check_serving` holds it."""
    for r in ranks:
        assert r["seed"]["plan"] == ((), (), ())
        assert all(spec[2] == "model" for _, spec in r["seed"]["prefill"])
    _check_serving([(r["seed"]["coords"], r["seed"]) for r in ranks],
                   reference[SEED_ARCH]["serve"][SEED_P], SEED_MESH,
                   smoke_cfg(SEED_ARCH).n_layers)


# ----------------------------------------------------- fake 8-rank traces
TRACE_CELLS = {"jamba-v0.1-52b": ("train_4k", "prefill_32k", "decode_32k", "long_500k"),
               "qwen2-vl-72b": ("train_4k", "prefill_32k", "decode_32k")}
TRACE_PROFILES = ("baseline", "serve")
TRACE = """
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
import repro_torch.configs as C
from repro_torch.launch.dryrun import laid_out, make_mesh
from repro_torch.launch.steps import (abstract_cache, abstract_state, build_decode,
                                      build_prefill, build_train, input_shardings)
from repro_torch.models import build
from repro_torch.models.common import sharding_profile, sorted_leaves
from repro_torch.models.moe import GROUP
from repro_torch.optim import AdamWState
from repro_torch.optim.adamw import tree_map_sorted
from repro_torch.substrate import CostCounter, fake_store, init_group, mesh_context
init_group("fake", 0, 8, store=fake_store())


def expert_tokens(cfg, tp, B, S):
    # the tokens a rank's experts run on: its rows' groups of every rank of
    # the traded expert axes, gathered over the traded hidden-column axes
    if not tp.expert_axes:
        return 0
    s_local = S // tp.parts(tp.seq_axes)
    gs = min(GROUP, S)
    C = max(1, int(cfg.capacity_factor * gs * cfg.top_k / cfg.n_experts))
    return (B // tp.parts(tp.batch_axes) * cfg.n_experts // tp.parts(tp.expert_axes)
            * (s_local // min(gs, s_local)) * tp.parts(tp.experts_traded)
            * tp.parts(tp.expert_ffn_traded) * C * cfg.d_model)


out = {}
for arch, cells in CELLS.items():
    cfg = C.get(arch, smoke=True)
    model = build(cfg)
    for profile in PROFILES:
        with sharding_profile(profile):
            mesh = make_mesh("single", smoke=True, device_type="cpu")
            for name in cells:
                cell = C.smoke_cell(name)
                inputs = {k: v for k, v in model.input_specs(cell).items() if k != "pos"}
                in_sh = input_shardings(inputs, mesh)
                lay = lambda tree, sh: tree_map_sorted(lambda m, s: laid_out(m, s, "cpu"),
                                                       tree, sh)
                with mesh_context(mesh), FakeTensorMode(allow_non_fake_inputs=True):
                    batch = {k: laid_out(v, in_sh[k], "cpu") for k, v in inputs.items()}
                    counter = CostCounter()
                    held = []
                    S = cell.seq_len
                    if cell.kind == "train":
                        step, opt, sh = build_train(model, mesh)
                        p_meta, o_meta = abstract_state(model, opt)
                        params = lay(p_meta, sh["params"])
                        state = AdamWState(laid_out(o_meta.count, sh["opt"].count, "cpu"),
                                           lay(o_meta.m, sh["opt"].m), lay(o_meta.v, sh["opt"].v))
                        with counter:
                            step(params, state, batch)
                        tp, layouts, _ = step.plan(batch["labels"])
                    elif cell.kind == "decode":
                        step, sh = build_decode(model, mesh, cell)
                        params = lay(model.abstract(), sh["params"])
                        cache = lay(abstract_cache(model, cell), sh["cache"])
                        batch["pos"] = cell.seq_len - 1
                        with counter:
                            step(params, cache, batch)
                        tp, layouts = step.plan(batch["tokens"], cache)
                        held = [c.to_local().numel() for c in sorted_leaves(cache)]
                        S = 1
                    else:
                        step, sh = build_prefill(model, mesh)
                        params = lay(model.abstract(), sh["params"])
                        with counter:
                            step(params, batch)
                        tp, layouts, _ = step.plan(next(iter(batch.values())))
                    if cell.kind != "decode":
                        # the rows' gathered sequence, as every block gathers it
                        held.append(cell.global_batch // tp.parts(tp.batch_axes) * cell.seq_len
                                    * cfg.d_model)
                    held += [w.numel() for w in sorted_leaves(tp.working(params, layouts))]
                    held.append(expert_tokens(cfg, tp, cell.global_batch, S))
                parts = dict(batch=tp.batch_axes, seq=tp.seq_axes, qkv=tp.qkv_axes,
                             ffn=tp.ffn_axes, vocab=tp.vocab_axes, experts=tp.expert_axes,
                             expert_ffn=tp.expert_ffn_axes, ssm_heads=tp.ssm_head_axes,
                             ssm_inner=tp.ssm_in_axes, cache_rows=tp.cache_row_axes,
                             cache_seq=tp.cache_seq_axes)
                out[f"{arch}/{profile}/{name}"] = dict(
                    flops=counter.flops, held=max(held), plan=parts,
                    gathers=[n for k, _, n in counter.collectives if k == "all-gather"])
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def traces():
    script = (f"CELLS = {TRACE_CELLS!r}\nPROFILES = {TRACE_PROFILES!r}"
              + textwrap.dedent(TRACE))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", script],
                       env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src")),
                       capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.split("RESULT", 1)[1])


TRACE_KEYS = [(a, c, p) for a, cells in TRACE_CELLS.items() for c in cells
              for p in TRACE_PROFILES if not (c == "long_500k" and p == "serve")]


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _leaves(specs) -> list:
    from repro_torch.models.common import tree_map_pspec
    out = []
    tree_map_pspec(lambda _, p: out.append(p), specs)
    return out


def _smoke_plan(arch: str, cell_name: str, profile: str = "baseline",
                mesh_kind: str = "single", **overrides) -> dict:
    """A hybrid or VLM smoke model's layout of ``cell_name`` on a smoke mesh
    (``single``: (data 4, model 2); ``multi``: (pod 2, data 2, model 2))
    under ``profile``, by hand from the resolved specs: the mesh axes of the
    stream's rows and sequence (one token in decode), of the vocabulary's,
    the heads', the MLP's and the experts' columns, of ``in_proj``'s
    columns, the SSM heads and the conv channels (the decode cache's
    ``ssm`` and ``conv`` leaves) and of the cache's rows and sequence;
    whether the q (and the kv) heads split whole (``head_split``); a decode
    step's ``stationary`` axes (the weights' embed axes its rows leave
    whole, over which the weights stay on their shards: ``data`` for one
    row) and ``table`` axes (the tables' embed axes its rows split, over
    which the tables stay on their shards); and the ranks each logical axis splits over (``parts``, for the
    hand FLOP counts: where the experts' axes split the sequence the tokens
    cross them instead, 1; ``embed`` the stationary axes', ``kv`` wk's
    columns', ``conv`` the conv history's channels').  ``overrides`` change
    the smoke config (a dense model's heads, as ``QSLICE``'s)."""
    import repro_torch.configs as C
    from repro_torch.launch.dryrun import mesh_shape
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    from repro_torch.models.tensor_parallel import head_split
    cfg = dataclasses.replace(C.get(arch, smoke=True), **overrides)
    cell = C.smoke_cell(cell_name)
    sizes = dict(zip(*reversed(mesh_shape(mesh_kind, True))))
    model = build(cfg)
    B, S = cell.global_batch, 1 if cell.kind == "decode" else cell.seq_len

    def spec(p):
        return [_axes(e) for e in resolve_spec(tuple(p.shape), p.logical, sizes,
                                               profile=profile)]

    def n(axes):
        return math.prod(sizes[ax] for ax in axes)
    stream = [_axes(e) for e in resolve_spec((B, S), ("batch", "seq"), sizes, profile=profile)]
    layer = {k: v for b in model.specs()["blocks"].values() for k, v in b.items()}
    embed = set()
    for p in _leaves(model.specs()):
        embed.update(ax for e, lname in zip(spec(p), p.logical) if lname in ("embed", "embed_d")
                     for ax in e)
    cache = {k: v for e in model.cache_specs(cell.global_batch, cell.seq_len).values()
             for k, v in e.items()}
    plan = dict(cfg=cfg, cell=cell, sizes=sizes, model=model, spec=spec, batch=stream[0],
                seq=stream[1], vocab=spec(model.specs()["embed"])[0],
                qkv=spec(layer["attn"]["wq"])[2], kv=spec(layer["attn"]["wk"])[2],
                ffn=spec(layer["mlp"]["wg"])[2] if "mlp" in layer else (),
                experts=(), expert_ffn=(), columns=(), heads=(), conv=(),
                cache_batch=spec(cache["k"])[1], cache_seq=spec(cache["k"])[2],
                stationary=tuple(ax for ax in sizes if ax in embed and ax not in stream[0])
                if cell.kind == "decode" else (),
                table=tuple(ax for ax in stream[0] if ax in spec(model.specs()["embed"])[1])
                if cell.kind == "decode" else ())
    if "moe" in layer:
        w = layer["moe"]["wg"]
        plan["experts"], plan["expert_ffn"] = (spec(w)[w.logical.index(k)]
                                               for k in ("experts", "ffn"))
    if "ssm" in layer:
        plan.update(columns=spec(layer["ssm"]["in_proj"])[2], heads=spec(cache["ssm"])[2],
                    conv=spec(cache["conv"])[3])
    plan["q_local"], plan["kv_local"] = head_split(cfg.n_heads, cfg.n_kv_heads, n(plan["qkv"]))
    parts = {k: n(plan[k]) for k in ("batch", "seq", "vocab", "qkv", "kv", "ffn", "cache_batch",
                                     "cache_seq", "conv")}
    parts["embed"] = n(plan["stationary"])
    parts["table"] = n(plan["table"])
    if plan["table"] and not plan["vocab"]:
        parts["logits"] = n(tuple(ax for ax in sizes if ax not in stream[0]))
    if "moe" in layer:
        parts["experts"] = 1 if set(plan["experts"]) & set(plan["seq"]) else n(plan["experts"])
        parts["expert_ffn"] = n(tuple(ax for ax in plan["expert_ffn"] if ax not in plan["seq"]))
    if "ssm" in layer:
        parts.update(ssm_inner=n(plan["columns"]), ssm_heads=n(plan["heads"]))
    return dict(plan, parts=parts)


@pytest.mark.parametrize("arch,cell,profile", TRACE_KEYS)
def test_trace_flops_hand_count(traces, arch, cell, profile):
    """The traced step's product FLOPs on one of 8 fake ranks equal
    ``hand_train_flops`` / ``hand_prefill_flops`` / ``hand_decode_flops``,
    summed over the layer pattern, with the ranks each axis splits over on
    the smoke mesh (:func:`_smoke_plan`)."""
    from repro_torch.models.tensor_parallel import (hand_decode_flops, hand_prefill_flops,
                                                    hand_train_flops)
    hand = _smoke_plan(arch, cell, profile)
    c = hand["cell"]
    rec = traces[f"{arch}/{profile}/{cell}"]
    fn = dict(train=hand_train_flops, prefill=hand_prefill_flops, decode=hand_decode_flops)
    assert rec["flops"] == fn[c.kind](hand["cfg"], c.global_batch, c.seq_len, hand["parts"])


@pytest.mark.parametrize("arch,cell,profile", TRACE_KEYS)
def test_trace_gathers_no_more_than_a_shard(traces, arch, cell, profile):
    """No all-gather's result in the traced step holds more elements than
    the largest of a rank's cache shards (decode), its parameters' working
    layouts, its rows' gathered sequence (train and prefill) and the tokens
    its experts run on: nothing is gathered whole that the reference keeps
    sharded."""
    rec = traces[f"{arch}/{profile}/{cell}"]
    gathers = rec["gathers"]
    print(arch, cell, profile, max(gathers), rec["held"], rec["plan"])
    assert gathers and max(gathers) <= rec["held"]
