"""The dense family's sharded prefill and decode (``launch.steps.PrefillStep``
and ``DecodeStep`` on a mesh, ``models.tensor_parallel.plan_prefill`` /
``plan_decode``) on a gloo group of 4 spawned CPU ranks, against the
reference's ``Model.prefill`` / ``Model.decode`` under JAX on the CPU from the
same weights (``Model.init``, carried over by ``params_onto_mesh``) and
prompts, in float32.

Cases: granite smoke on (data 2, model 2) (its 2 kv heads split: prefill's
cache through an all-to-all) and on (1, 4) (the whole ``wk`` / ``wv``
project each rank's cache slice); llama3 smoke on (1, 4) (2 q heads a rank
in one GQA group); minicpm smoke on (1, 4) (6 heads on 4 ranks: prefill's
attention runs every head on each rank's query slice of the prompt and an
all-to-all brings its output to ``wo``'s rows, decode's every head; tied
embeddings over a split vocabulary) and under ``serve`` on (2, 2) (the query
slice over both axes, as whisper-tiny's on the card); glm4 smoke on
(1, 4) (one kv head); granite smoke under ``serve`` on (2, 2) (heads, MLP and
vocabulary over both axes, the stream's batch whole, the cache's rows on
``data``), and so with 4 kv heads (which split over both axes, so prefill's
cache takes an all-to-all over ``data`` for its rows and one over ``model``
for its sequence, as granite-3-8b's 8 kv heads do on the card's (2, 2));
granite smoke under ``opt1`` on (2, 2) (the (un)embedding tables whole over
``data``, as the reference's ``resolve_spec`` lays them out under it).
Each prefills (B, P) prompts, moves the cache into a decode cache of T
positions (``seed_cache``, as the engine pads the reference's) and decodes
NEW greedy tokens.  granite smoke with one row on (2, 2) (``ONE_ROW``), under
the baseline and under ``opt1``: the row leaves ``data`` whole, so the
decode plan keeps every weight on its embed shard there
(``stationary_axes``; under ``opt1`` the tables are whole and the blocks
keep their shards) and moves the token; the cases of B rows keep none.

Held: the tokens identical; the logits within 1e-5 of the reference's largest
(the split softmax of decode is not bit for bit the one-device softmax); each
rank's prefill and decode cache shard within 1e-6 of the matching slice of
the reference's cache (``substrate.local_slices``).  The whisper smoke model
(the encoder-decoder, which gathered whole until it had a plan) on (2, 2)
takes planned steps too, held to the port's one-device steps
(``tests/test_torch_encdec_parallel.py`` holds them to the reference).  A fake 8-rank trace
of the decode and prefill steps of granite, dbrx and mixtral smoke (the MoE
family's too, under ``moe_ep`` on its own
mesh) shows that no all-gather outputs more than a rank's cache shard, a
parameter's working layout or the tokens its experts run on.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from test_torch_distributed import check_tables, rel, smoke_cfg, spawn, table_specs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {  # name: (arch, mesh shape, profile, the smoke config's changes)
    "granite-2x2": ("granite-3-8b", (2, 2), "baseline", ()),
    "granite-1x4": ("granite-3-8b", (1, 4), "baseline", ()),
    "llama3-1x4": ("llama3-405b", (1, 4), "baseline", ()),
    "minicpm-1x4": ("minicpm-2b", (1, 4), "baseline", ()),
    "glm4-1x4": ("glm4-9b", (1, 4), "baseline", ()),
    "granite-serve-2x2": ("granite-3-8b", (2, 2), "serve", ()),
    "granite-serve-kv4-2x2": ("granite-3-8b", (2, 2), "serve", (("n_kv_heads", 4),)),
    "granite-opt1-2x2": ("granite-3-8b", (2, 2), "opt1", ()),
    "minicpm-serve-2x2": ("minicpm-2b", (2, 2), "serve", ()),
    # two rows a data rank: the decode plan keeps the tables on their data
    # shards and trades the rows for their columns; a vocabulary of 255
    # divides neither axis (the logits' columns uneven), 3 heads of 16 do not
    # split model (q, k and v on their columns), glm4's one kv head neither
    "granite-v255-2x2": ("granite-3-8b", (2, 2), "baseline", (("vocab", 255),)),
    "minicpm-h3-2x2": ("minicpm-2b", (2, 2), "baseline", (("n_heads", 3), ("n_kv_heads", 3))),
    "glm4-2x2": ("glm4-9b", (2, 2), "baseline", ()),
}
ONE_ROW = {  # the first prompt alone
    "granite-b1-2x2": ("granite-3-8b", (2, 2), "baseline", ()),
    "granite-opt1-b1-2x2": ("granite-3-8b", (2, 2), "opt1", ()),
}
B, P, T, NEW = 4, 8, 16, 6
GATHERING = "whisper-tiny"


def model_key(arch: str, over) -> str:
    return "-".join([arch] + [f"{k}{v}" for k, v in over])


def prompts_for(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (B, P)).astype(np.int32)


# the decode plans the distributed argmax runs on: the vocabulary on model
# with the rows on data, 255 columns over model unevenly (128 and 127) with
# the rows on data, the vocabulary over 4 ranks with every row on each
ARGMAX_CASES = ("granite-2x2", "granite-v255-2x2", "granite-1x4")


def argmax_logits(V: int) -> torch.Tensor:
    """(B, 1, V) logits whose argmax is hard to split: a maximum tied at
    columns on every rank, a NaN (twice, after a +inf) that wins, a row of
    -inf, and a tie across the middle column boundary."""
    x = torch.as_tensor(np.random.default_rng(11).uniform(-4, 4, (B, 1, V)),
                        dtype=torch.float32)
    x[0, 0, [3, V // 2 + 2, V - 1]] = 5.0
    x[1, 0, 2] = float("inf")
    x[1, 0, [V - 55, V - 5]] = float("nan")
    x[2] = float("-inf")
    x[3, 0, [-(-V // 2) - 1, -(-V // 2)]] = 7.0
    return x


def serve_rank_job(rank, world, init, tmp, weights):
    """Every case on one 4-rank gloo group: prefill, the decode cache seeded
    from it, NEW greedy steps; each step's logits and tokens, and this rank's
    cache shards with their specs.  Then whisper smoke's steps on (2, 2)
    and on one device, from seeded frames."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.interop import params_onto_mesh
    from repro_torch.launch.steps import (DecodeStep, PrefillStep, build_decode, build_prefill,
                                          seed_cache)
    from repro_torch.models import build
    from repro_torch.models.common import init_params, sharding_profile, sorted_leaves
    from repro_torch.optim.adamw import tree_map_sorted
    from repro_torch.models.tensor_parallel import plan_decode
    from repro_torch.substrate import chunk_of, distribute, gather_full, init_group, make_mesh
    torch.set_num_threads(2)
    init_group("gloo", rank, world, init)
    cell = ShapeCell("serve", T, B, "decode")

    def shards(cache, sh):
        return [(x.to_local().clone(), s.spec) for x, s in zip(sorted_leaves(cache),
                                                                 sorted_leaves(sh))]
    out = {}
    for name, (arch, shape, profile, over) in {**CASES, **ONE_ROW}.items():
        rows = 1 if name in ONE_ROW else B
        model = build(smoke_cfg(arch, **dict(over)))
        with sharding_profile(profile):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            fwd, psh = build_prefill(model, mesh)
            dec, dsh = build_decode(model, mesh, ShapeCell("serve", T, rows, "decode"))
            params = params_onto_mesh(weights[model_key(arch, over)], psh["params"])
            tokens = torch.as_tensor(prompts_for(model.cfg.vocab)[:rows])
            pcache, logits = fwd(params, {"tokens": tokens})
            logits = gather_full(logits)
            prefill_shards = shards(pcache, fwd.plan(tokens)[2])
            cache = seed_cache(pcache, dsh["cache"], T)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            steps = [(logits, tok)]
            for i in range(NEW):
                tok, logits, cache = dec(params, cache, {"tokens": tok[:, None], "pos": P + i})
                logits = gather_full(logits)
                steps.append((logits, tok))
            tp = dec.plan(torch.empty(rows, 1), cache)[0]
            q_slice = fwd.plan(tokens)[0].q_slice_axes
        out[name] = dict(steps=steps, prefill=prefill_shards, decode=shards(cache, dsh["cache"]),
                         coords=dict(zip(("data", "model"), mesh.get_coordinate())),
                         plan=(tp.q_local, tp.kv_local, q_slice, tp.cache_row_axes,
                               tp.cache_seq_axes, tp.stationary_axes, tp.table_axes),
                         tables=table_specs(psh["params"]))

    out["argmax"] = {}
    for name in ARGMAX_CASES:
        arch, shape, profile, over = CASES[name]
        cfg = smoke_cfg(arch, **dict(over))
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        tp = plan_decode(cfg, build(cfg).specs(), build(cfg).cache_specs(B, T), mesh, B)
        whole = argmax_logits(cfg.vocab)
        mine = whole[chunk_of(B, mesh, tp.batch_axes)][..., tp.logit_cols(cfg.vocab)]
        out["argmax"][name] = (tp.logit_axes, tp.next_tokens(mine, cfg.vocab),
                               torch.argmax(whole[:, -1], dim=-1))

    model = build(smoke_cfg(GATHERING))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(prompts_for(model.cfg.vocab))
    frames = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (B, model.cfg.enc_seq, model.cfg.d_model)).astype(np.float32))
    runs = {}
    for where in ("mesh", "one"):
        if where == "one":
            fwd, dec, p = PrefillStep(model), DecodeStep(model), params
            cache = init_params(model.cache_specs(B, T), None, "cpu")
        else:
            mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
            fwd, psh = build_prefill(model, mesh)
            dec, dsh = build_decode(model, mesh, cell)
            p = tree_map_sorted(distribute, params, psh["params"])
            cache = tree_map_sorted(distribute, init_params(model.cache_specs(B, T), None, "cpu"),
                                    dsh["cache"])
        _, logits = fwd(p, {"tokens": tokens, "frames": frames})
        logits = gather_full(logits)
        seq, tok = [], tokens[:, :1]
        for pos in range(NEW):
            nxt, _, cache = dec(p, cache, {"tokens": tok, "pos": pos})
            seq.append(nxt)
            tok = nxt[:, None]
        runs[where] = (logits, torch.stack(seq, 1), bool(fwd._plans and dec._plans))
    out[GATHERING] = runs
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def _reference_run(model, params, tokens) -> dict:
    """The reference's greedy run of ``tokens``: the prefill's logits and
    cache, the cache padded to T positions, NEW ``Model.decode`` steps'
    logits and tokens, and the final cache."""
    import jax
    import jax.numpy as jnp
    pcache, logits = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(tokens)})
    cache = jax.tree.map(lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, T - P), (0, 0), (0, 0))),
                         pcache)
    dec = jax.jit(model.decode)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    steps = [(np.asarray(logits), np.asarray(tok))]
    for i in range(NEW):
        logits, cache = dec(params, cache, tok[:, None], jnp.int32(P + i))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        steps.append((np.asarray(logits), np.asarray(tok)))
    return dict(steps=steps, prefill=[np.asarray(x) for x in jax.tree.leaves(pcache)],
                decode=[np.asarray(x) for x in jax.tree.leaves(cache)])


@pytest.fixture(scope="module")
def reference():
    """Per architecture: the reference's ``Model.init`` weights (seed 0) in
    float32 compute, and its greedy run (:func:`_reference_run`) of the B
    prompts, and of the first alone where a ``ONE_ROW`` case serves it
    (``one_row``)."""
    import jax
    import repro.configs as JC
    from repro.models import build as jbuild
    out = {}
    one_row = {(a, over) for a, _, _, over in ONE_ROW.values()}
    for arch, over in sorted({(a, over) for a, _, _, over in CASES.values()}, key=str):
        jcfg = dataclasses.replace(JC.get(arch, smoke=True), compute_dtype="float32",
                                   **dict(over))
        model = jbuild(jcfg)
        params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
        prompts = prompts_for(jcfg.vocab)
        out[model_key(arch, over)] = dict(params=params, **_reference_run(model, params, prompts))
        if (arch, over) in one_row:
            out[model_key(arch, over)]["one_row"] = _reference_run(model, params, prompts[:1])
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    return spawn(serve_rank_job, 4, tmp, {a: r["params"] for a, r in reference.items()})


PLANS = {  # name: (q heads split, kv heads split, the axes the prefill's queries split
    #         their sequence over where the q heads do not, cache rows beyond the
    #         stream's, cache seq, the axes over which the weights stay on their
    #         embed shards, the axes over which the tables stay on theirs and the
    #         rows trade for their columns)
    "granite-2x2": (True, True, (), (), ("model",), (), ("data",)),
    "granite-1x4": (True, False, (), (), ("model",), (), ()),
    "llama3-1x4": (True, False, (), (), ("model",), (), ()),
    "minicpm-1x4": (False, False, ("model",), (), ("model",), (), ()),
    "glm4-1x4": (True, False, (), (), ("model",), (), ()),
    "granite-serve-2x2": (True, False, (), ("data",), ("model",), (), ()),
    "granite-serve-kv4-2x2": (True, True, (), ("data",), ("model",), (), ()),
    "granite-opt1-2x2": (True, True, (), (), ("model",), (), ()),
    "minicpm-serve-2x2": (False, False, ("model", "data"), ("data",), ("model",), (), ()),
    "granite-v255-2x2": (True, True, (), (), ("model",), (), ("data",)),
    "minicpm-h3-2x2": (False, False, ("model",), (), ("model",), (), ("data",)),
    "glm4-2x2": (True, False, (), (), ("model",), (), ("data",)),
    "granite-b1-2x2": (True, True, (), (), ("model",), ("data",), ()),
    "granite-opt1-b1-2x2": (True, True, (), (), ("model",), ("data",), ()),
}


def _slice_err(local, spec, full, coords, shape) -> float:
    from repro_torch.substrate import local_slices
    sizes = dict(zip(("data", "model"), shape))
    want = full[local_slices(full.shape, spec, sizes, coords)]
    assert tuple(local.shape) == want.shape
    return rel(local, want)


@pytest.mark.parametrize("name", list(CASES) + list(ONE_ROW))
def test_sharded_serve_matches_reference(ranks, reference, name):
    """Prefill and NEW greedy decode steps on the mesh: on every rank the
    tokens equal the reference's, the logits (whole on every rank) within
    1e-5 of its largest, and the rank's prefill and decode cache shards
    within 1e-6 of the reference's caches' matching slices.  Each case takes
    the head branch it names; the one-row cases keep the weights on their
    ``data`` shards, the others on none; the baseline's cases of B rows on
    (2, 2) keep the tables on theirs."""
    arch, shape, profile, over = {**CASES, **ONE_ROW}[name]
    ref = reference[model_key(arch, over)]
    if name in ONE_ROW:
        ref = ref["one_row"]
    errs = {"logits": 0.0, "prefill": 0.0, "decode": 0.0}
    for r in ranks:
        got = r[name]
        assert got["plan"] == PLANS[name]
        check_tables(got["tables"], arch, ("data", "model"), shape, profile, **dict(over))
        for (lg, tok), (wl, wt) in zip(got["steps"], ref["steps"]):
            assert tuple(lg.shape) == wl.shape
            assert np.array_equal(tok.numpy(), wt)
            errs["logits"] = max(errs["logits"], rel(lg, wl))
        for kind in ("prefill", "decode"):
            for (local, spec), full in zip(got[kind], ref[kind]):
                errs[kind] = max(errs[kind], _slice_err(local, spec, full, got["coords"], shape))
    print(name, errs)
    assert errs["logits"] <= 1e-5 and errs["prefill"] <= 1e-6 and errs["decode"] <= 1e-6, errs


def test_distributed_argmax_matches_torch_argmax(ranks):
    """``TensorParallel.next_tokens`` on every rank, from its rows and
    columns of :func:`argmax_logits`, equals ``torch.argmax`` of the whole
    logits (ties to the least index, a NaN above everything, a row of -inf
    to 0), for each plan of ``ARGMAX_CASES``, an int32 (B,) on every rank."""
    axes = {}
    for r in ranks:
        for name, (cols, got, want) in r["argmax"].items():
            axes[name] = cols
            assert got.dtype == torch.int32 and got.shape == (B,), name
            assert got.equal(want.to(torch.int32)), (name, got, want)
    assert axes == {name: ("model",) for name in ARGMAX_CASES}


def test_other_families_gather_on_a_mesh(ranks):
    """The encoder-decoder's smoke model (whisper) on (2, 2), the last family
    that gathered whole to serve, makes a plan for its prefill and its
    decode now, as every family does: its prefill logits within 1e-5 of
    the one-device step's and six greedy tokens identical."""
    for r in ranks:
        (lm, tm, planned), (lo, to, _) = r[GATHERING]["mesh"], r[GATHERING]["one"]
        assert planned
        assert rel(lm, lo) < 1e-5
        assert tm.equal(to)


TRACE = """
import json
import math
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
import repro_torch.configs as C
from repro_torch.launch.dryrun import laid_out, make_mesh
from repro_torch.launch.steps import abstract_cache, build_decode, build_prefill, input_shardings
from repro_torch.models import build
from repro_torch.models.common import sharding_profile, sorted_leaves
from repro_torch.models.moe import GROUP
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
for arch, kind, profile in CELLS:
    cfg = C.get(arch, smoke=True)
    model = build(cfg)
    with sharding_profile(profile):
        mesh = make_mesh(kind, smoke=True, device_type="cpu")
        for name in ("decode_32k", "prefill_32k"):
            cell = C.smoke_cell(name)
            inputs = {k: v for k, v in model.input_specs(cell).items() if k != "pos"}
            in_sh = input_shardings(inputs, mesh)
            if cell.kind == "decode":
                step, sh = build_decode(model, mesh, cell)
            else:
                step, sh = build_prefill(model, mesh)
            with mesh_context(mesh), FakeTensorMode(allow_non_fake_inputs=True):
                batch = {k: laid_out(v, in_sh[k], "cpu") for k, v in inputs.items()}
                params = tree_map_sorted(lambda m, s: laid_out(m, s, "cpu"), model.abstract(),
                                         sh["params"])
                counter = CostCounter()
                if cell.kind == "decode":
                    cache = tree_map_sorted(lambda m, s: laid_out(m, s, "cpu"),
                                            abstract_cache(model, cell), sh["cache"])
                    batch["pos"] = cell.seq_len - 1
                    with counter:
                        step(params, cache, batch)
                    tp, layouts = step.plan(batch["tokens"], cache)
                    held = [c.to_local().numel() for c in sorted_leaves(cache)]
                else:
                    with counter:
                        _, logits = step(params, batch)
                    tp, layouts, _ = step.plan(batch["tokens"])
                    # the stream's gathered sequence, as the train step gathers it
                    held = [cell.global_batch // tp.parts(tp.batch_axes) * cell.seq_len
                            * cfg.d_model]
                work = tp.working(params, layouts)
                held += [w.numel() for w in sorted_leaves(work)]
                held.append(expert_tokens(cfg, tp, cell.global_batch,
                                          1 if cell.kind == "decode" else cell.seq_len))
            out[f"{arch}/{kind}/{name}"] = dict(
                gathers=[n for k, _, n in counter.collectives if k == "all-gather"],
                held=max(held), kinds=sorted({k for k, _, _ in counter.collectives}))
print("RESULT" + json.dumps(out))
"""
TRACE_CELLS = [("granite-3-8b", "single", "baseline"), ("dbrx-132b", "single", "baseline"),
               ("mixtral-8x22b", "single", "baseline"), ("mixtral-8x22b", "moe", "moe_ep")]


def test_serving_steps_gather_no_more_than_a_shard():
    """``decode_32k`` and ``prefill_32k`` at smoke size on 8 fake ranks,
    the steps traced under the counter: granite, dbrx and mixtral smoke on
    the (data 4, model 2) mesh, and mixtral's under ``moe_ep`` on (data 2,
    expert 2, tp 2).  No all-gather's result holds more elements than the
    largest of a rank's cache shards, its parameters' working layouts
    (prefill: or its rows' gathered sequence, as the train step gathers it)
    and the dispatched tokens its experts run on."""
    script = f"CELLS = {TRACE_CELLS!r}" + textwrap.dedent(TRACE)
    r = subprocess.run([sys.executable, "-c", script],
                       env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.split("RESULT", 1)[1])
    for name, rec in out.items():
        print(name, max(rec["gathers"]), rec["held"], rec["kinds"])
        assert rec["gathers"] and max(rec["gathers"]) <= rec["held"], (name, rec)
