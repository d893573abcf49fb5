"""The encoder-decoder (whisper) on a mesh: the planned ``ShardedTrainStep``,
``PrefillStep``, ``seed_cache`` and ``DecodeStep`` (``models.encdec`` on a
``TensorParallel`` plan: the frames a stream of their own, cross-attention
over this rank's rows of the encoder's output, the self and the cross cache
each in its own layout) on a gloo group of 4 spawned CPU ranks, from the
reference's weights (``Model.init``, carried over by ``params_onto_mesh``),
in float32.

Cases: whisper smoke (4 heads, 64 frames, a vocabulary of 256: all split
on a 4-way axis) on (data 1, model 4), (2, 2) and (4, 1) under the
baseline profile and on (2, 2) under ``serve`` and under ``opt1``; and
whisper-odd, the smoke config with 3 heads of 16 (d 48), 62 frames and a
vocabulary of 250, on (1, 4): its heads, frames and vocabulary divide no
axis, as whisper-tiny's 6 heads, 1500 frames and 51865 tokens do not divide
the production mesh's 16 (each rank attends with every head of its query
slice, the 62 frames padded to 64 in the encoder), and under ``serve`` on
(2, 2) (the query slice over both axes, as whisper-tiny's on the card).
Prompts of 8 and 40 tokens into decode caches
of 16 and 48 positions.  And whisper smoke serving one row (the first
prompt) on (2, 2) under the baseline (``ONE_ROW``): the row leaves ``data``
whole, so the decode plan keeps every weight on its embed shard there
(``stationary_axes``) and moves the token; the cases of SERVE_B rows keep
none.  (A prompt whose length does not divide the
``model`` axis would put the smoke cache's 4 heads there, a layout the
decode-SP plan refuses, for every family.)

Held: three train steps against the port's one-device step at the same
parameters and optimizer state (loss 1e-5, grad norm 1e-4, each gradient
leaf 1e-4 of its largest entry; the first loss 1e-5 of the reference's
``Model.loss``); the sharded prefill, ``seed_cache`` and 6 greedy decode
steps against the reference's ``Model.prefill``, its cache padded to T
positions (the cross cache as it is) and ``Model.decode`` (tokens
identical, logits 1e-5 of the largest; every rank's self and cross cache
shards, prefill's and the final decode cache's, within 1e-6 of the
reference's slice read from the shard's spec); each case's plan (the
frames' sequence axes, whether the q and kv heads split, the axes of the
query slice where they do not, the self cache's
rows and sequence axes and the cross cache's sequence axes); the decode
plan reading the cache's length from the self cache by name on a cache that
lists ``cross`` first; ``seed_cache`` leaving the cross shards' values and
length as the prefill left them.  And a fake 8-rank trace of each model's
three cells under the baseline and ``serve`` profiles: product FLOPs equal
to the hand counts (``hand_*_flops``) and no all-gather above a rank's
working layouts, its cache shards or its rows' gathered sequence or frames.
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

from test_torch_distributed import rel, spawn  # noqa: E402

ARCH = "whisper-tiny"
# whisper-odd: the smoke config with heads, frames and a vocabulary that
# divide no axis of 4 (the production mesh's branches in small)
ODD = dict(name="whisper-odd", n_heads=3, n_kv_heads=3, head_dim=16, d_model=48, enc_seq=62,
           vocab=250)
MODELS = {"smoke": {}, "odd": ODD}
CASES = {  # name: (model, mesh shape, profile)
    "1x4": ("smoke", (1, 4), "baseline"),
    "2x2": ("smoke", (2, 2), "baseline"),
    "4x1": ("smoke", (4, 1), "baseline"),
    "serve-2x2": ("smoke", (2, 2), "serve"),
    "opt1-2x2": ("smoke", (2, 2), "opt1"),
    "odd-1x4": ("odd", (1, 4), "baseline"),
    "odd-serve-2x2": ("odd", (2, 2), "serve"),
}
# each case's plan: (the frames' sequence axes, q heads split, kv heads split,
# the axes the queries' sequence splits over where the q heads do not, the
# self cache's rows beyond the stream's, its sequence axes, the cross cache's
# sequence axes)
PLANS = {
    "1x4": (("model",), True, True, (), (), ("model",), ("model",)),
    "2x2": (("model",), True, True, (), (), ("model",), ("model",)),
    "4x1": ((), True, True, (), (), (), ()),
    "serve-2x2": ((), True, True, (), ("data",), ("model",), ("model",)),
    "opt1-2x2": (("model",), True, True, (), (), ("model",), ("model",)),
    "odd-1x4": ((), False, False, ("model",), (), ("model",), ()),
    "odd-serve-2x2": ((), False, False, ("model", "data"), ("data",), ("model",), ("model",)),
}
# serving the first row alone: (model, mesh shape, profile), and the decode
# plan's (self cache rows, its sequence axes, the cross cache's, stationary)
ONE_ROW = {"b1-2x2": ("smoke", (2, 2), "baseline")}
ONE_ROW_PLAN = ((), ("model",), ("model",), ("data",))
TRAIN = (4, 64)              # (B, S)
PROMPTS = {8: 16, 40: 48}    # prompt: decode cache positions
SERVE_B, NEW, STEPS = 4, 6, 3
CACHE_RTOL = 1e-6


def port_cfg(model: str):
    import repro_torch.configs as TC
    return dataclasses.replace(TC.get(ARCH, smoke=True), compute_dtype="float32",
                               **MODELS[model])


def ref_cfg(model: str):
    import repro.configs as JC
    return dataclasses.replace(JC.get(ARCH, smoke=True), compute_dtype="float32",
                               **MODELS[model])


def frames_for(cfg, B: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def train_batch(cfg, i: int) -> dict:
    """Train batch ``i``: the synthetic tokens and labels and seeded frames."""
    from repro_torch.data import DataConfig, SyntheticLM
    B, S = TRAIN
    batch = SyntheticLM(DataConfig(cfg.vocab, S, B, 0)).batch(i)
    return dict(batch, frames=frames_for(cfg, B, 100 + i))


def prefill_inputs(cfg, P: int, rows: int = SERVE_B) -> dict:
    """The first ``rows`` of the SERVE_B prompts of length P and their frames."""
    rng = np.random.default_rng(7 + P)
    return {"tokens": rng.integers(0, cfg.vocab, (SERVE_B, P)).astype(np.int32)[:rows],
            "frames": frames_for(cfg, SERVE_B, 200 + P)[:rows]}


def serve_on_mesh(model, mesh, params, P: int, T: int, rows: int = SERVE_B) -> dict:
    """The sharded prefill of ``rows`` prompts, ``seed_cache`` into T
    positions and NEW greedy decode steps: each step's logits and tokens,
    this rank's prefill and final decode cache shards with their specs,
    whether the seeded cross shards equal the prefill's (values and
    length), and the decode plan."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.steps import build_decode, build_prefill, seed_cache
    from repro_torch.models.common import sorted_leaves
    from repro_torch.substrate import gather_full

    def shards(cache, sh):
        return [(x.to_local().clone(), s.spec) for x, s in zip(sorted_leaves(cache),
                                                                 sorted_leaves(sh))]
    fwd, _ = build_prefill(model, mesh)
    dec, dsh = build_decode(model, mesh, ShapeCell("serve", T, rows, "decode"))
    inputs = {k: torch.as_tensor(v) for k, v in prefill_inputs(model.cfg, P, rows).items()}
    pcache, logits = fwd(params, inputs)
    logits = gather_full(logits)
    prefill_shards = shards(pcache, fwd.plan(inputs["tokens"])[2])
    cache = seed_cache(pcache, dsh["cache"], T)
    cross_kept = [(bool(cache["cross"][n].to_local().equal(pcache["cross"][n].to_local())),
                   cache["cross"][n].shape[2]) for n in ("k", "v")]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    steps = [(logits, tok)]
    for i in range(NEW):
        tok, logits, cache = dec(params, cache, {"tokens": tok[:, None], "pos": P + i})
        logits = gather_full(logits)
        steps.append((logits, tok))
    (tp, _), = dec._plans.values()
    return dict(steps=steps, prefill=prefill_shards, decode=shards(cache, dsh["cache"]),
                planned=bool(fwd._plans) and bool(dec._plans), cross_kept=cross_kept,
                plan=(tp.cache_row_axes, tp.cache_seq_axes, tp.cross_seq_axes),
                stationary=tp.stationary_axes)


def cross_first_plan(model, mesh, T: int) -> tuple:
    """``DecodeStep.plan`` on a cache whose ``cross`` entry comes first and
    whose lengths differ (the frames' and T): the plan's self and cross
    cache sequence axes and the length its key holds."""
    from repro_torch.launch.steps import DecodeStep
    cfg = model.cfg

    def leaf(n):
        return torch.empty((cfg.n_layers, SERVE_B, n, cfg.n_kv_heads, cfg.hd), device="meta")
    step = DecodeStep(model, mesh)
    cache = {"cross": {"k": leaf(cfg.enc_seq), "v": leaf(cfg.enc_seq)},
             "self": {"k": leaf(T), "v": leaf(T)}}
    tp, _ = step.plan(torch.empty((SERVE_B, 1)), cache)
    (key,) = step._plans
    return tp.cache_seq_axes, tp.cross_seq_axes, key[1]


def rank_job(rank, world, init, tmp, weights):
    """Every case on one 4-rank gloo group: three train steps, each beside
    the one-device step from the parameters and optimizer state the sharded
    step holds, gathered whole; then per prompt length the sharded serving
    run (:func:`serve_on_mesh`), and the cross-first decode plan.  Then the
    one-row cases' serving runs."""
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
    for name, (which, shape, profile) in CASES.items():
        cfg = port_cfg(which)
        model = build(cfg)
        cell = ShapeCell("smoke", S, B, "train")
        one, one_opt, _ = build_train(model, None, 10, 5e-3)
        rows = []
        with sharding_profile(profile):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            step, opt, sh = build_train(model, mesh, 10, 5e-3)
            params = params_onto_mesh(weights[which], sh["params"])
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
            params = params_onto_mesh(weights[which], psh["params"])
            serve = {P: serve_on_mesh(model, mesh, params, P, T) for P, T in PROMPTS.items()}
            cross_first = cross_first_plan(model, mesh, max(PROMPTS.values()))
        out[name] = dict(train=rows, serve=serve, planned=bool(step._plans),
                         coords=dict(zip(("data", "model"), mesh.get_coordinate())),
                         plan=(tp.encoder.seq_axes, tp.q_local, tp.kv_local, tp.q_slice_axes),
                         cross_first=cross_first)
    for name, (which, shape, profile) in ONE_ROW.items():
        model = build(port_cfg(which))
        with sharding_profile(profile):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            _, psh = build_prefill(model, mesh)
            params = params_onto_mesh(weights[which], psh["params"])
            out[name] = dict(serve={P: serve_on_mesh(model, mesh, params, P, T, 1)
                                    for P, T in PROMPTS.items()},
                             coords=dict(zip(("data", "model"), mesh.get_coordinate())))
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def _reference_run(model, params, jcfg, P: int, T: int, rows: int = SERVE_B) -> dict:
    """The reference's greedy serving run of ``rows`` prompts:
    ``Model.prefill``, its self cache
    padded to T positions (the cross cache as it is, as the port's
    ``seed_cache`` carries it), NEW ``Model.decode`` steps; the steps'
    logits and tokens, the prefill's and the final cache's leaves."""
    import jax
    import jax.numpy as jnp
    batch = {k: jnp.asarray(v) for k, v in prefill_inputs(jcfg, P, rows).items()}
    pcache, logits = jax.jit(model.prefill)(params, batch)
    pad = ((0, 0), (0, 0), (0, T - P), (0, 0), (0, 0))
    cache = {"self": jax.tree.map(lambda c: jnp.pad(c, pad), pcache["self"]),
             "cross": pcache["cross"]}
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
    """Per model: the reference's ``Model.init`` weights (seed 0) in float32
    compute, its ``Model.loss`` on the first train batch and its greedy
    serving run per prompt length (of the first row alone too, ``one_row``,
    where a ``ONE_ROW`` case serves it)."""
    import jax
    import jax.numpy as jnp
    from repro.models import build as jbuild
    out = {}
    for which in MODELS:
        jcfg = ref_cfg(which)
        model = jbuild(jcfg)
        params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
        loss = float(model.loss(params, {k: jnp.asarray(v)
                                         for k, v in train_batch(jcfg, 0).items()}))
        out[which] = dict(params=params, loss=loss,
                          serve={P: _reference_run(model, params, jcfg, P, T)
                                 for P, T in PROMPTS.items()})
        if any(w == which for w, _, _ in ONE_ROW.values()):
            out[which]["one_row"] = {P: _reference_run(model, params, jcfg, P, T, 1)
                                     for P, T in PROMPTS.items()}
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("encdec")
    return spawn(rank_job, 4, tmp, {w: r["params"] for w, r in reference.items()},
                 timeout=900.0)


@pytest.mark.parametrize("name", list(CASES))
def test_encdec_train_step_matches_one_device_step(ranks, reference, name):
    """Three steps from the reference's weights: on every rank the planned
    step's loss, grad norm and gradients (each leaf) against the one-device
    step's at the same parameters and optimizer state, and the first loss
    against the reference's; the plan splits the frames and the heads as the
    case names."""
    which = CASES[name][0]
    rows = [row for r in ranks for row in r[name]["train"]]
    print(name, {k: max(abs(row[k][0] - row[k][1]) / abs(row[k][1]) for row in rows)
                 for k in ("loss", "grad_norm")}, max(row["grad_leaf"] for row in rows))
    want = reference[which]["loss"]
    for r in ranks:
        got = r[name]
        assert got["planned"]
        assert got["plan"] == PLANS[name][:4]
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


@pytest.mark.parametrize("P", list(PROMPTS))
@pytest.mark.parametrize("name", list(CASES) + list(ONE_ROW))
def test_encdec_sharded_serve_matches_reference(ranks, reference, name, P):
    """Prefill, ``seed_cache`` into ``PROMPTS[P]`` positions and NEW greedy
    decode steps on the mesh, every step planned, against the reference's
    run: tokens identical, logits within 1e-5, each rank's self and cross
    cache shards (prefill's, and the decode cache's after the steps) within
    1e-6 of the reference's slice; the decode plan lays the self and the
    cross cache out as the case names.  The one-row case's plan keeps the
    weights on their ``data`` shards, the others' on none."""
    which, shape, _ = {**CASES, **ONE_ROW}[name]
    ref = reference[which]["one_row" if name in ONE_ROW else "serve"][P]
    want = ONE_ROW_PLAN if name in ONE_ROW else PLANS[name][4:] + ((),)
    errs = {"logits": 0.0, "prefill": 0.0, "decode": 0.0}
    for r in ranks:
        got = r[name]["serve"][P]
        assert got["planned"]
        assert got["plan"] + (got["stationary"],) == want, (got["plan"], got["stationary"])
        assert len(got["steps"]) == len(ref["steps"]) == NEW + 1
        for (lg, tok), (wl, wt) in zip(got["steps"], ref["steps"]):
            assert tuple(lg.shape) == wl.shape
            assert np.array_equal(tok.numpy(), wt)
            errs["logits"] = max(errs["logits"], rel(lg, wl))
        for kind in ("prefill", "decode"):
            assert len(got[kind]) == len(ref[kind]) == 4
            for (local, spec), full in zip(got[kind], ref[kind]):
                errs[kind] = max(errs[kind], _slice_err(local, spec, full, r[name]["coords"],
                                                        shape))
    print(name, P, errs)
    assert errs["logits"] <= 1e-5, errs
    assert errs["prefill"] <= CACHE_RTOL and errs["decode"] <= CACHE_RTOL, errs


@pytest.mark.parametrize("name", list(CASES))
def test_decode_plan_reads_the_self_cache_by_name(ranks, name):
    """``DecodeStep.plan`` on a cache that lists ``cross`` (the frames'
    length) before ``self`` (48 positions) keys the plan by the self
    cache's length and lays the self and the cross cache out as the case's
    plan does (the length once came from the first leaf that held a ``k``:
    the cross cache's, in sorted order)."""
    for r in ranks:
        assert r[name]["cross_first"] == (PLANS[name][5], PLANS[name][6], 48)


@pytest.mark.parametrize("name", list(CASES))
def test_seed_cache_carries_the_cross_cache(ranks, name):
    """``seed_cache`` leaves each rank's cross cache shards as the prefill
    left them, values and length (the frames' slice), whatever the decode
    cache's length: it seeds only the self cache into its slots."""
    for P in PROMPTS:
        cfg = port_cfg(CASES[name][0])
        n = math.prod(dict(zip(("data", "model"), CASES[name][1]))[ax]
                      for ax in PLANS[name][6])
        for r in ranks:
            assert r[name]["serve"][P]["cross_kept"] == [(True, cfg.enc_seq)] * 2
            got = r[name]["serve"][P]["decode"]
            assert all(local.shape[2] == cfg.enc_seq // n for local, _ in got[:2])


# ----------------------------------------------------- fake 8-rank traces
TRACE_MODELS = {"whisper-smoke": {}, "whisper-odd": ODD}
TRACE_CELLS = ("train_4k", "prefill_32k", "decode_32k")
TRACE_PROFILES = ("baseline", "serve")
TRACE = """
import dataclasses
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
import repro_torch.configs as C
from repro_torch.launch.dryrun import laid_out, make_mesh
from repro_torch.launch.steps import (abstract_cache, abstract_state, build_decode,
                                      build_prefill, build_train, input_shardings)
from repro_torch.models import build
from repro_torch.models.common import sharding_profile, sorted_leaves
from repro_torch.optim import AdamWState
from repro_torch.optim.adamw import tree_map_sorted
from repro_torch.substrate import CostCounter, fake_store, init_group, mesh_context
init_group("fake", 0, 8, store=fake_store())

out = {}
for name, over in MODELS.items():
    cfg = dataclasses.replace(C.get("whisper-tiny", smoke=True), **over)
    model = build(cfg)
    for profile in PROFILES:
        with sharding_profile(profile):
            mesh = make_mesh("single", smoke=True, device_type="cpu")
            for cell_name in CELLS:
                cell = C.smoke_cell(cell_name)
                inputs = {k: v for k, v in model.input_specs(cell).items() if k != "pos"}
                in_sh = input_shardings(inputs, mesh)
                lay = lambda tree, sh: tree_map_sorted(lambda m, s: laid_out(m, s, "cpu"),
                                                       tree, sh)
                with mesh_context(mesh), FakeTensorMode(allow_non_fake_inputs=True):
                    batch = {k: laid_out(v, in_sh[k], "cpu") for k, v in inputs.items()}
                    counter = CostCounter()
                    held = []
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
                    else:
                        step, sh = build_prefill(model, mesh)
                        params = lay(model.abstract(), sh["params"])
                        with counter:
                            step(params, batch)
                        tp, layouts, _ = step.plan(batch["tokens"])
                    if cell.kind != "decode":
                        # the rows' gathered sequence and frames, as every block gathers them
                        rows = cell.global_batch // tp.parts(tp.batch_axes)
                        held += [rows * n * cfg.d_model for n in (cell.seq_len, cfg.enc_seq)]
                    held += [w.numel() for w in sorted_leaves(tp.working(params, layouts))]
                parts = dict(batch=tp.batch_axes, seq=tp.seq_axes, qkv=tp.qkv_axes,
                             ffn=tp.ffn_axes, vocab=tp.vocab_axes, frames=tp.encoder.seq_axes
                             if tp.enc_stream_spec is not None else None,
                             cache_rows=tp.cache_row_axes, cache_seq=tp.cache_seq_axes,
                             cross_seq=tp.cross_seq_axes)
                out[f"{name}/{profile}/{cell_name}"] = dict(
                    flops=counter.flops, held=max(held), plan=parts,
                    gathers=[n for k, _, n in counter.collectives if k == "all-gather"])
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def traces():
    script = (f"MODELS = {TRACE_MODELS!r}\nCELLS = {TRACE_CELLS!r}\n"
              f"PROFILES = {TRACE_PROFILES!r}" + textwrap.dedent(TRACE))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", script],
                       env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src")),
                       capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.split("RESULT", 1)[1])


TRACE_KEYS = [(m, c, p) for m in TRACE_MODELS for c in TRACE_CELLS for p in TRACE_PROFILES]


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def smoke_parts(name: str, cell_name: str, profile: str) -> tuple:
    """The config, the cell and the ranks each logical axis of a whisper
    smoke model's ``cell_name`` splits over on the (data 4, model 2) smoke
    mesh under ``profile``, by hand from the resolved specs: the stream's
    rows and sequence (one token in decode), the heads', the MLP's and the
    vocabulary's columns, the self cache's rows and sequence and the cross
    cache's sequence (the frames'); ``wk``'s columns; a decode step's
    tables' embed axes that its rows split and, where the vocabulary does
    not split, the axes of its logits' columns."""
    import repro_torch.configs as C
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    cfg = dataclasses.replace(C.get(ARCH, smoke=True), **TRACE_MODELS[name])
    cell = C.smoke_cell(cell_name)
    sizes = {"data": 4, "model": 2}
    model = build(cfg)
    B, S = cell.global_batch, 1 if cell.kind == "decode" else cell.seq_len

    def axes(p_shape, logical, d):
        return _axes(resolve_spec(tuple(p_shape), logical, sizes, profile=profile)[d])

    def n(p_shape, logical, d):
        return math.prod(sizes[ax] for ax in axes(p_shape, logical, d))
    specs = model.specs()
    block = specs["dec_blocks"]
    cache = model.cache_specs(cell.global_batch, cell.seq_len)
    parts = dict(batch=n((B, S), ("batch", "seq"), 0), seq=n((B, S), ("batch", "seq"), 1),
                 vocab=n(specs["embed"].shape, specs["embed"].logical, 0),
                 qkv=n(block["self_attn"]["wq"].shape, block["self_attn"]["wq"].logical, 2),
                 ffn=n(block["mlp"]["w1"].shape, block["mlp"]["w1"].logical, 2),
                 cache_batch=n(cache["self"]["k"].shape, cache["self"]["k"].logical, 1),
                 cache_seq=n(cache["self"]["k"].shape, cache["self"]["k"].logical, 2),
                 cross_seq=n(cache["cross"]["k"].shape, cache["cross"]["k"].logical, 2),
                 kv=n(block["self_attn"]["wk"].shape, block["self_attn"]["wk"].logical, 2))
    if cell.kind == "decode":
        rows = axes((B, S), ("batch", "seq"), 0)
        table = [ax for ax in rows if ax in axes(specs["embed"].shape, specs["embed"].logical, 1)]
        parts["table"] = math.prod(sizes[ax] for ax in table)
        if table and parts["vocab"] == 1:
            parts["logits"] = math.prod(sizes[ax] for ax in sizes if ax not in rows)
    return cfg, cell, parts


@pytest.mark.parametrize("name,cell,profile", TRACE_KEYS)
def test_encdec_trace_flops_hand_count(traces, name, cell, profile):
    """The traced step's product FLOPs on one of 8 fake ranks equal
    ``hand_train_flops`` / ``hand_prefill_flops`` / ``hand_decode_flops``
    (the encoder's blocks at the frames, each decoder block's
    cross-attention) with the ranks each axis splits over on the smoke mesh
    (:func:`smoke_parts`)."""
    from repro_torch.models.tensor_parallel import (hand_decode_flops, hand_prefill_flops,
                                                    hand_train_flops)
    cfg, c, parts = smoke_parts(name, cell, profile)
    rec = traces[f"{name}/{profile}/{cell}"]
    fn = dict(train=hand_train_flops, prefill=hand_prefill_flops, decode=hand_decode_flops)
    print(name, cell, profile, rec["plan"], parts)
    assert rec["flops"] == fn[c.kind](cfg, c.global_batch, c.seq_len, parts)


@pytest.mark.parametrize("name,cell,profile", TRACE_KEYS)
def test_encdec_trace_gathers_no_more_than_a_shard(traces, name, cell, profile):
    """No all-gather's result in the traced step holds more elements than
    the largest of a rank's cache shards (decode), its parameters' working
    layouts and its rows' gathered sequence and frames (train and prefill):
    nothing is gathered whole that the reference keeps sharded."""
    rec = traces[f"{name}/{profile}/{cell}"]
    gathers = rec["gathers"]
    print(name, cell, profile, max(gathers), rec["held"], rec["plan"])
    assert gathers and max(gathers) <= rec["held"]
