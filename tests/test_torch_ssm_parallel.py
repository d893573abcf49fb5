"""The SSM family on a mesh: the head-parallel ``ShardedTrainStep``,
``PrefillStep`` and ``DecodeStep`` (``models.tensor_parallel``, ``models.ssm``
on a plan) on a gloo group of 4 spawned CPU ranks, from the reference's
weights (``Model.init``, carried over by ``params_onto_mesh``), in float32.

Cases: mamba2 smoke (4 heads, ``in_proj``'s 292 columns) on (data 1, model
4) under the baseline profile, one head a rank, its 73 stored columns
traded for the head's by an exchange over ``model``; on (2, 2), two heads a
rank; and under ``serve`` on (2, 2), where ``in_proj``'s columns split over
(model, data), the conv weights, ``norm`` and ``out_proj`` too, the heads
over ``model`` only (the cache's rows take ``data``) and the stream whole;
and under ``opt1`` on (2, 2), (2, 2)'s layout with the tied table's
``d_model`` axis whole over ``data`` (each case's table as the reference's
``resolve_spec`` lays it out).
Prompts of 8 tokens (shorter than the 16-token chunk), 40 (a ragged last
chunk) and 64.  Serving only, one row on (2, 2) under the baseline
(``ONE_ROW``: the first prompt of each length): the row leaves ``data``
whole, so the decode plan keeps every weight on its embed shard there
(``stationary_axes``) and moves the token; the cases of SERVE_B rows keep
none.

Held, at ``test_torch_moe_parallel.py``'s bounds: three train steps against
the port's one-device step at the same parameters and optimizer state (loss
1e-5, grad norm 1e-4, each gradient leaf 1e-4 of its largest entry; the
first loss 1e-5 of the reference's ``Model.loss``); the sharded prefill,
``seed_cache`` and 6 greedy decode steps against the reference's
``Model.prefill``, its engine's cache seeding and ``Model.decode`` (tokens
identical, logits 1e-5 of the largest, each rank's ``ssm`` and ``conv``
shards of the prefill's and the final decode cache 1e-6 of the port's
one-device caches' slices, and of the reference's within 1e-6 beyond the
one-device caches' own distance from them, as the MoE family's test holds
its shards).  Beside them: ``in_proj``'s output moved from its stored columns to
a rank's heads' against the one-device split, its gradient against its
adjoint; the gated norm across ranks against the one-device ``rmsnorm``;
and a fake 8-rank trace of mamba2 smoke's ``train_4k``, ``prefill_32k`` and
``decode_32k``: product FLOPs equal to the hand counts under both
profiles, collective bytes and executions equal to a hand count from the
specs, and no all-gather above a working layout, a cache shard or the
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

from test_torch_distributed import (check_tables, decode_ends, rel, smoke_cfg, spawn,  # noqa: E402
                                    table_specs)

ARCH = "mamba2-2.7b"
CASES = {  # name: (mesh shape, profile)
    "mamba2-1x4": ((1, 4), "baseline"),
    "mamba2-2x2": ((2, 2), "baseline"),
    "mamba2-serve-2x2": ((2, 2), "serve"),
    "mamba2-opt1-2x2": ((2, 2), "opt1"),
}
PLANS = {  # name: (the heads' axes, in_proj's stored columns' axes)
    "mamba2-1x4": (("model",), ("model",)),
    "mamba2-2x2": (("model",), ("model",)),
    "mamba2-serve-2x2": (("model",), ("model", "data")),
    "mamba2-opt1-2x2": (("model",), ("model",)),
}
ONE_ROW = {"mamba2-b1-2x2": ((2, 2), "baseline")}
TRAIN = (4, 64)                    # (B, S)
PROMPTS = (8, 40, 64)              # shorter than a chunk, a ragged last chunk, four chunks
SERVE_B, NEW, STEPS = 4, 6, 3


def prompts_for(vocab: int, P: int, rows: int = SERVE_B) -> np.ndarray:
    return np.random.default_rng(7 + P).integers(0, vocab, (SERVE_B, P)).astype(np.int32)[:rows]


def head_columns(cfg, n: int, j: int) -> np.ndarray:
    """The columns of ``in_proj``'s output (z | x, B, C | dt) that heads
    ``j`` of ``n`` read, in column order, from the widths alone."""
    di, H, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    w, h = di // n, H // n
    return np.concatenate([np.arange(w * j, w * (j + 1)), di + np.arange(w * j, w * (j + 1)),
                           2 * di + np.arange(2 * N),
                           2 * di + 2 * N + np.arange(h * j, h * (j + 1))])


def serve_one_device(model, params, tokens) -> dict:
    """The port's one-device prefill, its cache copied into the decode cache
    (an SSM cache holds no sequence) and NEW greedy decode steps: the
    prefill's and the final decode cache's leaves (sorted order)."""
    from repro_torch.launch.steps import DecodeStep, PrefillStep
    from repro_torch.models.common import sorted_leaves
    P = tokens.shape[1]
    pcache, logits = PrefillStep(model)(params, {"tokens": tokens})
    prefill = [t.clone() for t in sorted_leaves(pcache)]
    dec, cache = DecodeStep(model), pcache
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    for i in range(NEW):
        tok, logits, cache = dec(params, cache, {"tokens": tok[:, None], "pos": P + i})
    return dict(prefill=prefill, decode=sorted_leaves(cache))


def ssm_rank_job(rank, world, init, tmp, weights):
    """Every case on one 4-rank gloo group: three train steps, each beside
    the one-device step from the parameters and optimizer state the sharded
    step holds, gathered whole; then per prompt length the sharded prefill,
    ``seed_cache`` and NEW greedy decode steps, with this rank's cache
    shards.  Then the column move and the gated norm on each case's plan.
    Then the one-row cases' serving runs."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.interop import params_onto_mesh
    from repro_torch.launch.steps import (build_decode, build_prefill, build_train,
                                          input_shardings, seed_cache)
    from repro_torch.models import build
    from repro_torch.models.common import sharding_profile, sorted_leaves
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.ssm import _gated_norm
    from repro_torch.optim import AdamWState
    from repro_torch.optim.adamw import tree_map_sorted
    from repro_torch.substrate import chunk_of, full_value, gather_full, init_group, make_mesh
    import torch.nn.functional as F
    torch.set_num_threads(1)
    init_group("gloo", rank, world, init)
    cfg = smoke_cfg(ARCH)
    model = build(cfg)
    B, S = TRAIN

    def whole(tree):
        return tree_map_sorted(lambda t: full_value(t).clone(), tree)

    def shards(cache, sh):
        return [(x.to_local().clone(), s.spec) for x, s in zip(sorted_leaves(cache),
                                                                 sorted_leaves(sh))]

    def serve_runs(mesh, rows: int) -> dict:
        """Per prompt length: the sharded prefill of ``rows`` prompts,
        ``seed_cache``, NEW greedy steps, this rank's cache shards, the
        decode plan's stationary axes and (rank 0) the one-device run."""
        fwd, psh = build_prefill(model, mesh)
        params = params_onto_mesh(weights, psh["params"])
        every = whole(params)
        serve = {}
        for P in PROMPTS:
            T = P + NEW + 2
            dec, dsh = build_decode(model, mesh, ShapeCell("serve", T, rows, "decode"))
            tokens = torch.as_tensor(prompts_for(cfg.vocab, P, rows))
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
            (plan, _), = dec._plans.values()
            serve[P] = dict(steps=steps, prefill=prefill_shards,
                            decode=shards(cache, dsh["cache"]),
                            planned=bool(fwd._plans) and bool(dec._plans),
                            stationary=plan.stationary_axes,
                            one_device=serve_one_device(model, every, tokens)
                            if rank == 0 else None)
        return serve
    out = {}
    for name, (shape, profile) in CASES.items():
        cell = ShapeCell("smoke", S, B, "train")
        data = SyntheticLM(DataConfig(cfg.vocab, S, B, 0))
        one, one_opt, _ = build_train(model, None, 10, 5e-3)
        rows = []
        with sharding_profile(profile):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            step, opt, sh = build_train(model, mesh, 10, 5e-3)
            params = params_onto_mesh(weights, sh["params"])
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
            serve = serve_runs(mesh, SERVE_B)

            # in_proj's output on its stored columns -> this rank's heads'
            # columns, float64, against the one-device split; the adjoint
            n = tp.parts(tp.ssm_head_axes)
            j = chunk_of(n, mesh, tp.ssm_head_axes).start
            C = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
            full = torch.randn(2, 5, C, generator=torch.Generator().manual_seed(3),
                               dtype=torch.float64)
            x = full[..., chunk_of(C, mesh, tp.ssm_in_axes)].clone().requires_grad_(True)
            y = tp.ssm_columns(x, cfg)
            g = torch.randn(y.shape, generator=torch.Generator().manual_seed(10 + rank),
                            dtype=torch.float64)
            dx, = torch.autograd.grad(y, x, g)
            want = full[..., torch.as_tensor(head_columns(cfg, n, j))]
            move = dict(equal=bool(y.detach().equal(want)), y_g=float((y * g).sum()),
                        x_dx=float((x * dx).sum()))

            # the gated norm over d_inner with this rank's heads' channels
            gen = torch.Generator().manual_seed(5)
            yv, zv = (torch.randn(2, 3, cfg.d_inner, generator=gen) for _ in range(2))
            w = torch.rand(cfg.d_inner, generator=gen) + 0.5
            own = tp.ssm_heads(cfg.d_inner)
            got = _gated_norm(w[own], yv[..., own], zv[..., own], cfg, tp)
            ref = rmsnorm(w, yv * F.silu(zv), cfg.norm_eps)[..., own]
            norm = rel(got, ref)
        out[name] = dict(train=rows, serve=serve, move=move, norm=norm,
                         coords=dict(zip(("data", "model"), mesh.get_coordinate())),
                         plan=(tp.ssm_head_axes, tp.ssm_in_axes), tables=table_specs(sh["params"]))
    for name, (shape, profile) in ONE_ROW.items():
        with sharding_profile(profile):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            out[name] = dict(serve=serve_runs(mesh, 1),
                             coords=dict(zip(("data", "model"), mesh.get_coordinate())))
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """The reference's ``Model.init`` weights (seed 0) of mamba2 smoke in
    float32 compute, its ``Model.loss`` on the first train batch, and per
    prompt length its greedy serving run of SERVE_B rows and of the first
    row alone: the prefill's logits and cache, the cache seeded as its
    engine seeds it (``Engine._seed_cache``), NEW ``Model.decode`` steps'
    logits and tokens, and the final cache."""
    import jax
    import jax.numpy as jnp
    import repro.configs as JC
    from repro.models import build as jbuild
    from repro.serve.engine import Engine
    from repro_torch.data import DataConfig, SyntheticLM
    jcfg = dataclasses.replace(JC.get(ARCH, smoke=True), compute_dtype="float32")
    model = jbuild(jcfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    B, S = TRAIN
    batch = SyntheticLM(DataConfig(jcfg.vocab, S, B, 0)).batch(0)
    loss = float(model.loss(params, {k: jnp.asarray(v) for k, v in batch.items()}))
    prefill, dec = jax.jit(model.prefill), jax.jit(model.decode)
    serve = {}
    for rows in (SERVE_B, 1):
        for P in PROMPTS:
            T = P + NEW + 2
            pcache, logits = prefill(params, {"tokens": jnp.asarray(
                prompts_for(jcfg.vocab, P, rows))})
            cache = Engine(jcfg, params)._seed_cache(pcache, rows, T, P)
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            steps = [(np.asarray(logits), np.asarray(tok))]
            for i in range(NEW):
                logits, cache = dec(params, cache, tok[:, None], jnp.int32(P + i))
                tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
                steps.append((np.asarray(logits), np.asarray(tok)))
            serve[rows, P] = dict(steps=steps,
                                  prefill=[np.asarray(x) for x in jax.tree.leaves(pcache)],
                                  decode=[np.asarray(x) for x in jax.tree.leaves(cache)])
    return params, loss, serve


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ssm")
    return spawn(ssm_rank_job, 4, tmp, reference[0], timeout=600.0)


@pytest.mark.parametrize("name", list(CASES))
def test_ssm_train_step_matches_one_device_step(ranks, reference, name):
    """Three steps from the reference's weights: on every rank the sharded
    step's loss, grad norm and gradients (each leaf) against the one-device
    step's at the same parameters and optimizer state, and the first loss
    against the reference's; the plan splits the heads and ``in_proj``'s
    columns as the case names."""
    rows = [row for r in ranks for row in r[name]["train"]]
    print(name, {k: max(abs(row[k][0] - row[k][1]) / abs(row[k][1]) for row in rows)
                 for k in ("loss", "grad_norm")}, max(row["grad_leaf"] for row in rows))
    for r in ranks:
        got = r[name]
        assert got["plan"] == PLANS[name]
        check_tables(got["tables"], ARCH, ("data", "model"), *CASES[name])
        assert abs(got["train"][0]["loss"][1] - reference[1]) <= 1e-5 * abs(reference[1])
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


@pytest.mark.parametrize("P", PROMPTS)
@pytest.mark.parametrize("name", list(CASES) + list(ONE_ROW))
def test_ssm_sharded_serve_matches_reference(ranks, reference, name, P):
    """Prefill, ``seed_cache`` and NEW greedy decode steps on the mesh, the
    steps planned: on every rank the tokens equal the reference's, the
    logits within 1e-5 of its largest; each rank's ``ssm`` and ``conv``
    shards of the prefill's and the final decode cache within 1e-6 of the
    matching slices of the port's one-device caches, and of the
    reference's within 1e-6 beyond the one-device caches' own distance
    from them.  That distance is float32 rounding (XLA's products and
    PyTorch's on the CPU; up to 0.93e-6 on mamba2 smoke's caches), so the
    reference's caches alone cannot hold the shards to 1e-6.  The one-row
    case's decode plan keeps the weights on their ``data`` shards, the
    others' on none."""
    shape = {**CASES, **ONE_ROW}[name][0]
    ref = reference[2][1 if name in ONE_ROW else SERVE_B, P]
    one = ranks[0][name]["serve"][P]["one_device"]
    floor = {kind: max(rel(a, b) for a, b in zip(one[kind], ref[kind]))
             for kind in ("prefill", "decode")}
    errs = {"logits": 0.0, "prefill": 0.0, "decode": 0.0, "prefill_one": 0.0, "decode_one": 0.0}
    for r in ranks:
        got = r[name]["serve"][P]
        assert got["planned"]
        assert got["stationary"] == (("data",) if name in ONE_ROW else ())
        for (lg, tok), (wl, wt) in zip(got["steps"], ref["steps"]):
            assert tuple(lg.shape) == wl.shape
            assert np.array_equal(tok.numpy(), wt)
            errs["logits"] = max(errs["logits"], rel(lg, wl))
        for kind in ("prefill", "decode"):
            assert len(got[kind]) == len(ref[kind]) == len(one[kind]) == 2
            for (local, spec), full, mine in zip(got[kind], ref[kind], one[kind]):
                errs[kind] = max(errs[kind], _slice_err(local, spec, full,
                                                        r[name]["coords"], shape))
                errs[f"{kind}_one"] = max(errs[f"{kind}_one"], _slice_err(
                    local, spec, mine.numpy(), r[name]["coords"], shape))
    print(name, P, errs, "one device from the reference", floor)
    assert errs["logits"] <= 1e-5, errs
    for kind in ("prefill", "decode"):
        assert errs[f"{kind}_one"] <= 1e-6 and errs[kind] <= floor[kind] + 1e-6, (errs, floor)


@pytest.mark.parametrize("name", list(CASES))
def test_ssm_columns_move_and_adjoint(ranks, name):
    """``TensorParallel.ssm_columns`` on each plan, float64: every rank's
    result is exactly the columns its heads read of the whole output
    (:func:`head_columns`), and summed over the ranks <y, g> equals
    <x, dx> (its backward is the adjoint)."""
    moves = [r[name]["move"] for r in ranks]
    assert all(m["equal"] for m in moves)
    y_g, x_dx = sum(m["y_g"] for m in moves), sum(m["x_dx"] for m in moves)
    assert abs(y_g - x_dx) <= 1e-12 * abs(y_g), (y_g, x_dx)


@pytest.mark.parametrize("name", list(CASES))
def test_ssm_gated_norm_across_ranks(ranks, name):
    """The gated norm on each rank's heads' channels, its sum of squares
    summed over the head axes, within 1e-6 of the one-device ``rmsnorm``
    over all of d_inner (one head a rank on (1, 4))."""
    errs = [r[name]["norm"] for r in ranks]
    assert max(errs) <= 1e-6, errs


# ----------------------------------------------------- fake 8-rank traces
TRACE_CELLS = ("train_4k", "prefill_32k", "decode_32k")
TRACE_PROFILES = ("baseline", "serve")
TRACE = """
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
import repro_torch.configs as C
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.dryrun import laid_out, make_mesh
from repro_torch.launch.steps import (abstract_cache, abstract_state, build_decode,
                                      build_prefill, build_train, input_shardings)
from repro_torch.models import build
from repro_torch.models.common import sharding_profile, sorted_leaves
from repro_torch.optim import AdamWState
from repro_torch.optim.adamw import tree_map_sorted
from repro_torch.substrate import CostCounter, fake_store, init_group, mesh_context
init_group("fake", 0, 8, store=fake_store())
cfg = C.get(ARCH, smoke=True)
model = build(cfg)
out = {}
for profile in PROFILES:
    with sharding_profile(profile):
        mesh = make_mesh("single", smoke=True, device_type="cpu")
        for name in CELLS:
            cell = C.smoke_cell(name)
            inputs = {k: v for k, v in model.input_specs(cell).items() if k != "pos"}
            in_sh = input_shardings(inputs, mesh)
            lay = lambda tree, sh: tree_map_sorted(lambda m, s: laid_out(m, s, "cpu"), tree, sh)
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
                    # the rows' gathered sequence, as every block gathers it
                    held.append(cell.global_batch // tp.parts(tp.batch_axes) * cell.seq_len
                                * cfg.d_model)
                held += [w.numel() for w in sorted_leaves(tp.working(params, layouts))]
            out[f"{profile}/{name}"] = dict(
                flops=counter.flops, held=max(held),
                collectives=[(k, str(d), n) for k, d, n in counter.collectives],
                plan=dict(heads=tp.ssm_head_axes, columns=tp.ssm_in_axes))
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def traces():
    script = (f"ARCH = {ARCH!r}\nCELLS = {TRACE_CELLS!r}\nPROFILES = {TRACE_PROFILES!r}"
              + textwrap.dedent(TRACE))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", script],
                       env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.split("RESULT", 1)[1])


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _smoke_plan(cell_name: str, profile: str, mesh_kind: str = "single") -> dict:
    """mamba2 smoke's layout of ``cell_name`` on a smoke mesh (``single``:
    (data 4, model 2); ``multi``: (pod 2, data 2, model 2)) under
    ``profile``, by hand from the resolved specs: the mesh's axis sizes, the
    stream's rows and sequence, the vocabulary's axes, ``in_proj``'s
    columns', the heads' and the rows' and conv channels' of the cache (the
    decode cache of the cell's batch), a decode step's ``stationary`` axes
    (the weights' embed axes its rows leave whole: ``data`` for one row)
    and ``table`` axes (the tables' embed axes its rows split), and the
    ranks each splits over (``parts``, for the hand FLOP counts)."""
    import repro_torch.configs as C
    from repro_torch.launch.dryrun import mesh_shape
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    cfg, cell = C.get(ARCH, smoke=True), C.smoke_cell(cell_name)
    sizes = dict(zip(*reversed(mesh_shape(mesh_kind, True))))
    model = build(cfg)
    B, S = cell.global_batch, 1 if cell.kind == "decode" else cell.seq_len

    def spec(shape, logical):
        return [_axes(e) for e in resolve_spec(tuple(shape), logical, sizes, profile=profile)]
    stream = spec((B, S), ("batch", "seq"))
    C_ = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    cache = model.cache_specs(cell.global_batch, cell.seq_len)["pos0"]
    ssm = spec(cache["ssm"].shape, cache["ssm"].logical)
    conv = spec(cache["conv"].shape, cache["conv"].logical)
    table = spec((cfg.vocab, cfg.d_model), ("vocab", "embed_d"))
    proj = spec((cfg.d_model, C_), ("embed", "ssm_inner"))
    stationary = tuple(ax for ax in sizes if ax in table[1] + proj[0] and ax not in stream[0]) \
        if cell.kind == "decode" else ()
    plan = dict(cfg=cfg, cell=cell, sizes=sizes, batch=stream[0], seq=stream[1],
                vocab=table[0], columns=proj[1], heads=ssm[2], cache_batch=ssm[1], conv=conv[3],
                stationary=stationary, table=tuple(ax for ax in stream[0] if ax in table[1])
                if cell.kind == "decode" else ())
    parts = {k: _n(plan[k], plan) for k in ("batch", "seq", "vocab", "cache_batch", "conv",
                                            "table")}
    parts.update(ssm_inner=_n(plan["columns"], plan), ssm_heads=_n(plan["heads"], plan),
                 embed=_n(plan["stationary"], plan))
    return dict(plan, parts=parts)


def _n(axes, plan: dict) -> int:
    return math.prod(plan["sizes"][ax] for ax in axes)


@pytest.mark.parametrize("profile", TRACE_PROFILES)
@pytest.mark.parametrize("cell", TRACE_CELLS)
def test_ssm_trace_flops_hand_count(traces, cell, profile):
    """The traced step's product FLOPs on one of 8 fake ranks equal
    ``hand_train_flops`` / ``hand_prefill_flops`` / ``hand_decode_flops``
    with the ranks each axis splits over on the smoke mesh, and the plan's
    heads and columns are the specs'."""
    from repro_torch.models.tensor_parallel import (hand_decode_flops, hand_prefill_flops,
                                                    hand_train_flops)
    plan = _smoke_plan(cell, profile)
    rec = traces[f"{profile}/{cell}"]
    assert tuple(rec["plan"]["heads"]) == plan["heads"]
    assert tuple(rec["plan"]["columns"]) == plan["columns"]
    c = plan["cell"]
    hand = dict(train=hand_train_flops, prefill=hand_prefill_flops,
                decode=hand_decode_flops)[c.kind]
    assert rec["flops"] == hand(plan["cfg"], c.global_batch, c.seq_len, plan["parts"])


def _ssm_keep(path: str, p, spec, plan: dict) -> tuple[str, ...]:
    """The mesh axes a parameter's working layout keeps under ``plan``:
    none for the SSM's conv weights (whole), the heads' axes for its norm's
    and ``out_proj``'s ``ssm_inner`` rows, else all but the embed axes, the
    tables' ``table`` axes kept (on a one-row decode plan
    ``test_torch_analysis._stationary_keep``)."""
    if plan["stationary"]:
        from test_torch_analysis import _stationary_keep
        return _stationary_keep(path, p, spec, plan)
    name = path.rsplit("/", 1)[-1]
    if "ssm_inner" in p.logical and name in ("conv_w", "conv_b"):
        return ()
    kept = plan["table"] if path in ("/embed", "/unembed") else ()
    return tuple(ax for e, lname in zip(spec, p.logical) for ax in (
        tuple(a for a in _axes(e) if a in kept) if lname in ("embed", "embed_d")
        else plan["heads"] if lname == "ssm_inner" and name in ("norm", "out_proj")
        else _axes(e)))


def _sent_columns(cfg, n_cols: int, n_heads: int) -> int:
    """The columns of its stored chunk that rank 0 sends (itself included)
    in the exchange that gives each rank its heads' columns."""
    di, H, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    own = set(range((2 * di + 2 * N + H) // n_cols))
    return sum(len(own & set(head_columns(cfg, n_heads, j).tolist())) for j in range(n_heads))


def _hand_ssm_collectives(cell_name: str, mesh_kind: str = "single") -> tuple[int, dict]:
    """Per-device bytes and executions of mamba2 smoke's sharded step under
    the baseline profile on a smoke mesh (decode: either; train and
    prefill: ``single``), from the specs (the stream and the weights of
    the serving steps in bf16; the norms' sums, the loss's and the logits
    in float32):

    * each parameter gathered over the axes its working layout drops: the
      embed axes; ``conv_w`` and ``conv_b`` whole (float32 in train); a
      block's where its period runs, and again in train's recompute
      (``test_torch_analysis._weight_gathers``);
    * the embedding over the split vocabulary: the tokens' sequence gathered
      (int32) and the partial rows into the stream (decode, and its
      unembedding and greedy token: ``test_torch_distributed.decode_ends``);
    * each layer, forward: the stream's sequence gathered, ``in_proj``'s
      output exchanged to the heads' columns (the result: every column the
      heads read), the gated norm's sum of squares summed over the heads,
      ``out_proj``'s partial sums reduce-scattered into the slice; prefill:
      the last k - 1 positions' x channels gathered over the heads; train:
      the recompute again but for the reduce-scatter, then each one's
      adjoint (the exchange's returns what rank 0 sent); decode: the
      one-token row and the conv history's rows gathered, the norm's sum
      and ``out_proj``'s partial sums summed (one row, whose plan keeps the
      weights on their embed shards:
      ``test_torch_analysis._stationary_decode_wire``);
    * train: the loss as the dense step's (``test_torch_analysis``), the
      label counts, the loss, each working gradient into its layout (a
      block's a period at a time) and the squared norms; prefill: the last
      token over the sequence (the logits stay where they are computed)."""
    from repro_torch.models.common import resolve_spec
    from test_torch_analysis import (SMOKE_MESH, _count, _per_period, _periods, _pspec_paths,
                                     _stationary_decode_wire, _Stream, _tp_reduction,
                                     _weight_gathers)
    from repro_torch.models import build
    plan = _smoke_plan(cell_name, "baseline", mesh_kind)
    if plan["stationary"]:
        return _count(_stationary_decode_wire(plan))
    sizes = plan["sizes"]
    cfg, cell = plan["cfg"], plan["cell"]
    B, S, D, V = cell.global_batch, cell.seq_len, cfg.d_model, cfg.vocab
    di, H, N, k = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv
    nh, nc = _n(plan["heads"], plan), _n(plan["columns"], plan)
    R = B // _n(plan["batch"], plan)
    bf, f32, i32 = 2, 4, 4
    wire = []

    def add(ops, itemsize):
        wire.extend((kind, n * itemsize) for kind, n in ops)
    train = cell.kind == "train"
    leaves = []
    for path, p in _pspec_paths(build(cfg).specs()):
        spec = resolve_spec(p.shape, p.logical, sizes)
        keep = _ssm_keep(path, p, spec, plan)
        leaves.append((path, p, spec, keep))
        add(_weight_gathers(path, p, spec, sizes, keep, train), f32 if train else bf)
    st = _Stream(dict(seq=plan["seq"]))
    vocab = plan["vocab"]
    assert vocab and plan["heads"] == plan["columns"] == ("model",)
    cols = 2 * di // nh + 2 * N + H // nh
    if cell.kind == "decode":
        Rc = B // _n(plan["cache_batch"], plan)
        emb, ends = decode_ends(R, D, V, sizes, plan["batch"], vocab, table=plan["table"])
        wire += emb
        for _ in range(cfg.n_layers):
            add([("all-gather", R * (2 * di + 2 * N + H)),
                 ("all-gather", Rc * (k - 1) * (di + 2 * N))] + st.sum(R * D, plan["heads"]), bf)
            add(st.sum(R, plan["heads"]), f32)
        wire += ends
    else:
        assert plan["seq"] == plan["heads"] and sizes == SMOKE_MESH
        Sl = S // _n(plan["seq"], plan)
        full, own = R * S * D, R * Sl * D
        add(st.gather(R * Sl), i32)
        add(st.to_stream(full, vocab) + (st.to_stream_back(full, vocab) if train else []), bf)
        for _ in range(cfg.n_layers):
            add(st.gather(own) + [("all-to-all", R * S * cols)] + st.scatter(full), bf)
            add(st.sum(R * S, plan["heads"]), f32)
            if train:
                add(st.gather(own) + [("all-to-all", R * S * cols)], bf)
                add(st.sum(R * S, plan["heads"]) * 2, f32)
                add(st.gather(own)
                    + [("all-to-all", R * S * _sent_columns(cfg, nc, nh))] + st.scatter(full), bf)
            else:
                add([("all-gather", R * (k - 1) * di)], bf)
        if train:
            add(st.gather(own) + st.scatter(full), bf)
            add(st.gather(R * Sl), i32)
            c = min(cfg.loss_chunk, S)
            add(st.sum(R * c, vocab) * 8 * (-(-S // c)), f32)
            every = tuple(SMOKE_MESH)
            add(st.sum(1, every) * 2 + st.sum(len(leaves), every), f32)
            for path, p, spec, keep in leaves:
                add(_per_period(_tp_reduction(math.prod(p.shape), spec, keep, SMOKE_MESH),
                                _periods(path, p)), f32)
        else:
            add(st.gather(R * D), bf)
    counts: dict = {}
    for kind, _ in wire:
        counts[kind] = counts.get(kind, 0) + 1
    return sum(b for _, b in wire), counts


@pytest.mark.parametrize("cell", TRACE_CELLS)
def test_ssm_trace_collectives_hand_count(traces, cell):
    """The traced step's collective bytes a device and its executions of
    each kind under the baseline profile equal the hand count from the
    specs (:func:`_hand_ssm_collectives`)."""
    from repro_torch.launch.hlo_stats import collective_stats
    rec = traces[f"baseline/{cell}"]
    dt = {"torch.bfloat16": torch.bfloat16, "torch.float32": torch.float32,
          "torch.int32": torch.int32, "torch.int64": torch.int64}
    st = collective_stats([(k, dt[d], n) for k, d, n in rec["collectives"]], 8)
    want, counts = _hand_ssm_collectives(cell)
    assert st["op_counts"] == counts
    assert st["collective_bytes_per_device"] == want


@pytest.mark.parametrize("profile", TRACE_PROFILES)
@pytest.mark.parametrize("cell", TRACE_CELLS)
def test_ssm_trace_gathers_no_more_than_a_shard(traces, cell, profile):
    """No all-gather's result in the traced step holds more elements than
    the largest of a rank's cache shards (decode), its parameters' working
    layouts and its rows' gathered sequence (train and prefill): nothing is
    gathered whole that the reference keeps sharded but the small leaves
    and decode's one-token rows."""
    rec = traces[f"{profile}/{cell}"]
    gathers = [n for k, _, n in rec["collectives"] if k == "all-gather"]
    print(cell, profile, max(gathers), rec["held"])
    assert gathers and max(gathers) <= rec["held"]
