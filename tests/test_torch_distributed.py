"""The port's distribution substrate across ranks: gloo process groups of 4 and
2 spawned CPU processes run the GPipe forward, the int8 compressed psum, the
sharded train step, the meshed ``Trainer`` (recovery and the elastic restore
onto a smaller mesh), sharded prefill and decode and checkpoints, against the
reference's numbers on the same inputs.

Each group runs once per module (a fixture) and writes what it measured; the
tests below read it.  The ranks import this module, so the reference package
is imported only inside the parent's fixtures.

Tolerances: the pipeline within 1e-5 relative of the reference's scanned
``forward_full`` (``tests/test_pipeline.py``'s bound); the compressed psum and
every checkpoint bit for bit; the sharded step within 1e-5 relative on the
loss and 1e-4 on the grad norm and each gradient leaf (of its largest entry)
of the one-device step; recovery on a mesh within 2e-4
(``tests/test_system.py``); the elastic restore within 2e-2 of an
unresharded run (``tests/test_elastic.py``); decode tokens identical.
"""
import dataclasses
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

PIPE_B, PIPE_S = 8, 16
SMOKE = dict(seq_len=32, global_batch=8, kind="train")
PSUM_N = 4096
# the encoder-decoder's planned meshed train step (it ran ZeRO-3 until every
# family had a plan): name -> (arch, mesh shape); on (data 4, model 1), on
# (2, 2) and on (1, 4), fed seeded encoder frames
ZERO3_CASES = {"whisper-tiny-4x1": ("whisper-tiny", (4, 1)),
               "whisper-tiny": ("whisper-tiny", (2, 2)),
               "whisper-tiny-1x4": ("whisper-tiny", (1, 4))}
ZERO3_ARCHS = sorted({arch for arch, _ in ZERO3_CASES.values()})


# ------------------------------------------------------------------ spawning
def spawn(fn, nprocs: int, tmp, *args, timeout: float = 240.0) -> list:
    """Run ``fn(rank, world, init_method, tmp, *args)`` on ``nprocs`` spawned
    ranks with a deadline; returns each rank's result (``tmp/rank{r}.pt``)."""
    ctx = mp.start_processes(fn, args=(nprocs, f"file://{tmp}/rendezvous", str(tmp), *args),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__} on {nprocs} ranks ran past {timeout} s")
    return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(nprocs)]


def _join(rank, world, init):
    from repro_torch.substrate import init_group
    torch.set_num_threads(2)
    init_group("gloo", rank, world, init)


def N(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rel(got, want) -> float:
    got, want = N(got), N(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def smoke_cfg(arch: str, **kw):
    import repro_torch.configs as TC
    return dataclasses.replace(TC.get(arch, smoke=True), compute_dtype="float32", **kw)


TABLES = ("embed", "unembed")


def decode_ends(R: int, D: int, V: int, sizes: dict, batch, vocab, table=(),
                stationary=()) -> tuple[list, list]:
    """(the embedding's, the unembedding's and greedy token's) collectives
    of a sharded decode step, (kind, bytes a device) each, from its plan's
    axes: ``R`` stream rows a rank, the rows' ``batch`` axes, the
    vocabulary's, the tables' embed axes the rows split (``table``) and the
    weights' embed axes they leave whole (``stationary``).  A sum over an
    axis is an all-reduce (twice its elements), a gather an all-gather an
    axis (the minor first, each its result); the token ids int32, the
    tables' rows and the stream bf16, the logits float32.

    * the embedding: the rows' token ids gathered over ``table``; the
      looked-up rows summed over the vocab axes (R rows of the stationary
      axes' share of D, or every row of ``table`` on its share); one
      all-to-all bringing each row's columns to its rank, or the columns
      gathered over ``stationary``;
    * the unembedding: the partial logits summed over ``stationary`` (bf16),
      or the inverse all-to-all and the partial logits of every row of
      ``table`` reduce-scattered onto the rows, on this rank's columns
      (``ceil(V / parts)`` of the logit axes: the vocabulary's, else the
      axes the rows leave whole);
    * the greedy token: each row's maximum with its NaN flag and then its
      least index (int64) summed over the logit axes as maxima, the tokens
      gathered over ``batch``."""
    def n(axes) -> int:
        return math.prod(sizes[ax] for ax in axes)

    def gathered(m: int, axes, itemsize: int) -> list:
        out = []
        for ax in reversed(axes):
            m *= sizes[ax]
            out.append(("all-gather", m * itemsize))
        return out
    assert len(table) <= 1 and not (table and stationary)
    cols = vocab if vocab or not table else tuple(ax for ax in sizes if sizes[ax] > 1
                                                  and ax not in batch)
    e = n(stationary)
    emb = gathered(R, table, 4) + [("all-reduce", 2 * R * D // e * 2)] * len(vocab) \
        + [("all-to-all", R * D * 2)] * len(table) + gathered(R * D // e, stationary, 2)
    out = [("all-reduce", 2 * R * V // n(vocab) * 2)] * len(stationary) \
        + [("all-to-all", R * D * 2)] * len(table) \
        + [("reduce-scatter", R * -(-V // n(cols)) * 4)] * len(table) \
        + [("all-reduce", 2 * R * 2 * 4), ("all-reduce", 2 * R * 8)] * len(cols) \
        + gathered(R, batch, 4)
    return emb, out


def table_specs(shardings) -> dict:
    """The (un)embedding tables' spec entries of a ``param_shardings`` tree."""
    return {k: shardings[k].spec for k in TABLES if k in shardings}


def check_tables(got: dict, arch: str, axes, shape, profile: str, **kw) -> None:
    """The (un)embedding tables' specs (``table_specs``) equal the
    reference's ``resolve_spec`` under ``profile`` for the smoke config (with
    ``kw``'s changes) on a mesh of ``shape`` over ``axes``; under ``opt1``
    neither table is split over ``data``."""
    import repro.configs as JC
    from repro.models import build as jbuild
    from repro.models.common import resolve_spec
    specs = jbuild(dataclasses.replace(JC.get(arch, smoke=True), **kw)).specs()
    sizes = dict(zip(axes, shape))
    want = {k: tuple(resolve_spec(specs[k].shape, specs[k].logical, sizes, profile=profile))
            for k in TABLES if k in specs}
    assert got == want, (got, want)
    if profile == "opt1":
        assert not any("data" in (e if isinstance(e, tuple) else (e,))
                       for spec in got.values() for e in spec), got


def smoke_batch(cfg, data, i: int, shardings=None) -> dict:
    """Smoke train batch ``i`` of ``data`` (a ``SyntheticLM``): its tokens and
    labels, with an encoder-decoder's frames seeded normal, laid out by
    ``shardings`` (``input_shardings``) or whole on the CPU."""
    from repro_torch.substrate import distribute
    batch = data.device_batch(i, "cpu") if shardings is None else \
        data.sharded_batch(i, shardings)
    if cfg.family == "encdec":
        frames = torch.as_tensor(np.random.default_rng(50 + i).standard_normal(
            (SMOKE["global_batch"], cfg.enc_seq, cfg.d_model)).astype(np.float32))
        batch["frames"] = frames if shardings is None else distribute(frames,
                                                                       shardings["frames"])
    return batch


def pipe_cfg(layers: int):
    return smoke_cfg("granite-3-8b", n_layers=layers, remat="none")


# ------------------------------------------------------------- four ranks
def four_rank_job(rank, world, init, tmp, ref):
    """On a 4-rank gloo group: the pipeline at 1 and 2 layers a stage; the
    sharded step on (data 2, model 2), minicpm's and the encoder-decoder's
    (both tensor-parallel); the meshed Trainer with a failure,
    the elastic run's first half and an unresharded run; the reference's
    checkpoint restored onto the mesh and saved again; each rank's rows and
    the round trip of a tuple spec; sharded prefill and decode."""
    _join(rank, world, init)
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.interop import params_from_reference, params_onto_mesh
    from repro_torch.launch.pipeline import pipeline_forward
    from repro_torch.launch.steps import build_decode, build_prefill, build_train, input_shardings
    from repro_torch.models import build, transformer
    from repro_torch.models.common import init_params, sorted_leaves
    from repro_torch.models.layers import rmsnorm
    from repro_torch.optim import AdamWState
    from repro_torch.optim.adamw import tree_map_sorted
    from repro_torch.substrate import Sharding, distribute, full_value, gather_full, make_mesh
    from repro_torch.train import Trainer, TrainerConfig
    out = {}

    pipe = make_mesh((4,), ("pipe",), device_type="cpu")
    for layers, params in ref["pipe"].items():
        cfg = pipe_cfg(layers)
        p = params_from_reference(params, "cpu")
        x = transformer.embed_tokens(p, cfg, torch.as_tensor(ref["tokens"]))
        h = pipeline_forward(cfg, p["blocks"], x, pipe, n_micro=4)
        out[f"pipe{layers}"] = rmsnorm(p["final_norm"], h, cfg.norm_eps)

    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    cell = ShapeCell("smoke", **SMOKE)

    def meshed_steps(cfg, weights, mesh=mesh):
        """Step 1's gradients, then three steps' losses and grad norms of
        ``build_train(model, mesh)`` from ``weights``, and whether the step
        took the tensor-parallel path (it keeps a plan)."""
        model = build(cfg)
        step, opt, sh = build_train(model, mesh, 10, 5e-3)
        params = params_onto_mesh(weights, sh["params"])
        state = opt.init(params)
        in_sh = input_shardings(model.input_specs(cell), mesh)
        data = SyntheticLM(DataConfig(cfg.vocab, cell.seq_len, cell.global_batch, 0))
        _, grads = step.loss_and_grads(params, smoke_batch(cfg, data, 0, in_sh))
        res = dict(grads=[full_value(g) for g in sorted_leaves(grads)], steps=[])
        for i in range(3):
            params, state, m = step(params, state, smoke_batch(cfg, data, i, in_sh))
            res["steps"].append((float(m["loss"]), float(m["grad_norm"])))
        res["tensor_parallel"] = bool(step._plans)
        return res
    cfg = smoke_cfg("minicpm-2b")
    model = build(cfg)
    out.update(meshed_steps(cfg, ref["train"]))
    out["zero3"] = {name: meshed_steps(smoke_cfg(arch), ref["zero3"][arch],
                                       make_mesh(shape, ("data", "model"), device_type="cpu"))
                    for name, (arch, shape) in ZERO3_CASES.items()}

    for name, steps, kw in (("elastic", 6, {}), ("unresharded", 10, {"ckpt_every": 100}),
                            ("failed", 10, {"fail_at_steps": (5,)})):
        tcfg = TrainerConfig(steps=steps, ckpt_every=kw.pop("ckpt_every", 3),
                             ckpt_dir=f"{tmp}/{name}", log_every=1, **kw)
        tr = Trainer(cfg, cell, tcfg, lambda: make_mesh((2, 2), ("data", "model"),
                                                        device_type="cpu"), device="cpu")
        out[name] = tr.run()
    out["mesh_shape"] = tuple(tr.mesh.mesh.shape)

    _, opt, model_sh = build_train(model, mesh)
    like = {"params": model.abstract(), "opt": opt.init(model.abstract())}
    got = ckpt.restore(f"{tmp}/ref_ckpt", 3, like, model_sh)
    out["restored_sharded"] = [any(p.is_shard() for p in x.placements) for x in sorted_leaves(got)]
    ckpt.save(f"{tmp}/resaved", 3, got)

    for spec in (("model", "data"), (("model", "data"), None), (("data", "model"), None)):
        full = torch.arange(32.0).reshape(8, 4)
        d = distribute(full, Sharding(mesh, spec))
        out[f"rows{spec}"] = (d.to_local(), bool(full_value(d).equal(full)))

    gcfg = smoke_cfg("granite-3-8b")
    gmodel = build(gcfg)
    gp = gmodel.init(torch.Generator().manual_seed(0), "cpu")
    dcell = ShapeCell("decode", 16, 4, "decode")
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, gcfg.vocab, (4, 6)),
                           dtype=torch.int32)
    runs = {}
    for name, m in (("mesh", mesh), ("one", None)):
        if m is None:
            from repro_torch.launch.steps import DecodeStep, PrefillStep
            fwd, dec, p = PrefillStep(gmodel), DecodeStep(gmodel), gp
            cache = init_params(gmodel.cache_specs(4, 16), None, "cpu")
        else:
            fwd, psh = build_prefill(gmodel, m)
            dec, dsh = build_decode(gmodel, m, dcell)
            p = tree_map_sorted(distribute, gp, psh["params"])
            cache = tree_map_sorted(distribute, init_params(gmodel.cache_specs(4, 16), None, "cpu"),
                                    dsh["cache"])
        _, logits = fwd(p, {"tokens": toks})
        logits = gather_full(logits)
        seq = []
        tok = toks[:, :1]
        for pos in range(6):
            nxt, _, cache = dec(p, cache, {"tokens": tok, "pos": pos})
            seq.append(nxt)
            tok = nxt[:, None]
        runs[name] = (logits, torch.stack(seq, 1))
    out["decode"] = runs
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def two_rank_job(rank, world, init, tmp, xs):
    """On a 2-rank gloo group: the compressed psum over ``pod``, and the
    elastic run's second half: the 4-rank run's step-6 checkpoint restored
    onto a (data 2, model 1) mesh and trained on to step 10."""
    _join(rank, world, init)
    from repro_torch.configs.base import ShapeCell
    from repro_torch.optim.grad_compress import compressed_psum
    from repro_torch.substrate import make_mesh
    from repro_torch.train import Trainer, TrainerConfig
    out = {}
    pods = make_mesh((2,), ("pod",), device_type="cpu")
    out["psum"] = compressed_psum(torch.as_tensor(np.concatenate(xs)), pods)

    cfg = smoke_cfg("minicpm-2b")
    tr = Trainer(cfg, ShapeCell("smoke", **SMOKE),
                 TrainerConfig(steps=10, ckpt_every=100, ckpt_dir=f"{tmp}/elastic", log_every=1),
                 lambda: make_mesh((2, 1), ("data", "model"), device_type="cpu"), device="cpu")
    out["mesh_shape"] = tuple(tr.mesh.mesh.shape)
    p_like, o_like = tr._fresh_state()
    start, tree = tr._restore_latest(p_like, o_like)
    params, opt = tree["params"], tree["opt"]
    losses = {}
    for step in range(start, 11):
        params, opt, m = tr.step_fn(params, opt, tr.data.sharded_batch(step - 1, tr.in_sh))
        losses[step] = float(m["loss"])
    out["start"], out["losses"] = start, losses
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


# ------------------------------------------------------------------ fixtures
def ref_state(model, seed: int):
    """The reference's params (``Model.init``) and an AdamW state with a
    count of 3 and random moments, as numpy trees."""
    import jax
    from repro.optim import AdamW, AdamWState
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    opt = AdamW(lr=1.0).init(params)
    rand = lambda t: jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), t)  # noqa: E731
    return params, AdamWState(np.asarray(3, np.int32), rand(opt.m), rand(opt.v))


@pytest.fixture(scope="module")
def reference():
    """The reference's weights and results on the parent's CPU: granite
    smoke (``tests/test_pipeline.py``'s config, and at 8 layers) and its
    scanned ``forward_full``; the initial weights of minicpm smoke and of
    the smoke configs of ``ZERO3_ARCHS``; a reference
    checkpoint of a minicpm state; the compressed psum's inputs."""
    import jax.numpy as jnp
    import repro.configs as JC
    from repro.models import build as jbuild
    from repro.models import transformer as jtransformer
    pipe, hidden = {}, {}
    for layers in (4, 8):
        cfg = dataclasses.replace(JC.get("granite-3-8b", smoke=True), n_layers=layers,
                                  compute_dtype="float32", remat="none")
        import jax
        params = jbuild(cfg).init(jax.random.PRNGKey(0))
        tokens = np.random.default_rng(0).integers(0, cfg.vocab, (PIPE_B, PIPE_S)).astype(np.int32)
        hidden[layers] = np.asarray(jtransformer.forward_full(params, cfg, tokens=jnp.asarray(tokens))[0])
        pipe[layers] = jax.tree.map(np.asarray, params)
    jcfg = dataclasses.replace(JC.get("minicpm-2b", smoke=True), compute_dtype="float32")
    train, _ = ref_state(jbuild(jcfg), 0)
    zero3 = {arch: ref_state(jbuild(dataclasses.replace(JC.get(arch, smoke=True),
                                                        compute_dtype="float32")), 0)[0]
             for arch in ZERO3_ARCHS}
    state = ref_state(jbuild(jcfg), 1)
    rng = np.random.default_rng(4)
    xs = [(rng.standard_t(3, PSUM_N) * s).astype(np.float32) for s in (0.5, 40.0)]
    return dict(tokens=tokens, pipe=pipe, hidden=hidden, train=train, state=state, xs=xs,
                zero3=zero3)


@pytest.fixture(scope="module")
def four(reference, tmp_path_factory):
    import repro.checkpoint as jckpt
    tmp = tmp_path_factory.mktemp("four")
    params, opt = reference["state"]
    jckpt.save(tmp / "ref_ckpt", 3, {"params": params, "opt": opt})
    ref = {k: reference[k] for k in ("tokens", "pipe", "train", "zero3")}
    return tmp, spawn(four_rank_job, 4, tmp, ref)


@pytest.fixture(scope="module")
def two(four, reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    (four[0] / "elastic").rename(tmp / "elastic")
    return spawn(two_rank_job, 2, tmp, reference["xs"])


# --------------------------------------------------------------------- tests
@pytest.mark.parametrize("layers", [4, 8])
def test_pipeline_forward_matches_reference(four, reference, layers):
    """GPipe over 4 pipe ranks, n_micro = 4, from the reference's weights:
    within 1e-5 of the reference's scanned ``forward_full`` on every rank,
    at one layer a stage (``tests/test_pipeline.py``'s config) and at two,
    where the reference's own pipeline raises (ROADMAP Queue 3)."""
    _, ranks = four
    for r in ranks:
        assert rel(r[f"pipe{layers}"], reference["hidden"][layers]) < 1e-5


def test_reference_pipeline_raises_at_two_layers_a_stage():
    """The reference's ``pipeline_forward`` scans a stage's (1, 2, ...)
    block over its leading axis of one, so each product broadcasts the two
    layers against the microbatch: ValueError (ROADMAP Queue 3)."""
    from conftest import run_isolated_script
    run_isolated_script("""
        import dataclasses
        import numpy as np
        import jax, jax.numpy as jnp
        from jax.sharding import Mesh
        import repro.configs as C
        from repro.models.model import build
        from repro.models import transformer
        from repro.launch.pipeline import pipeline_forward
        cfg = dataclasses.replace(C.get("granite-3-8b", smoke=True), n_layers=8,
                                  compute_dtype="float32", remat="none")
        params = build(cfg).init(jax.random.PRNGKey(0))
        mesh = Mesh(np.array(jax.devices()).reshape(4), ("pipe",))
        x = transformer.embed_tokens(params, cfg, jnp.zeros((8, 16), jnp.int32))
        try:
            pipeline_forward(cfg, params["blocks"], x, mesh, n_micro=4)
        except ValueError as e:
            assert "broadcast" in str(e), e
            print("RAISES")
    """, fake_devices=4, marker="RAISES", timeout=120)


def test_compressed_psum_is_bit_equal_to_reference_formula(two, reference):
    """Two pod ranks, each quantizing its part of a heavy-tailed tensor:
    every rank's sum equals the reference's body (``_quant`` per part,
    then ``jnp.sum`` of the dequantized parts) bit for bit."""
    import jax.numpy as jnp
    from repro.optim.grad_compress import _quant
    parts = [_quant(jnp.asarray(x)) for x in reference["xs"]]
    qs = jnp.stack([q for q, _ in parts])
    ss = jnp.stack([s for _, s in parts])
    want = np.asarray(jnp.sum(qs.astype(jnp.float32) * ss.reshape(-1, 1), axis=0))
    for r in two:
        got = r["psum"].numpy()
        assert got.dtype == np.float32 and got.shape == (PSUM_N,)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def one_device_steps(arch: str, weights):
    """The port's one-device step in float32 from ``weights`` on the smoke
    batches: step 1's gradients, then three steps' losses and grad norms."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.interop import params_from_reference
    from repro_torch.launch.steps import build_train
    from repro_torch.models import build
    from repro_torch.models.common import sorted_leaves
    cfg = smoke_cfg(arch)
    cell = ShapeCell("smoke", **SMOKE)
    step, opt, _ = build_train(build(cfg), None, 10, 5e-3)
    params = params_from_reference(weights, "cpu")
    state = opt.init(params)
    data = SyntheticLM(DataConfig(cfg.vocab, cell.seq_len, cell.global_batch, 0))
    _, grads = step.loss_and_grads(params, smoke_batch(cfg, data, 0))
    steps = []
    for i in range(3):
        params, state, m = step(params, state, smoke_batch(cfg, data, i))
        steps.append((float(m["loss"]), float(m["grad_norm"])))
    return sorted_leaves(grads), steps


def check_meshed_steps(runs: list, grads, steps) -> None:
    """Each rank's meshed run (``meshed_steps``) against the one-device
    step's: every gradient leaf within 1e-4 of its largest entry, each
    loss within 1e-5 and grad norm within 1e-4 relative, the same on every
    rank."""
    for r in runs:
        assert len(r["grads"]) == len(grads)
        for got_g, want_g in zip(r["grads"], grads):
            assert rel(got_g, want_g) <= 1e-4
        for (gl, gn), (wl, wn) in zip(r["steps"], steps):
            assert abs(gl - wl) <= 1e-5 * abs(wl) and abs(gn - wn) <= 1e-4 * abs(wn)
        assert r["steps"] == runs[0]["steps"]


def test_sharded_train_step_matches_one_device_step(four, reference):
    """(data 2, model 2), minicpm smoke in float32 from the reference's
    weights (the dense family: the tensor-parallel step): the gradients of
    step 1 and three steps' losses and grad norms against the port's
    one-device step on the same batches."""
    _, ranks = four
    assert all(r["tensor_parallel"] for r in ranks)
    check_meshed_steps(ranks, *one_device_steps("minicpm-2b", reference["train"]))


@pytest.mark.parametrize("name", list(ZERO3_CASES))
def test_zero3_train_step_matches_one_device_step(four, reference, name):
    """The encoder-decoder's smoke config (whisper) on (data 4, model 1),
    (2, 2) and (1, 4), in float32 from the reference's weights and seeded
    frames, through the planned (tensor-parallel) step every family runs on
    a mesh (its ZeRO-3 step until then): the gradients of step 1 and three
    steps' losses and grad norms against the port's one-device step on the
    same batches, at the tensor-parallel step's bounds."""
    _, ranks = four
    arch = ZERO3_CASES[name][0]
    runs = [r["zero3"][name] for r in ranks]
    assert all(r["tensor_parallel"] for r in runs)
    check_meshed_steps(runs, *one_device_steps(arch, reference["zero3"][arch]))


def test_recovery_on_a_mesh_reproduces_unfailed_run(four):
    """The meshed Trainer on (data 2, model 2): a failure at step 5 re-forms
    the mesh, restores the step-3 checkpoint and matches the unfailed run's
    losses after it within 2e-4."""
    _, ranks = four
    r = ranks[0]
    assert r["mesh_shape"] == (2, 2)
    la = {m["step"]: m["loss"] for m in r["unresharded"] if "loss" in m}
    lb = {m["step"]: m["loss"] for m in r["failed"] if "loss" in m}
    assert sum("restart" in str(m.get("event")) for m in r["failed"]) == 1
    for s in range(6, 11):
        assert lb[s] == pytest.approx(la[s], rel=2e-4), s


def test_elastic_restore_onto_a_smaller_mesh(four, two):
    """Train 6 steps on (data 2, model 2), checkpoint every 3, restore the
    step-6 checkpoint onto (data 2, model 1) and train on: steps 7-10 within
    2e-2 of the unresharded run's (the reference's bound)."""
    _, ranks = four
    ref = {m["step"]: m["loss"] for m in ranks[0]["unresharded"] if "loss" in m}
    for r in two:
        assert r["mesh_shape"] == (2, 1) and r["start"] == 7
        errs = {s: abs(loss - ref[s]) / abs(ref[s]) for s, loss in r["losses"].items()}
        print("elastic restore: relative loss error by step", errs)
        assert sorted(errs) == [7, 8, 9, 10] and max(errs.values()) < 2e-2, errs


def test_checkpoints_cross_between_packages_on_a_mesh(four, reference):
    """A reference checkpoint restores onto the (2, 2) mesh as sharded
    leaves, and the port, saving it again from the mesh, writes the
    reference's files byte for byte (manifest, CRCs and shards); the
    reference restores that checkpoint bit for bit."""
    import jax
    import repro.checkpoint as jckpt
    tmp, ranks = four
    assert any(ranks[0]["restored_sharded"])
    for f in sorted((tmp / "ref_ckpt" / "step_3").iterdir()):
        assert (tmp / "resaved" / "step_3" / f.name).read_bytes() == f.read_bytes(), f.name
    params, opt = reference["state"]
    tree = {"params": params, "opt": opt}
    got = jckpt.restore(tmp / "resaved", 3, jax.tree.map(np.zeros_like, tree))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_tuple_spec_rows_and_round_trip(four):
    """Each rank's rows under a tuple of mesh axes are the reference's
    (``local_slices``, held to JAX's own map in test_torch_substrate), and
    the ``DTensor`` placements gather them back to the full value."""
    from repro_torch.substrate import local_slices
    _, ranks = four
    full = torch.arange(32.0).reshape(8, 4)
    for rank, r in enumerate(ranks):
        coords = dict(zip(("data", "model"), divmod(rank, 2)))
        for spec in (("model", "data"), (("model", "data"), None), (("data", "model"), None)):
            local, round_trip = r[f"rows{spec}"]
            assert round_trip
            want = full[local_slices(full.shape, spec, {"data": 2, "model": 2}, coords)]
            assert local.equal(want), (rank, spec)


def test_sharded_prefill_and_decode_match_one_device(four):
    """granite smoke on (2, 2): prefill logits and six greedy decode steps
    with the cache laid out by ``build_decode``'s shardings equal the
    one-device steps (tokens identical, logits within 1e-5)."""
    _, ranks = four
    for r in ranks:
        (lm, tm), (lo, to) = r["decode"]["mesh"], r["decode"]["one"]
        assert rel(lm, lo) < 1e-5
        assert tm.equal(to)
