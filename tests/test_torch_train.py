"""The port's training stack (``repro_torch.optim``, ``data``,
``checkpoint``, ``launch.steps``, ``train``) against the reference's on the
same inputs, run on the CPU.

Tolerances: the data stream and every checkpoint are exact (bit for bit,
manifests byte for byte); schedules within 1e-6 relative; an AdamW update
within 1e-6 relative in float32 moments (XLA and torch may round a ``pow``
or fuse a multiply-add differently) and within one bf16 rounding in bf16
moments; three train steps in float32 compute hold the loss within 1e-5
relative, the grad norm within 1e-4, and each parameter leaf within 5e-2 of
the largest step that leaf took (Adam's m / sqrt(v) turns a last-bit
difference in a gradient near zero into a visible share of a step); in
bf16 compute the loss and grad norm within 5e-2 (the reference's bf16
bound) and every parameter within 5e-2 of the tree's largest (bf16
gradients flip the sign of near-zero entries, and Adam's first steps move
such an entry by the full rate either way); the
recovery check uses the reference's own 2e-4 (``tests/test_system.py``).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.checkpoint as jckpt  # noqa: E402
import repro.configs as JC  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch.steps import TrainStep as JTrainStep  # noqa: E402
from repro.launch.steps import make_optimizer as jmake_optimizer  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as jcosine, wsd as jwsd  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch.steps import build_train, make_optimizer  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamW, AdamWState, warmup_cosine, wsd  # noqa: E402
from repro_torch.models.common import sorted_leaves  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

SMOKE_CELL = ShapeCell("smoke", seq_len=32, global_batch=4, kind="train")
STEPS, PEAK_LR = 10, 5e-3


def N(t) -> np.ndarray:
    """A leaf as float32 numpy (bf16 values exactly)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def close(got, want, tol: float) -> float:
    """max |got - want| over max |want|, asserted below ``tol``."""
    got, want = N(got), N(want)
    err = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))
    assert err <= tol, (err, tol)
    return err


def jleaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def bits(a) -> np.ndarray:
    """The bytes of one leaf (a tensor or an array), for bit-for-bit checks."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    return np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,seq,batch", [(256, 32, 4), (122753, 16, 2)])
@pytest.mark.parametrize("seed", [0, 3, 17])
def test_synthetic_batches_match_reference(vocab, seq, batch, seed):
    want = JSyntheticLM(JDataConfig(vocab, seq, batch, seed))
    got = SyntheticLM(DataConfig(vocab, seq, batch, seed))
    for step in (0, 1, 7, 1000):
        a, b = got.batch(step), want.batch(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        on = got.device_batch(step, "cpu")
        for k in a:
            assert on[k].dtype == torch.int32
            np.testing.assert_array_equal(on[k].numpy(), a[k])


# -------------------------------------------------------------- schedules
@pytest.mark.parametrize("name", ["wsd", "cosine"])
def test_schedules_match_reference(name):
    """Warmup, stable and decay (or the cosine and its floor), float32."""
    peak, warmup, total = 3e-4, 50, 1000
    jf = (jwsd if name == "wsd" else jcosine)(peak, warmup, total)
    tf = (wsd if name == "wsd" else warmup_cosine)(peak, warmup, total)
    steps = np.arange(0, total + 40, dtype=np.int32)
    want = np.asarray(jf(jnp.asarray(steps)))
    got = tf(torch.as_tensor(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    for s in (0, 49, 50, 899, 900, 950, 1000, 1039):   # each piece, scalar steps
        np.testing.assert_allclose(float(tf(torch.tensor(s, dtype=torch.int32))),
                                   float(jf(jnp.asarray(s, jnp.int32))), rtol=1e-6)


# ------------------------------------------------------------------ AdamW
def random_tree(rng):
    shapes = {"embed": (40, 8), "blocks": {"w": (3, 8, 16), "norm": (3, 8)}, "head": (8,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.normal(size=s).astype(np.float32)
    return make(shapes)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    """Four updates on a random tree (the first with a clipped gradient),
    with the WSD schedule as the rate; params, moments, count and the
    global norm against the reference's."""
    rng = np.random.default_rng(0)
    params = random_tree(rng)
    jopt = JAdamW(lr=jwsd(1e-2, 2, 10), moment_dtype=moment_dtype)
    opt = AdamW(lr=wsd(1e-2, 2, 10), moment_dtype=moment_dtype)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jopt.init(jp)
    tp = params_from_reference(params, "cpu")
    ts = opt.init(tp)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 0
    assert all(x.dtype == getattr(torch, moment_dtype) for x in sorted_leaves(ts.m))
    # bf16 moments are held to one rounding of a value this size: 2^-8
    tol = 1e-6 if moment_dtype == "float32" else 2.0 ** -8
    for k, scale in enumerate((30.0, 1.0, 0.5, 2.0)):
        g = jax.tree.map(lambda x: x * scale, random_tree(rng))
        jp, js, jgn = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, gn = opt.update(params_from_reference(g, "cpu"), ts, tp)
        assert int(ts.count) == int(js.count) == k + 1
        close(gn, jgn, 1e-6)
        for got, want in zip(sorted_leaves(tp), jleaves(jp)):
            assert got.dtype == torch.float32
            close(got, want, 1e-6)
        for part in ("m", "v"):
            for got, want in zip(sorted_leaves(getattr(ts, part)), jleaves(getattr(js, part))):
                assert str(got.dtype) == f"torch.{moment_dtype}"
                close(got, want, tol)


def test_moment_specs_match_reference():
    jspecs = jbuild(JC.get("llama3-405b", smoke=True)).specs()
    tspecs = build(TC.get("llama3-405b", smoke=True)).specs()
    want = jax.tree.leaves(JAdamW(lr=1.0, moment_dtype="bfloat16").moment_specs(jspecs))
    got = sorted_leaves(AdamW(lr=1.0, moment_dtype="bfloat16").moment_specs(tspecs))
    assert len(got) == len(want) > 0
    assert [(p.shape, p.logical, p.init, p.dtype) for p in got] == \
        [(p.shape, p.logical, p.init, p.dtype) for p in want]


# ------------------------------------------------------------- train step
def smoke_cfgs(dtype: str, arch: str = "minicpm-2b"):
    return (dataclasses.replace(JC.get(arch, smoke=True), compute_dtype=dtype),
            dataclasses.replace(TC.get(arch, smoke=True), compute_dtype=dtype))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def reference_steps(request):
    """minicpm-smoke (the WSD schedule, tied embeddings) through the
    reference's jit-compiled ``TrainStep``: its initial parameters, then
    (loss, grad norm, params, optimizer state) after each of three steps
    on ``SyntheticLM`` batches."""
    jcfg, tcfg = smoke_cfgs(request.param)
    model = jbuild(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    opt = jmake_optimizer(jcfg, STEPS, PEAK_LR)
    state = opt.init(params)
    step = jax.jit(JTrainStep(model, opt))
    data = JSyntheticLM(JDataConfig(jcfg.vocab, SMOKE_CELL.seq_len, SMOKE_CELL.global_batch, 0))
    init = jax.tree.map(np.asarray, params)
    out = []
    for i in range(3):
        params, state, m = step(params, state, data.batch(i))
        out.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                        params=jax.tree.map(np.asarray, params),
                        opt=jax.tree.map(np.asarray, state)))
    return request.param, tcfg, init, out


def test_train_steps_match_reference(reference_steps):
    """Three ``TrainStep``s from the reference's initial weights: losses,
    grad norms and updated parameters (the bounds in the module docstring),
    and the optimizer's count."""
    dtype, tcfg, init, want = reference_steps
    f32 = dtype == "float32"
    step, opt, _ = build_train(build(tcfg), None, STEPS, PEAK_LR)
    params = params_from_reference(init, "cpu")
    state = opt.init(params)
    data = SyntheticLM(DataConfig(tcfg.vocab, SMOKE_CELL.seq_len, SMOKE_CELL.global_batch, 0))
    prev = jax.tree.leaves(init)
    for i, w in enumerate(want):
        params, state, m = step(params, state, data.device_batch(i, "cpu"))
        assert m["loss"].dtype == m["grad_norm"].dtype == torch.float32
        close(m["loss"], w["loss"], 1e-5 if f32 else 5e-2)
        close(m["grad_norm"], w["grad_norm"], 1e-4 if f32 else 5e-2)
        ref = jax.tree.leaves(w["params"])
        largest = max(np.abs(r).max() for r in ref)
        for got, r, p in zip(sorted_leaves(params), ref, prev):
            err = np.abs(N(got) - r).max()
            assert err <= (5e-2 * np.abs(r - p).max() if f32 else 5e-2 * largest), err
        prev = ref
        assert int(state.count) == i + 1


def test_make_optimizer_matches_reference():
    for arch in ("minicpm-2b", "llama3-405b", "granite-3-8b"):
        jopt, opt = jmake_optimizer(JC.get(arch), 1000, 1e-3), make_optimizer(TC.get(arch), 1000, 1e-3)
        assert opt.moment_dtype == jopt.moment_dtype
        assert (opt.b1, opt.b2, opt.eps, opt.weight_decay, opt.clip_norm) == \
            (jopt.b1, jopt.b2, jopt.eps, jopt.weight_decay, jopt.clip_norm)
        s = np.arange(0, 1001, 7, dtype=np.int32)
        np.testing.assert_allclose(opt.lr(torch.as_tensor(s)).numpy(),
                                   np.asarray(jopt.lr(jnp.asarray(s))), rtol=1e-6)


# ------------------------------------------------------------ checkpoints
def port_state(tcfg, tree_np):
    """A port (params, AdamWState) tree with the reference's values."""
    opt = tree_np["opt"]
    return {"params": params_from_reference(tree_np["params"], "cpu"),
            "opt": AdamWState(torch.as_tensor(np.array(opt.count)),
                              params_from_reference(opt.m, "cpu"),
                              params_from_reference(opt.v, "cpu"))}


def test_reference_checkpoint_restores_in_the_port(reference_steps, tmp_path):
    """A reference checkpoint of a trainer's {"opt", "params"} after three
    steps restores in the port bit for bit, into a fresh port state."""
    dtype, tcfg, _, want = reference_steps
    tree = {"params": want[-1]["params"], "opt": want[-1]["opt"]}
    jckpt.save(tmp_path, 3, tree)
    assert ckpt.latest_valid(tmp_path) == 3 and ckpt.available_steps(tmp_path) == [3]
    model = build(tcfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    opt = make_optimizer(tcfg, STEPS, PEAK_LR)
    got = ckpt.restore(tmp_path, 3, {"params": params, "opt": opt.init(params)})
    assert isinstance(got["opt"], AdamWState) and list(got) == ["params", "opt"]
    gl, wl = sorted_leaves(got), jax.tree.leaves(tree)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert isinstance(a, torch.Tensor) and str(a.dtype) == f"torch.{np.asarray(b).dtype}"
        np.testing.assert_array_equal(bits(a), bits(b))
    assert int(got["opt"].count) == 3


def test_port_checkpoint_restores_in_the_reference(reference_steps, tmp_path):
    """The other way round, and the two packages write the same bytes: for
    a float32/int32 tree the manifests, CRCs included, are identical and so
    is every shard file."""
    dtype, tcfg, init, want = reference_steps
    tree_np = {"params": want[-1]["params"], "opt": want[-1]["opt"]}
    ckpt.save(tmp_path / "port", 3, port_state(tcfg, tree_np))
    jckpt.save(tmp_path / "ref", 3, tree_np)
    mp = (tmp_path / "port" / "step_3" / "manifest.json").read_bytes()
    mr = (tmp_path / "ref" / "step_3" / "manifest.json").read_bytes()
    assert mp == mr
    for leaf in json.loads(mp)["leaves"]:
        assert leaf["dtype"] in ("float32", "int32")
        assert (tmp_path / "port" / "step_3" / leaf["file"]).read_bytes() == \
            (tmp_path / "ref" / "step_3" / leaf["file"]).read_bytes()
    like = jax.tree.map(jnp.asarray, {"params": init, "opt": want[0]["opt"]})
    got = jckpt.restore(tmp_path / "port", 3, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree_np)):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_bf16_leaf_round_trips_in_the_port_and_not_in_the_reference(tmp_path):
    """A bf16 leaf is written as the reference writes it ('<V2' records,
    dtype "bfloat16" in the manifest, the same bytes and CRC); the port
    restores it bit for bit, the reference's ``restore`` raises ValueError
    (ROADMAP Queue 3)."""
    vals = np.asarray([1.0, -2.5, 3.140625, 1e-3, np.inf, -0.0], np.float32)
    tree = {"m": torch.as_tensor(vals).to(torch.bfloat16), "n": torch.arange(3, dtype=torch.int32)}
    ckpt.save(tmp_path / "port", 1, tree)
    jckpt.save(tmp_path / "ref", 1, {"m": jnp.asarray(vals, jnp.bfloat16),
                                     "n": jnp.arange(3, dtype=jnp.int32)})
    for name in ("manifest.json", "000000.npy", "000001.npy"):
        assert (tmp_path / "port" / "step_1" / name).read_bytes() == \
            (tmp_path / "ref" / "step_1" / name).read_bytes(), name
    assert b"'descr': '<V2'" in (tmp_path / "port" / "step_1" / "000000.npy").read_bytes()
    manifest = json.loads((tmp_path / "port" / "step_1" / "manifest.json").read_text())
    assert [x["dtype"] for x in manifest["leaves"]] == ["bfloat16", "int32"]
    like = {"m": torch.zeros(6, dtype=torch.bfloat16), "n": torch.zeros(3, dtype=torch.int32)}
    for d in ("port", "ref"):
        got = ckpt.restore(tmp_path / d, 1, like)
        assert got["m"].dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(got["m"]), bits(tree["m"]))
        assert torch.equal(got["n"], tree["n"])
    with pytest.raises(ValueError):
        jckpt.restore(tmp_path / "port", 1, {"m": jnp.zeros(6, jnp.bfloat16),
                                             "n": jnp.zeros(3, jnp.int32)})
    # the bits the reference would hold, read with ml_dtypes
    raw = np.load(tmp_path / "ref" / "step_1" / "000000.npy").view(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(raw.astype(np.float32), tree["m"].float().numpy())


def test_async_save_snapshots_before_the_next_update(tmp_path):
    """``save(async_=True)`` copies every leaf before it returns, so an
    in-place update that follows (as ``AdamW.update`` makes) does not reach
    the checkpoint; a corrupt newer checkpoint is skipped."""
    p = torch.arange(1000, dtype=torch.float32)
    ckpt.save(tmp_path, 1, {"p": p}, async_=True).join(timeout=30)
    t = ckpt.save(tmp_path, 2, {"p": p}, async_=True)
    p.mul_(-1.0)
    t.join(timeout=30)
    assert not t.is_alive()
    got = ckpt.restore(tmp_path, 2, {"p": torch.zeros(1000)})
    assert torch.equal(got["p"], torch.arange(1000, dtype=torch.float32))
    shard = tmp_path / "step_2" / "000000.npy"
    shard.write_bytes(shard.read_bytes()[:-4] + b"\0\0\0\0")
    assert ckpt.latest_valid(tmp_path) == 1
    with pytest.raises(IOError):
        ckpt.restore(tmp_path, 2, {"p": torch.zeros(1000)})


# ---------------------------------------------------------------- trainer
def trainer(tmp_path, cfg=None, **kw):
    """The port's versions of tests/test_system.py's trainer cases, on the CPU."""
    cfg = cfg or TC.get("minicpm-2b", smoke=True)
    tcfg = TrainerConfig(steps=kw.pop("steps", 12), ckpt_every=4,
                         ckpt_dir=str(tmp_path), log_every=1, **kw)
    return Trainer(cfg, SMOKE_CELL, tcfg, device="cpu")


def test_train_loss_decreases(tmp_path):
    tr = trainer(tmp_path, steps=15)
    metrics = [m for m in tr.run() if "loss" in m]
    first = np.mean([m["loss"] for m in metrics[:3]])
    last = np.mean([m["loss"] for m in metrics[-3:]])
    assert last < first, (first, last)
    assert ckpt.available_steps(tmp_path) == [0, 4, 8, 12, 15]


def test_failure_recovery_resumes_from_checkpoint(tmp_path):
    """A simulated node loss at step 7 restarts from the step-4 checkpoint and
    still completes all steps; the restart event is logged."""
    tr = trainer(tmp_path, steps=10, fail_at_steps=(7,))
    metrics = tr.run()
    events = [m for m in metrics if "event" in m and "restart" in str(m["event"])]
    assert len(events) == 1
    steps_logged = [m["step"] for m in metrics if "loss" in m]
    assert max(steps_logged) == 10 and steps_logged.count(5) == 2
    assert tr.restarts == 1


def test_recovery_reproduces_unfailed_run(tmp_path):
    """A run with a mid-flight failure gives the unfailed run's losses after
    it (same data stream + restore), at the reference's bound."""
    a = trainer(tmp_path / "a", steps=8)
    la = {m["step"]: m["loss"] for m in a.run() if "loss" in m}
    b = trainer(tmp_path / "b", steps=8, fail_at_steps=(6,))
    lb = {m["step"]: m["loss"] for m in b.run() if "loss" in m}
    for s in (7, 8):
        assert la[s] == pytest.approx(lb[s], rel=2e-4), s


def test_straggler_replan_event(tmp_path):
    """A sustained slowdown of one device class trips the EWMA monitor and
    produces a CEFT-CPOP re-plan whose makespan reflects the degradation."""
    tr = trainer(tmp_path, steps=8, straggler_sim={6: (0, 2.5), 7: (0, 2.5), 8: (0, 2.5)})
    metrics = tr.run()
    ev = [m for m in metrics if m.get("event") == "straggler_replan"]
    assert ev, "no straggler event fired"
    assert ev[0]["slowdown"] >= 1.3 - 1e-6 and ev[0]["makespan_ratio"] > 1.0
    assert [e.step for e in tr.monitor.events] == [m["step"] for m in ev]


def test_trainer_losses_match_the_reference_trainer(tmp_path):
    """The port's ``Trainer`` and the reference's from the same weights, in
    float32 compute: the reference's initial state, read from its step-0
    anchor checkpoint, gives the reference trainer's logged losses within
    1e-5 in the port's trainer."""
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.launch.mesh import make_test_mesh
    from repro.train import Trainer as JTrainer, TrainerConfig as JTrainerConfig
    jcfg, tcfg = smoke_cfgs("float32")
    jt = JTrainer(jcfg, JShapeCell("smoke", 32, 4, "train"),
                  JTrainerConfig(steps=4, ckpt_every=4, ckpt_dir=str(tmp_path / "ref"),
                                 log_every=1), make_test_mesh)
    want = [m["loss"] for m in jt.run() if "loss" in m]
    tr = trainer(tmp_path / "port", tcfg, steps=4)
    anchor = ckpt.restore(tmp_path / "ref", 0, {"params": build(tr.cfg).abstract(),
                                               "opt": tr.opt.init(build(tr.cfg).abstract())})
    tr._fresh_state = lambda: (anchor["params"], anchor["opt"])
    got = [m["loss"] for m in tr.run() if "loss" in m]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)


def train_launcher(*args) -> list[dict]:
    """The metrics records ``python -m repro_torch.launch.train --device cpu
    ARGS`` prints."""
    import ast
    import os
    import subprocess
    import sys

    from conftest import REPO
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                        *args], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return [ast.literal_eval(line) for line in r.stdout.splitlines()]


def test_train_launcher_on_the_cpu_and_resume_is_not_read(tmp_path):
    """The launcher trains the smoke config on the CPU, prints a metrics
    record a step and writes its checkpoints.  ``--resume`` is accepted
    and, as in the reference, never read: a second run over the same
    checkpoint directory starts again from a fresh state at step 1
    (ROADMAP Queue 3)."""
    import inspect

    import repro.launch.train as jlaunch
    import repro_torch.launch.train as tlaunch
    for mod in (jlaunch, tlaunch):
        src = inspect.getsource(mod)
        assert '"--resume"' in src and "args.resume" not in src
    args = ("--steps", "3", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--resume")
    first = [m for m in train_launcher(*args) if "loss" in m]
    assert [m["step"] for m in first] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) for m in first)
    assert ckpt.available_steps(tmp_path) == [0, 2, 3]
    again = [m for m in train_launcher(*args) if "loss" in m]
    assert [m["step"] for m in again] == [1, 2, 3]
    assert again[0]["loss"] == first[0]["loss"]
