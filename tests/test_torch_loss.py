"""The port's training loss (``Model.loss``: the chunked cross-entropy, the
MoE load-balance term, the encoder-decoder's loss) and its autograd
gradients against the reference's ``jax.value_and_grad`` at smoke size, one
config of every family, on the same weights and batch; and the models'
input specs for every shape cell.

Tolerances: float32 compute holds the loss within 1e-5 relative and every
gradient leaf within 1e-4 of its largest entry.  bf16 compute holds the loss
within 5e-2 relative (the reference's bf16 bound) and the gradient tree
within 5e-2 of its largest entry.  MoE families in bf16 are the exception:
bf16 rounding flips some tokens' top-k expert choice, which moves whole
expert gradients, so their tree is held within twice the reference's own
bf16-to-float32 gap on the same inputs (each package's bf16 gradient lies
within about that gap of the float32 one).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.common import sorted_leaves  # noqa: E402

FAMILIES = {"dense": "minicpm-2b", "moe": "mixtral-8x22b", "ssm": "mamba2-2.7b",
            "hybrid": "jamba-v0.1-52b", "vlm": "qwen2-vl-72b", "encdec": "whisper-tiny"}
B, S = 2, 40        # S not a multiple of the smoke loss chunk (32): a padded chunk


def batch_for(cfg, seed=1) -> dict:
    """tokens and labels, with embeds and M-RoPE positions for the VLM and
    encoder frames for the encoder-decoder; label -1 marks ignored slots."""
    rng = np.random.default_rng(seed)
    S_ = S if cfg.family not in ("ssm", "hybrid") else 64   # whole SSM chunks
    labels = rng.integers(0, cfg.vocab, (B, S_)).astype(np.int32)
    labels[0, :3] = -1
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S_)).astype(np.int32), "labels": labels}
    if cfg.family == "vlm":
        out = {"embeds": rng.normal(size=(B, S_, cfg.d_model)).astype(np.float32),
               "labels": labels,
               "positions": np.stack([np.broadcast_to(np.arange(S_, dtype=np.int32) // d, (B, S_))
                                      for d in (1, 2, 3)])}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def reference(arch: str, dtype: str):
    """The reference's weights, batch, loss and gradient leaves (its tree
    order) for ``arch`` at smoke size in ``dtype`` compute."""
    cfg = dataclasses.replace(JC.get(arch, smoke=True), compute_dtype=dtype)
    model = jbuild(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = batch_for(cfg)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)])


def port(arch: str, dtype: str, params, batch):
    cfg = dataclasses.replace(TC.get(arch, smoke=True), compute_dtype=dtype)
    tp = params_from_reference(params, "cpu")
    leaves = sorted_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = build(cfg).loss(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert loss.dtype == torch.float32 and loss.shape == ()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.item(), [g.float().numpy() for g in grads]


def tree_err(got, want) -> float:
    return max(np.abs(g - w).max() for g, w in zip(got, want)) / \
        max(np.abs(w).max() for w in want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference_fp32(family):
    arch = FAMILIES[family]
    params, batch, want_loss, want = reference(arch, "float32")
    loss, got = port(arch, "float32", params, batch)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), tree_err([g], [w])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference_bf16(family):
    arch = FAMILIES[family]
    params, batch, want_loss, want = reference(arch, "bfloat16")
    loss, got = port(arch, "bfloat16", params, batch)
    assert abs(loss - want_loss) <= 5e-2 * abs(want_loss), (loss, want_loss)
    bound = 5e-2
    if family in ("moe", "hybrid"):
        bound = 2 * tree_err(want, reference(arch, "float32")[3])
    assert tree_err(got, want) <= bound, (tree_err(got, want), bound)


def test_remat_changes_neither_loss_nor_grads():
    """``remat="full"`` (the default) recomputes each period in the backward
    pass; it gives the same loss and gradients as ``remat="none"``."""
    arch = FAMILIES["hybrid"]
    params, batch, _, _ = reference(arch, "float32")
    outs = []
    for remat in ("full", "none"):
        cfg = dataclasses.replace(TC.get(arch, smoke=True), compute_dtype="float32",
                                  remat=remat)
        tp = params_from_reference(params, "cpu")
        leaves = sorted_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = build(cfg).loss(tp, {k: torch.as_tensor(v) for k, v in batch.items()})
        outs.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", TC.ARCHS)
@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_reference(arch, cell):
    want = jbuild(JC.get(arch)).input_specs(JC.SHAPES[cell])
    got = build(TC.get(arch)).input_specs(TC.SHAPES[cell])
    assert list(got) == list(want)
    for k in got:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
