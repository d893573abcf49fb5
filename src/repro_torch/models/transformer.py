"""Decoder-LM stack: period blocks covering the dense, MoE, SSM, hybrid and
VLM families with one code path.

The layer pattern (``configs.base.layer_pattern``) gives the (sequence-mixer,
channel-mixer) pair per *period position*; parameters are stacked over periods
as in the reference, whose ``lax.scan`` over the stack becomes a Python loop
over views of the stacked tensors here (on a mesh, over each period's
working weights, gathered inside the period's call: ``at_period``).
Training differentiates the same code with autograd; ``cfg.remat == "full"``
recomputes each period's activations in the backward pass, as the
reference's ``jax.checkpoint`` of the scan body does.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import PSpec, checkpointed, torch_dtype, tree_map_pspec
from .layers import (
    attn_decode,
    attn_prefill,
    attn_specs,
    mlp,
    mlp_specs,
    rmsnorm,
    rmsnorm_spec,
    rope_cos_sin,
)
from .moe import moe, moe_specs
from .ssm import ssd_decode, ssd_prefill, ssm_specs


def stack_specs(tree, n: int):
    return tree_map_pspec(
        lambda _, p: PSpec((n,) + p.shape, ("layers",) + p.logical, p.init), tree
    )


def block_specs(cfg: ArchConfig) -> dict:
    """One period's parameters, keyed pos{i}: the sequence mixer (``attn``
    or ``ssm``) behind its norm, then the channel mixer (``mlp`` or
    ``moe``) behind its own, unless the pattern has none."""
    out: dict[str, Any] = {}
    for i, (mixer, channel) in enumerate(cfg.layer_pattern()):
        b: dict[str, Any] = {"norm1": rmsnorm_spec(cfg.d_model)}
        if mixer == "attn":
            b["attn"] = attn_specs(cfg)
        else:
            b["ssm"] = ssm_specs(cfg)
        if channel != "none":
            b["norm2"] = rmsnorm_spec(cfg.d_model)
            b[channel] = mlp_specs(cfg) if channel == "mlp" else moe_specs(cfg)
        out[f"pos{i}"] = b
    return out


def model_specs(cfg: ArchConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab
    specs: dict[str, Any] = {
        "embed": PSpec((V, d), ("vocab", "embed_d"), init="embed"),
        "final_norm": rmsnorm_spec(d),
        "blocks": stack_specs(block_specs(cfg), cfg.n_layers // cfg.period),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = PSpec((d, V), ("embed_d", "vocab"))
    return specs


def cache_specs(cfg: ArchConfig, batch: int, seq: int, ring: bool = True) -> dict:
    """Decode-cache tree as PSpecs: attention caches are (periods, B, S, Hkv,
    hd), SWA caches bounded by the window (not ``ring``: every position, as
    a prefill returns them); SSM caches are O(1) in sequence: the state
    (periods, B, H, P, N) and the conv history (periods, B, k-1, d_inner +
    2N)."""
    n_per = cfg.n_layers // cfg.period
    out: dict[str, Any] = {}
    for i, (mixer, _) in enumerate(cfg.layer_pattern()):
        if mixer == "attn":
            sc = min(seq, cfg.window) if cfg.window and ring else seq
            kv = PSpec(
                (n_per, batch, sc, cfg.n_kv_heads, cfg.hd),
                ("layers", "cache_batch", "cache_seq", "heads", "cache_hd"),
                init="zeros", dtype=cfg.compute_dtype,
            )
            out[f"pos{i}"] = {"k": kv, "v": kv}
        else:
            H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            out[f"pos{i}"] = {
                "ssm": PSpec((n_per, batch, H, P, N),
                             ("layers", "cache_batch", "ssm_inner", "none", "none"),
                             init="zeros", dtype="float32"),
                "conv": PSpec((n_per, batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * N),
                              ("layers", "cache_batch", "none", "ssm_inner"),
                              init="zeros", dtype=cfg.compute_dtype),
            }
    return out


def layer_params(tree, i: int):
    """Period ``i`` of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def at_period(fn, cfg: ArchConfig, blocks, i: int, *args):
    """``fn(cfg, period i's parameters, *args)``, the parameters taken
    inside the call: views of a stacked tree, or on a plan its working
    weights (``tensor_parallel.StackedWeights``), gathered here.
    Checkpointed, a plan's period is gathered again in the recompute, as the
    reference's ``jax.checkpoint`` of its scan body gathers its step's
    weights, and no period's working copy outlives its call."""
    return fn(cfg, layer_params(blocks, i) if isinstance(blocks, dict) else blocks.period(i),
              *args)


# ---------------------------------------------------------------------- forward
def embed_tokens(params, cfg: ArchConfig, tokens=None, embeds=None, tp=None):
    """The input stream in the compute type.  On a mesh (``tp``) the tokens
    (or a VLM's ``embeds``) and the result are this rank's slice of the
    stream; where the vocabulary splits, each rank looks up the tokens of
    its rows of the table over the whole sequence, and the partial rows are
    summed into the slice; where the table keeps this rank's embed shard of
    its columns (a decode plan's stationary axes), the rows' columns are
    gathered last; where it keeps it over axes that split the rows (a
    decode plan's table axes), each rank looks up its columns of every row
    of those axes and an all-to-all brings them to the rows' ranks."""
    dtype = torch_dtype(cfg.compute_dtype)
    if embeds is not None:
        return embeds.to(dtype)
    if tp is None:
        return params["embed"][tokens.long()].to(dtype)
    table = params["embed"]
    tokens = tp.table_tokens(tokens)
    if not tp.vocab_axes:
        x = table[tokens.long()].to(dtype)
    else:
        idx = tp.gather_seq(tokens).long() - tp.vocab_rows(cfg.vocab).start
        ours = (idx >= 0) & (idx < table.shape[0])
        x = torch.where(ours[..., None], table[idx.clamp(0, table.shape[0] - 1)].to(dtype), 0)
        x = tp.to_stream(x, tp.vocab_axes)
    return tp.columns(tp.table_rows(x), tp.stationary_axes, cfg.d_model)


def unembed(params, cfg: ArchConfig, x, tp=None):
    """Float32 logits of the hidden states ``x``; on a plan whose table
    keeps this rank's embed shard (``tp``), its partial products summed:
    over the stationary axes on this rank's rows, or over the table axes on
    every row of them (the rows' columns brought by an all-to-all), each
    rank on its logit columns, the sums reduce-scattered onto the rows."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    if tp is None:
        return (x @ w.to(x.dtype)).float()
    if not tp.table_axes:
        return tp.embed_in(x, w.to(x.dtype)).float()
    if w.shape[-1] == cfg.vocab:
        w = w[:, tp.logit_cols(cfg.vocab)]
    return tp.logit_rows((tp.table_cols(x) @ w.to(x.dtype)).float())


def _period_fwd(cfg: ArchConfig, pp, x, cos_sin, tp=None):
    """Full-seq forward through one period; returns (x, aux, cache_updates).
    On a mesh (``tp``; the planned families) ``x`` is this rank's slice of
    the stream and ``aux`` its share of the load-balance term."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache_out = {}
    for i, (mixer, channel) in enumerate(cfg.layer_pattern()):
        b = pp[f"pos{i}"]
        h = rmsnorm(b["norm1"], x, cfg.norm_eps)
        if mixer == "attn":
            a, (k, v) = attn_prefill(b["attn"], h, cfg, cos_sin, window=cfg.window, tp=tp)
            cache_out[f"pos{i}"] = {"k": k, "v": v}
        else:
            a, cache_out[f"pos{i}"] = ssd_prefill(b["ssm"], h, cfg, tp=tp)
        x = x + a
        if channel != "none":
            h2 = rmsnorm(b["norm2"], x, cfg.norm_eps)
            if channel == "mlp":
                x = x + mlp(b["mlp"], h2, cfg, tp)
            else:
                y, a_loss = moe(b["moe"], h2, cfg, tp)
                x = x + y
                aux = aux + a_loss
    return x, aux, cache_out


def _uses_rope(cfg: ArchConfig) -> bool:
    """RoPE applies only where the pattern has attention (mamba2 leaves
    ``use_rope`` at its default with no attention at all)."""
    return cfg.use_rope and any(m == "attn" for m, _ in cfg.layer_pattern())


def forward_full(params, cfg: ArchConfig, *, tokens=None, embeds=None,
                 positions=None, want_cache: bool = False, tp=None):
    """Training / prefill forward.  Returns (hidden (B,S,D), aux, cache|None);
    the cache holds each period position's entries stacked over periods:
    (periods, B, S, Hkv, hd) K and V, or the SSM state and conv tail.  It
    writes nothing in place, so autograd runs through it.  On a mesh
    (``tp``, a ``TensorParallel``; the planned families' train step and
    prefill; ``params["blocks"]`` a ``StackedWeights``, each period gathered
    inside its checkpointed call) the tokens (or embeds) and the hidden
    states are this rank's
    slice of the stream, RoPE's angles are the whole sequence's (M-RoPE's
    (3, B, S) ``positions`` are this rank's rows over the whole sequence)
    and ``aux`` is this rank's share of the load-balance term; a serving
    plan's cache is this rank's shard of each layer's, stacked."""
    x = embed_tokens(params, cfg, tokens, embeds, tp)
    B, S = x.shape[0], x.shape[1] * (1 if tp is None else tp.parts(tp.seq_axes))
    cos_sin = None
    if _uses_rope(cfg):
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        cos_sin = rope_cos_sin(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for i in range(cfg.n_layers // cfg.period):
        x, a, cache = checkpointed(at_period, _period_fwd, cfg, params["blocks"], i, x,
                                   cos_sin, tp, enabled=cfg.remat == "full")
        aux = aux + a
        if want_cache:
            caches.append(cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if not want_cache:
        return x, aux, None
    stacked = {pos: {n: torch.stack([c[pos][n] for c in caches]) for n in entry}
               for pos, entry in caches[0].items()}
    return x, aux, stacked


def _period_decode(cfg: ArchConfig, pp, x, pc, pos: int, cos_sin, tp=None):
    """One token through one period (parameters ``pp``, cache views
    ``pc``, written in place); returns the stream."""
    for j, (mixer, channel) in enumerate(cfg.layer_pattern()):
        b, c = pp[f"pos{j}"], pc[f"pos{j}"]
        h = rmsnorm(b["norm1"], x, cfg.norm_eps)
        if mixer == "attn":
            a, _ = attn_decode(b["attn"], h, cfg, c, pos, cos_sin, window=cfg.window, tp=tp)
        else:
            a, new = ssd_decode(b["ssm"], h, cfg, c, tp)
            for n in ("ssm", "conv"):
                c[n].copy_(new[n])
        x = x + a
        if channel != "none":
            h2 = rmsnorm(b["norm2"], x, cfg.norm_eps)
            if channel == "mlp":
                x = x + mlp(b["mlp"], h2, cfg, tp)
            else:
                x = x + moe(b["moe"], h2, cfg, tp)[0]
    return x


def decode_step(params, cfg: ArchConfig, cache, *, tokens=None, embeds=None,
                pos: int = 0, positions=None, tp=None):
    """One-token decode.  tokens: (B, 1); pos: the current position.
    Returns (logits (B, 1, V), cache); the cache is written in place: K and
    V at their slot, an SSM's new state and conv history copied into the
    stacked tensors through the period's views.  On a mesh (``tp``, a
    decode plan; the planned families; each period's weights gathered at
    its use) the tokens and M-RoPE's (3, B, 1)
    ``positions`` are this rank's stream rows, the cache its shard (each
    rank writes its own ``ssm`` and ``conv`` shards in place), and the
    logits are this rank's rows and columns of them
    (``TensorParallel.logits_spec``)."""
    x = embed_tokens(params, cfg, tokens, embeds, tp)
    B = x.shape[0]
    cos_sin = None
    if _uses_rope(cfg):
        if positions is None:
            positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        cos_sin = rope_cos_sin(cfg, positions)
    for i in range(cfg.n_layers // cfg.period):
        x = at_period(_period_decode, cfg, params["blocks"], i, x, layer_params(cache, i), pos,
                      cos_sin, tp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, cfg, x, tp), cache


# ------------------------------------------------------------------------- loss
def _xent_chunk(params, cfg: ArchConfig, h, labels, tp=None, valid=None):
    """One sequence chunk's summed cross-entropy and its count of valid
    labels, from float32 logits.  ``valid`` marks the labels counted (default:
    those not -1, the padding).  Where a mesh (``tp``) splits the vocabulary,
    ``h`` and ``labels`` are the same on every rank of the vocab axes, each
    rank its columns of the logits: the softmax's max and sum and the gold
    logit are summed over those axes."""
    logits = unembed(params, cfg, h)                                  # (B,c,V) fp32
    if tp is None or not tp.vocab_axes:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    else:
        m = tp.vocab_max(logits.detach().amax(dim=-1))
        lse = torch.log(tp.vocab_sum(torch.exp(logits - m[..., None]).sum(dim=-1))) + m
        idx = labels.long() - tp.vocab_rows(cfg.vocab).start
        ours = (idx >= 0) & (idx < logits.shape[-1])
        own = torch.gather(logits, -1, idx.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        gold = tp.vocab_sum(torch.where(ours, own, 0.0))
    valid = (labels >= 0 if valid is None else valid).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def xent_loss(params, cfg: ArchConfig, hidden, labels, tp=None):
    """Chunked softmax cross-entropy: the (B, S, V) logits are never
    materialized; each sequence chunk computes its own float32 logits, and
    the backward pass recomputes them chunk by chunk (the reference's
    ``jax.checkpoint`` of its scan step).  On a mesh (``tp``) ``hidden`` and
    ``labels`` are this rank's slice of the stream and the mean is over its
    labels; a split vocabulary gathers the sequence and counts this rank's
    labels only."""
    valid = labels >= 0
    if tp is not None and tp.vocab_axes:
        valid = tp.pad_seq(labels) >= 0
        hidden, labels = tp.gather_seq(hidden), tp.gather_seq(labels)
    B, S, D = hidden.shape
    c = min(cfg.loss_chunk, S)
    pad = (-S) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        valid = F.pad(valid, (0, pad), value=False)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range((S + pad) // c):
        chunk = slice(i * c, (i + 1) * c)
        loss, n = checkpointed(_xent_chunk, params, cfg, hidden[:, chunk], labels[:, chunk], tp,
                               valid[:, chunk])
        tot = tot + loss
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
