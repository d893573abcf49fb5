"""Decoder-LM stack for the dense, MoE and VLM families.

The layer pattern (``configs.base.layer_pattern``) gives the (sequence-mixer,
channel-mixer) pair per *period position*; parameters are stacked over periods
as in the reference, whose ``lax.scan`` over the stack becomes a Python loop
over views of the stacked tensors here (no rematerialization: this package
runs inference only).  SSM mixers (mamba2, jamba) are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from .common import PSpec, torch_dtype, tree_map_pspec
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

NOT_PORTED = "is not ported yet (ROADMAP Queue 1: models/ssm.py, then models/encdec.py)"


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a config whose mixers this package does not have yet."""
    if cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder family {NOT_PORTED}")
    if any(m == "ssm" for m, _ in cfg.layer_pattern()):
        raise NotImplementedError(f"{cfg.name}: the SSM mixer {NOT_PORTED}")


def stack_specs(tree, n: int):
    return tree_map_pspec(
        lambda _, p: PSpec((n,) + p.shape, ("layers",) + p.logical, p.init), tree
    )


def block_specs(cfg: ArchConfig) -> dict:
    """One period's parameters, keyed pos{i}: attention, then the channel
    mixer (``mlp`` or ``moe``), each behind its norm."""
    check_supported(cfg)
    out: dict[str, Any] = {}
    for i, (_, channel) in enumerate(cfg.layer_pattern()):
        out[f"pos{i}"] = {
            "norm1": rmsnorm_spec(cfg.d_model), "attn": attn_specs(cfg),
            "norm2": rmsnorm_spec(cfg.d_model),
            channel: mlp_specs(cfg) if channel == "mlp" else moe_specs(cfg),
        }
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


def cache_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Decode-cache tree as PSpecs: attention caches are (periods, B, S, Hkv,
    hd); SWA caches are bounded by the window."""
    check_supported(cfg)
    n_per = cfg.n_layers // cfg.period
    out: dict[str, Any] = {}
    for i in range(len(cfg.layer_pattern())):
        sc = min(seq, cfg.window) if cfg.window else seq
        kv = PSpec(
            (n_per, batch, sc, cfg.n_kv_heads, cfg.hd),
            ("layers", "cache_batch", "cache_seq", "heads", "cache_hd"),
            init="zeros", dtype=cfg.compute_dtype,
        )
        out[f"pos{i}"] = {"k": kv, "v": kv}
    return out


def layer_params(tree, i: int):
    """Period ``i`` of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------- forward
def embed_tokens(params, cfg: ArchConfig, tokens=None, embeds=None):
    dtype = torch_dtype(cfg.compute_dtype)
    if embeds is not None:
        return embeds.to(dtype)
    return params["embed"][tokens.long()].to(dtype)


def unembed(params, cfg: ArchConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ w.to(x.dtype)).float()


def _period_fwd(cfg: ArchConfig, pp, x, cos_sin):
    """Full-seq forward through one period; returns (x, aux, cache_updates)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache_out = {}
    for i, (_, channel) in enumerate(cfg.layer_pattern()):
        b = pp[f"pos{i}"]
        h = rmsnorm(b["norm1"], x, cfg.norm_eps)
        a, (k, v) = attn_prefill(b["attn"], h, cfg, cos_sin, window=cfg.window)
        cache_out[f"pos{i}"] = {"k": k, "v": v}
        x = x + a
        h2 = rmsnorm(b["norm2"], x, cfg.norm_eps)
        if channel == "mlp":
            x = x + mlp(b["mlp"], h2, cfg)
        else:
            y, a_loss = moe(b["moe"], h2, cfg)
            x = x + y
            aux = aux + a_loss
    return x, aux, cache_out


def _cos_sin(cfg: ArchConfig, positions):
    return rope_cos_sin(cfg, positions) if cfg.use_rope else None


def forward_full(params, cfg: ArchConfig, *, tokens=None, embeds=None,
                 positions=None, want_cache: bool = False):
    """Prefill forward.  Returns (hidden (B,S,D), aux, cache|None); the cache
    holds each period position's (periods, B, S, Hkv, hd) K and V."""
    x = embed_tokens(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    if positions is None and cfg.use_rope:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    cos_sin = _cos_sin(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for i in range(cfg.n_layers // cfg.period):
        x, a, cache = _period_fwd(cfg, layer_params(params["blocks"], i), x, cos_sin)
        aux = aux + a
        if want_cache:
            caches.append(cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if not want_cache:
        return x, aux, None
    stacked = {pos: {n: torch.stack([c[pos][n] for c in caches]) for n in ("k", "v")}
               for pos in caches[0]}
    return x, aux, stacked


def decode_step(params, cfg: ArchConfig, cache, *, tokens=None, embeds=None,
                pos: int = 0, positions=None):
    """One-token decode.  tokens: (B, 1); pos: the current position.
    Returns (logits (B, 1, V), cache); the cache is written in place."""
    x = embed_tokens(params, cfg, tokens, embeds)
    B = x.shape[0]
    if positions is None and cfg.use_rope:
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    cos_sin = _cos_sin(cfg, positions)
    for i in range(cfg.n_layers // cfg.period):
        pp, pc = layer_params(params["blocks"], i), layer_params(cache, i)
        for j, (_, channel) in enumerate(cfg.layer_pattern()):
            b = pp[f"pos{j}"]
            h = rmsnorm(b["norm1"], x, cfg.norm_eps)
            a, _ = attn_decode(b["attn"], h, cfg, pc[f"pos{j}"], pos, cos_sin,
                               window=cfg.window)
            x = x + a
            h2 = rmsnorm(b["norm2"], x, cfg.norm_eps)
            if channel == "mlp":
                x = x + mlp(b["mlp"], h2, cfg)
            else:
                x = x + moe(b["moe"], h2, cfg)[0]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, cfg, x), cache
