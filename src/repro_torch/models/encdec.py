"""Encoder-decoder (Whisper-style) stack in plain PyTorch.

The audio conv frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings (B, T_enc, D).  Sinusoidal absolute positions
on both sides (no RoPE), GELU 2-proj MLPs, MHA.  Decode keeps a self-attn KV
cache plus fixed cross-attn K/V over the encoder output.  The reference's
``lax.scan`` over each stack becomes a Python loop over views of the stacked
tensors, each block recomputed in the backward pass when ``cfg.remat ==
"full"`` (the reference's ``jax.checkpoint`` of the scan body).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .common import PSpec, checkpointed, torch_dtype
from .layers import (
    attn_decode,
    attn_prefill,
    attn_specs,
    chunked_attention,
    mlp,
    mlp_specs,
    rmsnorm,
    rmsnorm_spec,
    sinusoidal_embedding,
)
from .transformer import layer_params, stack_specs, xent_loss


def enc_block_specs(cfg: ArchConfig) -> dict:
    return {
        "norm1": rmsnorm_spec(cfg.d_model),
        "attn": attn_specs(cfg),
        "norm2": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


def dec_block_specs(cfg: ArchConfig) -> dict:
    return {
        "norm1": rmsnorm_spec(cfg.d_model),
        "self_attn": attn_specs(cfg),
        "norm_x": rmsnorm_spec(cfg.d_model),
        "cross_attn": attn_specs(cfg),
        "norm2": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


def model_specs(cfg: ArchConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab
    return {
        "embed": PSpec((V, d), ("vocab", "embed_d"), init="embed"),
        "enc_norm": rmsnorm_spec(d),
        "final_norm": rmsnorm_spec(d),
        "enc_blocks": stack_specs(enc_block_specs(cfg), cfg.enc_layers),
        "dec_blocks": stack_specs(dec_block_specs(cfg), cfg.n_layers),
        "unembed": PSpec((d, V), ("embed_d", "vocab")),
    }


def cache_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    def kv(s):
        return PSpec(
            (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.hd),
            ("layers", "cache_batch", "cache_seq", "heads", "cache_hd"),
            init="zeros", dtype=cfg.compute_dtype,
        )
    return {"self": {"k": kv(seq), "v": kv(seq)},
            "cross": {"k": kv(cfg.enc_seq), "v": kv(cfg.enc_seq)}}


def _enc_block(cfg: ArchConfig, bp, x):
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    a, _ = attn_prefill(bp["attn"], h, cfg, None, causal=False)
    x = x + a
    h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg)


def encode(params, cfg: ArchConfig, frames):
    """frames: (B, T, D) stub embeddings -> (B, T, D) encoder states."""
    B, T, D = frames.shape
    x = frames.to(torch_dtype(cfg.compute_dtype))
    x = x + sinusoidal_embedding(T, D, device=x.device).to(x.dtype)[None]
    for i in range(cfg.enc_layers):
        x = checkpointed(_enc_block, cfg, layer_params(params["enc_blocks"], i), x,
                         enabled=cfg.remat == "full")
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(bp, enc_out, cfg: ArchConfig):
    B, T, _ = enc_out.shape
    k = (enc_out @ bp["cross_attn"]["wk"].to(enc_out.dtype)).reshape(
        B, T, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ bp["cross_attn"]["wv"].to(enc_out.dtype)).reshape(
        B, T, cfg.n_kv_heads, cfg.hd)
    return k, v


def _cross_attend(bp, h, k, v, cfg: ArchConfig):
    """h: (B, S, D) queries over the cross K/V (B, T, Hkv, hd), no mask."""
    B, S, D = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (h @ bp["cross_attn"]["wq"].to(h.dtype)).reshape(B, S, hq, hd)
    qh = q.reshape(B, S, hkv, hq // hkv, hd).movedim(1, 3)
    out = chunked_attention(qh, k.to(h.dtype), v.to(h.dtype), causal=False)
    out = out.movedim(3, 1).reshape(B, S, hq * hd)
    return out @ bp["cross_attn"]["wo"].to(h.dtype)


def _dec_block(cfg: ArchConfig, bp, x, enc_out):
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    a, (k, v) = attn_prefill(bp["self_attn"], h, cfg, None, causal=True)
    x = x + a
    h = rmsnorm(bp["norm_x"], x, cfg.norm_eps)
    ck, cv = _cross_kv(bp, enc_out, cfg)
    x = x + _cross_attend(bp, h, ck, cv, cfg)
    h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg), {"self": {"k": k, "v": v}, "cross": {"k": ck, "v": cv}}


def decode_full(params, cfg: ArchConfig, tokens, enc_out, want_cache=False):
    """Teacher-forced decoder pass (training / prefill).  Returns (hidden (B,
    S, D), cache|None); the cache holds the self-attn K/V (layers, B, S, Hkv,
    hd) and the cross-attn K/V over the encoder output."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()].to(torch_dtype(cfg.compute_dtype))
    x = x + sinusoidal_embedding(S, cfg.d_model, device=x.device).to(x.dtype)[None]
    caches = []
    for i in range(cfg.n_layers):
        x, cache = checkpointed(_dec_block, cfg, layer_params(params["dec_blocks"], i), x,
                                enc_out, enabled=cfg.remat == "full")
        if want_cache:
            caches.append(cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if not want_cache:
        return x, None
    return x, {part: {n: torch.stack([c[part][n] for c in caches]) for n in ("k", "v")}
               for part in ("self", "cross")}


def loss(params, cfg: ArchConfig, frames, tokens, labels):
    """(cross-entropy of the decoder on ``labels``, a zero aux term)."""
    enc_out = encode(params, cfg, frames)
    hidden, _ = decode_full(params, cfg, tokens, enc_out)
    return (xent_loss(params, cfg, hidden, labels),
            torch.zeros((), dtype=torch.float32, device=hidden.device))


def decode_step(params, cfg: ArchConfig, cache, tokens, pos: int):
    """One decoder token at position ``pos``.  cache: {self: {k, v (L, B,
    Sc, Hkv, hd)}, cross: {...}}; the self-attn cache is written in place.
    Returns (logits (B, 1, V) float32, cache)."""
    x = params["embed"][tokens.long()].to(torch_dtype(cfg.compute_dtype))
    x = x + sinusoidal_embedding(1, cfg.d_model, offset=pos, device=x.device).to(x.dtype)[None]
    B = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for i in range(cfg.n_layers):
        bp, pc = layer_params(params["dec_blocks"], i), layer_params(cache, i)
        h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
        a, _ = attn_decode(bp["self_attn"], h, cfg, pc["self"], pos, None)
        x = x + a
        h = rmsnorm(bp["norm_x"], x, cfg.norm_eps)
        q = (h @ bp["cross_attn"]["wq"].to(h.dtype)).reshape(B, 1, hq, hd)
        qh = q.reshape(B, 1, hkv, hq // hkv, hd).movedim(1, 3)
        ck, cv = pc["cross"]["k"].to(h.dtype), pc["cross"]["v"].to(h.dtype)
        co = chunked_attention(qh, ck, cv, causal=False)
        co = co.movedim(3, 1).reshape(B, 1, hq * hd)
        x = x + co @ bp["cross_attn"]["wo"].to(h.dtype)
        h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
        x = x + mlp(bp["mlp"], h, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ params["unembed"].to(x.dtype)).float(), cache
