"""Encoder-decoder (Whisper-style) stack in plain PyTorch.

The audio conv frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings (B, T_enc, D).  Sinusoidal absolute positions
on both sides (no RoPE), GELU 2-proj MLPs, MHA.  Decode keeps a self-attn KV
cache plus fixed cross-attn K/V over the encoder output.  The reference's
``lax.scan`` over each stack becomes a Python loop over views of the stacked
tensors, each block recomputed in the backward pass when ``cfg.remat ==
"full"`` (the reference's ``jax.checkpoint`` of the scan body).

On a mesh every function takes the step's plan (``tp``, a
``models.tensor_parallel.TensorParallel``): the frames and the encoder's
states are this rank's rows and slice of the frames (``tp.encoder``), the
tokens and the decoder's states its rows and sequence slice, each at its own
positions; cross-attention reads this rank's rows of the encoder's output
over every frame; a serving plan's caches are this rank's shards (the cross
cache in its own layout, ``tp.cross``), and each block's weights are
gathered inside its call (``transformer.at_period``).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .common import PSpec, checkpointed, torch_dtype
from .layers import (
    _cache_kv,
    attn_decode,
    attn_out,
    attn_prefill,
    attn_specs,
    attend,
    chunked_attention,
    mlp,
    mlp_specs,
    rmsnorm,
    rmsnorm_spec,
    sinusoidal_embedding,
    sp_attend,
    token_heads,
)
from .transformer import at_period, embed_tokens, layer_params, stack_specs, unembed, xent_loss


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


def _enc_block(cfg: ArchConfig, bp, x, tp=None):
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    a, _ = attn_prefill(bp["attn"], h, cfg, None, causal=False, tp=tp)
    x = x + a
    h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg, tp)


def _positions(x, cfg: ArchConfig, tp=None):
    """``x`` (B, S, D) plus the sinusoids of its positions: this rank's
    slice's on a plan (``tp``'s sequence axes)."""
    start = 0 if tp is None else tp.seq_start(x.shape[1])
    return x + sinusoidal_embedding(x.shape[1], cfg.d_model, offset=start,
                                    device=x.device).to(x.dtype)[None]


def encode(params, cfg: ArchConfig, frames, tp=None):
    """frames: (B, T, D) stub embeddings -> (B, T, D) encoder states.  On a
    plan (``tp``) the frames and the states are this rank's rows and slice
    of the frames (``tp.encoder``'s stream)."""
    enc = None if tp is None else tp.encoder
    x = _positions(frames.to(torch_dtype(cfg.compute_dtype)), cfg, enc)
    for i in range(cfg.enc_layers):
        x = checkpointed(at_period, _enc_block, cfg, params["enc_blocks"], i, x, enc,
                         enabled=cfg.remat == "full")
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(bp, enc_out, cfg: ArchConfig, tp=None):
    """k and v (B, T, Hkv, hd) of the encoder's output over every frame; on
    a plan the kv heads this rank's q heads use."""
    wk, wv = bp["cross_attn"]["wk"], bp["cross_attn"]["wv"]
    if tp is not None:
        wk, wv = tp.kv_heads(wk, cfg.hd), tp.kv_heads(wv, cfg.hd)
    k = (enc_out @ wk.to(enc_out.dtype)).unflatten(-1, (-1, cfg.hd))
    v = (enc_out @ wv.to(enc_out.dtype)).unflatten(-1, (-1, cfg.hd))
    return k, v


def _cross_attend(bp, h, k, v, cfg: ArchConfig, tp=None):
    """h: (B, S, D) queries over the cross K/V (B, T, Hkv, hd), no mask.  On
    a plan ``h`` and the output are this rank's slice of the decoder's
    stream: q over its rows' whole sequence on its heads (where the q heads
    do not split, every head of its query slice, as the self-attention's:
    :func:`layers.attend`), ``wo`` summed back into the slice."""
    if tp is not None:
        h = tp.gather_seq(h)
    xq = h if tp is None else tp.query_rows(h)
    q = (xq @ bp["cross_attn"]["wq"].to(h.dtype)).unflatten(-1, (-1, cfg.hd))
    out = attend(q, k.to(h.dtype), v.to(h.dtype), h.shape[1], tp, causal=False)
    return attn_out(bp["cross_attn"], out, tp)


def _dec_block(cfg: ArchConfig, bp, x, enc_out, tp=None):
    """One decoder block; ``enc_out`` is the encoder's output over every
    frame (on a plan this rank's rows).  Returns (x, the block's cache: on
    a serving plan this rank's shards)."""
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    a, (k, v) = attn_prefill(bp["self_attn"], h, cfg, None, causal=True, tp=tp)
    x = x + a
    h = rmsnorm(bp["norm_x"], x, cfg.norm_eps)
    ck, cv = _cross_kv(bp, enc_out, cfg, tp)
    x = x + _cross_attend(bp, h, ck, cv, cfg, tp)
    if tp is not None and tp.cross_cache_spec is not None:
        ck, cv = _cache_kv(bp["cross_attn"], enc_out, ck, cv, cfg, None, tp.cross)
    h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg, tp), {"self": {"k": k, "v": v}, "cross": {"k": ck, "v": cv}}


def decode_full(params, cfg: ArchConfig, tokens, enc_out, want_cache=False, tp=None):
    """Teacher-forced decoder pass (training / prefill).  Returns (hidden (B,
    S, D), cache|None); the cache holds the self-attn K/V (layers, B, S, Hkv,
    hd) and the cross-attn K/V over the encoder output.  On a plan the
    tokens and the hidden states are this rank's slice of the stream,
    ``enc_out`` its slice of the frames (gathered here, once), and the
    caches its shards."""
    x = _positions(embed_tokens(params, cfg, tokens, tp=tp), cfg, tp)
    if tp is not None:
        enc_out = tp.encoder.gather_seq(enc_out)
    caches = []
    for i in range(cfg.n_layers):
        x, cache = checkpointed(at_period, _dec_block, cfg, params["dec_blocks"], i, x,
                                enc_out, tp, enabled=cfg.remat == "full")
        if want_cache:
            caches.append(cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if not want_cache:
        return x, None
    return x, {part: {n: torch.stack([c[part][n] for c in caches]) for n in ("k", "v")}
               for part in ("self", "cross")}


def loss(params, cfg: ArchConfig, frames, tokens, labels, tp=None):
    """(cross-entropy of the decoder on ``labels``, a zero aux term); on a
    plan the mean over this rank's labels."""
    enc_out = encode(params, cfg, frames, tp)
    hidden, _ = decode_full(params, cfg, tokens, enc_out, tp=tp)
    return (xent_loss(params, cfg, hidden, labels, tp),
            torch.zeros((), dtype=torch.float32, device=hidden.device))


def prefill(params, cfg: ArchConfig, frames, tokens, tp=None):
    """(the caches, the last token's logits (B, 1, V) float32); on a plan
    the caches are this rank's shards and the logits its rows and vocabulary
    columns."""
    hidden, cache = decode_full(params, cfg, tokens, encode(params, cfg, frames, tp),
                                want_cache=True, tp=tp)
    return cache, unembed(params, cfg, hidden[:, -1:] if tp is None else tp.last_token(hidden))


def _cross_decode(bp, h, cache, cfg: ArchConfig, tp=None):
    """One token's cross-attention over the cross cache (never written); on
    a plan its partial softmax over this rank's shard, combined over the
    cross cache's sequence axes."""
    B = h.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wq = bp["cross_attn"]["wq"]
    ck, cv = cache["k"].to(h.dtype), cache["v"].to(h.dtype)
    if tp is not None:
        q = tp.cache_rows(token_heads(wq, h, hd, hq * hd, tp.qkv_axes, tp))
        return tp.columns(attn_out(bp["cross_attn"], sp_attend(q, ck, cv, None, tp.cross), tp,
                                   all_heads=True), tp.stationary_axes, h.shape[-1])
    q = (h @ wq.to(h.dtype)).unflatten(-1, (-1, hd))
    qh = q.reshape(B, 1, hkv, hq // hkv, hd).movedim(1, 3)
    co = chunked_attention(qh, ck, cv, causal=False)
    return attn_out(bp["cross_attn"], co.movedim(3, 1).reshape(B, 1, hq * hd))


def _dec_decode(cfg: ArchConfig, bp, x, pc, pos: int, tp=None):
    """One token through one decoder block (parameters ``bp``, cache views
    ``pc``, the self cache written in place); returns the stream."""
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    a, _ = attn_decode(bp["self_attn"], h, cfg, pc["self"], pos, None, tp=tp)
    x = x + a
    h = rmsnorm(bp["norm_x"], x, cfg.norm_eps)
    x = x + _cross_decode(bp, h, pc["cross"], cfg, tp)
    h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg, tp)


def decode_step(params, cfg: ArchConfig, cache, tokens, pos: int, tp=None):
    """One decoder token at position ``pos``.  cache: {self: {k, v (L, B,
    Sc, Hkv, hd)}, cross: {...}}; the self-attn cache is written in place.
    Returns (logits (B, 1, V) float32, cache).  On a decode plan the tokens
    are this rank's stream rows, the caches its shards, the logits its rows
    and columns of them."""
    x = embed_tokens(params, cfg, tokens, tp=tp)
    x = x + sinusoidal_embedding(1, cfg.d_model, offset=pos, device=x.device).to(x.dtype)[None]
    for i in range(cfg.n_layers):
        x = at_period(_dec_decode, cfg, params["dec_blocks"], i, x, layer_params(cache, i), pos,
                      tp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, cfg, x, tp), cache
