"""Model layers in plain PyTorch: norms, RoPE / M-RoPE, sinusoidal positions,
memory-linear attention (online-softmax chunking), GQA/SWA, decode-step
attention, MLPs.

The reference computes all of these outside any Pallas kernel, so they stay
plain tensor code here, with the reference's own numerics: float32 norms and
softmax statistics, parameters cast to the compute type at each product.

Layout conventions:
  activations x : (B, S, D)
  q heads       : (B, Hkv, G, S, hd)  with G = Hq // Hkv (GQA groups)
  kv            : (B, S, Hkv, hd)     (cache layout: seq second)
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import PSpec

NEG_INF = -1e30


# ------------------------------------------------------------------------ norms
def rmsnorm_spec(d: int) -> PSpec:
    return PSpec((d,), ("none",), init="ones")


def rmsnorm(w, x, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w).to(x.dtype)


# ------------------------------------------------------------------------- RoPE
def _rope_angles(positions, n_freq: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, n_freq)."""
    ar = torch.arange(0, n_freq, dtype=torch.float32, device=positions.device)
    inv = theta ** (-ar / n_freq)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def rope_cos_sin(cfg: ArchConfig, positions):
    """positions: (B, S) int, or (3, B, S) for M-RoPE.

    M-RoPE (Qwen2-VL): the head_dim/2 frequencies are split into
    (temporal, h, w) sections, each rotated by its own position id.
    """
    half = cfg.hd // 2
    if cfg.mrope:
        if positions.ndim != 3:
            raise ValueError("M-RoPE wants (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        secs = cfg.mrope_sections
        if sum(secs) != half:
            raise ValueError(f"M-RoPE sections {secs} do not sum to {half}")
        # per-frequency position: frequencies [0:t) use temporal ids, etc.
        # output_size: the length is known without reading the repeats
        rep = torch.repeat_interleave(torch.arange(3, device=positions.device),
                                      torch.tensor(secs, device=positions.device),
                                      output_size=half)
        pos = positions[rep].movedim(0, -1)               # (B, S, half)
        ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
        inv = cfg.rope_theta ** (-ar / half)
        ang = pos.float() * inv
        return torch.cos(ang), torch.sin(ang)
    return _rope_angles(positions, half, cfg.rope_theta)  # (B, S, half)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) (split-half convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoidal_embedding(S: int, d: int, offset: int = 0, device=None):
    """Whisper-style absolute sinusoidal positions, (S, d) float32 for the
    positions offset .. offset + S - 1."""
    pos = torch.arange(offset, offset + S, dtype=torch.float32, device=device)[:, None]
    ar = torch.arange(0, d // 2, dtype=torch.float32, device=device)
    # the power in float64, rounded once: torch's float32 pow is an ulp off
    # XLA's in a few entries, which position 1500 turns into 1e-4 of angle
    inv = (1e4 ** (-ar / (d // 2 - 1 + 1e-9)).double()).float()
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -------------------------------------------------------------------- attention
def attn_specs(cfg: ArchConfig) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": PSpec((d, hq * hd), ("embed", "qkv")),
        "wk": PSpec((d, hkv * hd), ("embed", "qkv")),
        "wv": PSpec((d, hkv * hd), ("embed", "qkv")),
        "wo": PSpec((hq * hd, d), ("qkv", "embed")),
    }


def qkv_proj(p, x, cfg: ArchConfig, cos_sin=None, tp=None):
    """x (B,S,D) -> q (B,S,Hq,hd), k,v (B,S,Hkv,hd), RoPE applied.  The head
    counts come from the weights' widths, so on a mesh (``tp``, a
    ``TensorParallel``) they are this rank's heads; k and v there take the kv
    heads this rank's q heads use, and where the q heads do not split, q
    covers this rank's query slice of the sequence (:meth:`TensorParallel.
    query_rows`)."""
    B, S, _ = x.shape
    hd = cfg.hd
    wk, wv = p["wk"], p["wv"]
    xq = x
    if tp is not None:
        wk, wv = tp.kv_heads(wk, hd), tp.kv_heads(wv, hd)
        xq = tp.query_rows(x)
    q = (xq @ p["wq"].to(x.dtype)).reshape(B, xq.shape[1], -1, hd)
    k = (x @ wk.to(x.dtype)).reshape(B, S, -1, hd)
    v = (x @ wv.to(x.dtype)).reshape(B, S, -1, hd)
    if cos_sin is not None:
        cos, sin = cos_sin
        q = apply_rope(q, cos, sin) if tp is None else \
            apply_rope(q, tp.query_rows(cos), tp.query_rows(sin))
        k = apply_rope(k, cos, sin)
    return q, k, v


def chunked_attention(
    q, k, v, *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    q_chunk: int = 512,
    k_chunk: int = 1024,
):
    """Flash-style online-softmax attention: O(S) memory.

    q: (B, Hkv, G, Sq, hd); k, v: (B, Sk, Hkv, hd).
    kv_len: number of valid keys (<= Sk) for padded caches.
    Never materializes (Sq, Sk); the working set is (qc, kc) score tiles.
    The reference's scheme step for step: scores in the input type scaled
    there, then float32; masked entries set to NEG_INF; float32 running max
    and sum; probabilities cast to the value type for the PV product; the
    sum clamped at 1e-20.
    """
    B, Hk, G, Sq, hd = q.shape
    Sk = k.shape[1]
    kv_len = Sk if kv_len is None else kv_len
    qc = min(q_chunk, Sq)
    kc = min(k_chunk, Sk)
    pad_q = (-Sq) % qc
    pad_k = (-Sk) % kc
    if pad_q:
        q = F.pad(q, (0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (Sq + pad_q) // qc, (Sk + pad_k) // kc
    scale = 1.0 / math.sqrt(hd)
    kT = k.permute(0, 2, 3, 1)[:, :, None]  # (B, Hkv, 1, hd, Skp)
    vT = v.permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, Skp, hd)
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = q[:, :, :, qi * qc:(qi + 1) * qc]
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, Hk, G, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hk, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hk, G, qc, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kb = kT[..., ki * kc:(ki + 1) * kc]
            vb = vT[:, :, :, ki * kc:(ki + 1) * kc]
            s = (qb @ kb) * scale
            s = s.float()
            kpos = ki * kc + torch.arange(kc, device=dev)
            mask = (kpos[None, :] < kv_len).expand(qc, kc)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m2 = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m2)
            pexp = torch.exp(s - m2[..., None])
            l = l * alpha + pexp.sum(dim=-1)
            acc = acc * alpha[..., None] + (pexp.to(vb.dtype) @ vb).float()
            m = m2
        outs.append((acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=3)
    return out[:, :, :, :Sq]


def attend(q, k, v, S: int, tp=None, *, causal: bool = True, window: int = 0):
    """The chunked attention of ``q`` (B, Sq, Hq, hd) over ``k``, ``v`` (B,
    Sk, Hkv, hd) -> (B, S, Hq·hd).  On a plan whose q heads do not split
    (``tp.q_slice_axes``), ``q`` holds every head of this rank's query slice
    of the S positions: it attends at the slice's positions, and the output
    comes back as the columns of ``wo``'s rows this rank holds over all S
    (:meth:`TensorParallel.query_cols`)."""
    B, Sq, hq, hd = q.shape
    hkv = k.shape[2]
    qh = q.reshape(B, Sq, hkv, hq // hkv, hd).movedim(1, 3)  # (B,Hkv,G,Sq,hd)
    out = chunked_attention(qh, k, v, causal=causal, window=window,
                            q_offset=0 if tp is None else tp.query_start(S))
    out = out.movedim(3, 1).reshape(B, Sq, hq * hd)
    return out if tp is None else tp.query_cols(out, S)


def attn_prefill(p, x, cfg: ArchConfig, cos_sin, *, window: int = 0, causal=True, tp=None):
    """Full-sequence attention; returns (out, (k, v)) for cache seeding.  On
    a mesh (``tp``) ``x`` and ``out`` are this rank's slice of the stream:
    the sequence is gathered, this rank's heads attend over all of it (where
    the q heads do not split, every head of its query slice: :func:`attend`),
    and the output projection's partial sums come back into the slice; a
    serving plan's k, v are this rank's shard of the cache
    (:func:`_cache_kv`)."""
    if tp is not None:
        x = tp.gather_seq(x)
    q, k, v = qkv_proj(p, x, cfg, cos_sin, tp)
    out = attend(q, k, v, x.shape[1], tp, causal=causal, window=window)
    if tp is not None and tp.cache_spec is not None:
        k, v = _cache_kv(p, x, k, v, cfg, cos_sin, tp)
    return attn_out(p, out, tp), (k, v)


def _cache_kv(p, x, k, v, cfg: ArchConfig, cos_sin, tp):
    """This rank's shard of a layer's cache, (B / cache rows, S / cache
    sequence, Hkv, hd), from the gathered stream ``x`` and the k, v its
    attention used.  Chosen by the bytes each way moves: where every rank
    computed every head, its slice of them (none); where ``wk`` and ``wv``
    are whole on every rank (q heads split, kv heads not), its slice of
    ``x`` projected with them (none; the k, v of every kv head on a
    sequence slice instead of one kv head's on the whole sequence); where
    the kv heads split, an all-to-all over each of their axes, trading
    heads for the cache's sequence or rows (the shard's bytes, once an
    axis).  A slice of the k, v attention used is copied out, so that the
    layer's whole-head k and v are freed when it ends."""
    seq = tp.cache_seq(x.shape[1])
    if not tp.q_local:
        return tp.cache_rows(k)[:, seq].clone(), tp.cache_rows(v)[:, seq].clone()
    if tp.kv_local:
        return tp.heads_to_cache(k), tp.heads_to_cache(v)
    xs = tp.cache_rows(x)[:, seq]
    k = (xs @ p["wk"].to(xs.dtype)).unflatten(-1, (-1, cfg.hd))
    v = (xs @ p["wv"].to(xs.dtype)).unflatten(-1, (-1, cfg.hd))
    if cos_sin is not None:
        cos, sin = (tp.cache_rows(t)[:, seq] for t in cos_sin)
        k = apply_rope(k, cos, sin)
    return k, v


def attn_out(p, ctx, tp=None, all_heads: bool = False):
    """The output projection of the attention output ``ctx`` (B, S, Hq·hd);
    on a mesh, this rank's rows of ``wo`` on its columns of ``ctx`` (``ctx``
    holds just those, but with ``all_heads``: every head, as decode's does),
    summed into the stream."""
    if tp is None:
        return ctx @ p["wo"].to(ctx.dtype)
    return tp.to_stream(tp.head_cols(ctx, all_heads) @ p["wo"].to(ctx.dtype), tp.qkv_axes)


def attn_decode(p, x, cfg: ArchConfig, cache, pos: int, cos_sin, *, window: int = 0,
                tp=None):
    """One-token step: write the cache at pos (ring slot for SWA), attend.

    x: (B, 1, D); cache: dict(k=(B, Sc, Hkv, hd), v=...); pos: int, below
    Sc unless ``window`` (the engine never decodes past its cache).  The
    cache is written IN PLACE (the reference returns an updated copy); the
    returned dict holds the same tensors.  On a mesh (``tp``, a decode plan)
    see :func:`_attn_decode_sp`."""
    if tp is not None:
        return _attn_decode_sp(p, x, cfg, cache, pos, cos_sin, window, tp)
    B, _, D = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qkv_proj(p, x, cfg, cos_sin)
    ck, cv = cache["k"], cache["v"]
    Sc = ck.shape[1]
    slot = pos % Sc if window > 0 else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    qh = q.reshape(B, 1, hkv, hq // hkv, hd).movedim(1, 3)  # (B,Hkv,G,1,hd)
    scale = 1.0 / math.sqrt(hd)
    kT = ck.to(qh.dtype).permute(0, 2, 3, 1)[:, :, None]    # (B,Hkv,1,hd,Sc)
    s = (qh @ kT) * scale
    s = s.float()
    idx = torch.arange(Sc, device=x.device)
    valid = idx < min(pos + 1, Sc) if window > 0 else idx <= pos
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    vh = cv.to(x.dtype).permute(0, 2, 1, 3)[:, :, None]     # (B,Hkv,1,Sc,hd)
    out = w @ vh
    out = out.movedim(3, 1).reshape(B, 1, hq * hd)
    out = out @ p["wo"].to(x.dtype)
    return out, {"k": ck, "v": cv}


def _attn_decode_sp(p, x, cfg: ArchConfig, cache, pos: int, cos_sin, window: int, tp):
    """Decode-SP: ``x`` is this rank's stream rows, ``cache`` its shard
    (its cache rows, its slice of the sequence, every kv head).  q, k and v
    of the new token cover every head (gathered over the ``qkv`` axes where
    this rank's weights hold a share); the rank whose slice holds the slot
    writes k, v there in place; each rank computes a partial softmax over
    its slice in float32 (the running max, the sum of exponentials and the
    weighted sum of v, with the one-device path's ``valid`` mask in global
    positions), the partials are combined over the ``cache_seq`` axes (the
    max first, then the rescaled sums), and ``wo`` runs row-parallel.  The
    one-device softmax normalizes before its weighted sum, this one after
    the split sums: in float32 the two agree within 1e-5 relative, not bit
    for bit."""
    hd = cfg.hd
    q, k, v = (token_heads(p[n], x, hd, width, axes, tp) for n, width, axes in (
        ("wq", cfg.n_heads * hd, tp.qkv_axes), ("wk", cfg.n_kv_heads * hd, tp.kv_axes),
        ("wv", cfg.n_kv_heads * hd, tp.kv_axes)))
    if cos_sin is not None:
        cos, sin = cos_sin
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q, k, v = (tp.cache_rows(t) for t in (q, k, v))
    ck, cv = cache["k"], cache["v"]
    Sl = ck.shape[1]
    Sc = Sl * tp.parts(tp.cache_seq_axes)
    start = tp.cache_seq(Sc).start
    slot = pos % Sc if window > 0 else pos
    if start <= slot < start + Sl:
        ck[:, slot - start] = k[:, 0].to(ck.dtype)
        cv[:, slot - start] = v[:, 0].to(cv.dtype)
    idx = start + torch.arange(Sl, device=x.device)
    valid = idx < min(pos + 1, Sc) if window > 0 else idx <= pos
    out = attn_out(p, sp_attend(q, ck, cv, valid, tp), tp, all_heads=True)
    return tp.columns(out, tp.stationary_axes, x.shape[-1]), {"k": ck, "v": cv}


def token_heads(w, x, hd: int, width: int, axes, tp):
    """One decode token's q, k or v over every head, (B, 1, width / hd,
    hd): the stream rows ``x`` (B, 1, D) times the working ``w`` (its
    columns split over ``axes`` where its heads do; on a plan whose weights
    stay on their embed shards, its embed rows too, the partial products
    summed), the columns gathered.  RoPE acts head by head, so gathering
    before it gives what gathering the heads after it would."""
    y = tp.embed_in(x, w.to(x.dtype))
    return tp.columns(y, axes, width).unflatten(-1, (-1, hd))


def sp_attend(q, ck, cv, valid, tp):
    """One token's attention over a cache split on ``tp.cache_seq_axes``:
    ``q`` (cache rows, 1, Hq, hd) holds every head, ``ck``, ``cv`` this
    rank's shard (its rows, its slice of the sequence, every kv head) and
    ``valid`` (its positions; None: all) the keys it may attend to.  Each
    rank's partial softmax in float32 (the running max, the sum of
    exponentials, the weighted sum of v), the partials combined over the
    sequence axes (the max first, then the rescaled sums), normalized after
    the combine; returns the stream's rows, (B, 1, Hq·hd) in ``q``'s type."""
    B, hkv = ck.shape[0], ck.shape[2]
    hq, hd = q.shape[2], q.shape[3]
    qh = q[:, 0].reshape(B, hkv, hq // hkv, hd)             # (B,Hkv,G,hd)
    kT = ck.to(qh.dtype).permute(0, 2, 3, 1)                # (B,Hkv,hd,Sl)
    s = ((qh @ kT) * (1.0 / math.sqrt(hd))).float()         # (B,Hkv,G,Sl)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    acc = e @ cv.float().permute(0, 2, 1, 3)                # (B,Hkv,G,hd)
    big = tp.seq_max(m)
    r = torch.exp(m - big)
    l_sum = tp.seq_sum(e.sum(dim=-1) * r)
    acc = tp.seq_sum(acc * r[..., None])
    return tp.stream_rows((acc / l_sum[..., None]).to(q.dtype).reshape(B, 1, hq * hd))


# ------------------------------------------------------------------------- MLPs
def mlp_specs(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_style == "swiglu":
        return {
            "wg": PSpec((d, ff), ("embed", "ffn")),
            "wu": PSpec((d, ff), ("embed", "ffn")),
            "wd": PSpec((ff, d), ("ffn", "embed")),
        }
    return {
        "w1": PSpec((d, ff), ("embed", "ffn")),
        "w2": PSpec((ff, d), ("ffn", "embed")),
    }


def mlp(p, x, cfg: ArchConfig, tp=None):
    """The MLP; on a mesh (``tp``) ``x`` and the output are this rank's
    slice of the stream, the hidden layer its columns of the whole
    sequence (on a plan whose weights stay on their embed shards, the up
    projections' partial products summed and the output's columns
    gathered)."""
    if tp is None:
        def dot(a, w):
            return a @ w
    else:
        x = tp.gather_seq(x)
        dot = tp.embed_in
    if cfg.mlp_style == "swiglu":
        h = F.silu(dot(x, p["wg"].to(x.dtype))) * dot(x, p["wu"].to(x.dtype))
        y = h @ p["wd"].to(x.dtype)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dot(x, p["w1"].to(x.dtype)), approximate="tanh")
        y = h @ p["w2"].to(x.dtype)
    return y if tp is None else tp.columns(tp.to_stream(y, tp.ffn_axes), tp.stationary_axes,
                                           x.shape[-1])
