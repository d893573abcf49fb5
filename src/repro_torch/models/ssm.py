"""Mamba-2 (SSD, state-space duality) block in plain PyTorch [arXiv:2405.21060].

Chunked SSD: within a chunk the token mixing is the quadratic dual form (a
masked attention-like (Q, Q) tile); across chunks the recurrent state
(B, H, P, N) is carried in float32 by a loop over the chunks (the reference's
``lax.scan``).  Decode is the O(1) recurrent step.  ngroups = 1 (B and C
shared across heads), depthwise causal conv on (x, B, C).

The reference computes all of this outside any Pallas kernel, so it stays
plain tensor code here, with the reference's types step for step: the
intra-chunk product in the compute type, the chunk states, the recurrence
and the inter-chunk output in float32.

On a mesh (``tp``, a ``models.tensor_parallel.TensorParallel``) the block is
head-parallel: ``in_proj`` on this rank's stored columns, whose output moves
to its heads' z, x and dt and the shared B and C
(``TensorParallel.ssm_columns``); the conv on its channels (its heads' x, and
B and C) over the whole sequence; each head's SSD as on one device; the
gated norm's sum of squares summed over the head axes; ``out_proj``
row-parallel into the stream.  Without a plan every function is the
one-device code.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import PSpec
from .layers import rmsnorm

if TYPE_CHECKING:
    from .tensor_parallel import TensorParallel


def _dims(cfg: ArchConfig):
    di = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = di + 2 * N
    return di, H, P, N, conv_dim


def ssm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di, H, P, N, conv_dim = _dims(cfg)
    return {
        "in_proj": PSpec((d, 2 * di + 2 * N + H), ("embed", "ssm_inner")),
        "conv_w": PSpec((cfg.ssm_conv, conv_dim), ("none", "ssm_inner")),
        "conv_b": PSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": PSpec((H,), ("none",), init="a_log"),
        "d_skip": PSpec((H,), ("none",), init="ones"),
        "dt_bias": PSpec((H,), ("none",), init="dt_bias"),
        "norm": PSpec((di,), ("ssm_inner",), init="ones"),
        "out_proj": PSpec((di, d), ("ssm_inner", "embed")),
    }


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above its
    # threshold of 20, which differs by at most about 2e-9 relative in float32
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv along S: xbc (B, S, Cd), w (k, Cd)."""
    k, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out + b)


def _segsum(x):
    """out[..., i, j] = sum_{j < t <= i} x[..., t] (else -inf), as a
    difference of cumulative sums."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, -torch.inf)


def _in_proj(p, x, cfg: ArchConfig, tp: TensorParallel | None):
    """x (B, S, D) -> z, xbc (before the conv), dt: every channel, or on a
    plan this rank's heads' (and B, C whole)."""
    zxbcdt = x @ p["in_proj"].to(x.dtype)                   # (B,S,2di+2N+H)
    if tp is not None:
        zxbcdt = tp.ssm_columns(zxbcdt, cfg)
    di, H, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    n = 1 if tp is None else tp.parts(tp.ssm_head_axes)
    return torch.split(zxbcdt, [di // n, di // n + 2 * N, H // n], dim=-1)


def _conv_params(p, cfg: ArchConfig, tp: TensorParallel | None, dtype):
    """The conv's weight and bias in ``dtype`` on the channels ``xbc`` holds:
    every one, or on a plan this rank's heads' x channels and B, C."""
    w, b = p["conv_w"].to(dtype), p["conv_b"].to(dtype)
    if tp is None:
        return w, b
    own, di = tp.ssm_heads(cfg.d_inner), cfg.d_inner
    return (torch.cat([t[..., own], t[..., di:]], dim=-1) for t in (w, b))


def _gated_norm(w, y, z, cfg: ArchConfig, tp: TensorParallel | None):
    """The gated RMSNorm over all of d_inner: on a plan whose heads split,
    this rank's float32 sum of squares summed over the head axes, divided
    by d_inner."""
    g = y * F.silu(z)
    if tp is None or not tp.ssm_head_axes:
        return rmsnorm(w, g, cfg.norm_eps)
    gf = g.float()
    ss = tp.ssm_sum((gf * gf).sum(dim=-1, keepdim=True))
    return (gf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps) * w).to(g.dtype)


def _out_proj(p, y, tp: TensorParallel | None):
    """``out_proj``; on a plan its rows of this rank's heads, the partial
    sums summed into the stream."""
    out = y @ p["out_proj"].to(y.dtype)
    return out if tp is None else tp.to_stream(out, tp.ssm_head_axes)


def ssd_prefill(p, x, cfg: ArchConfig, init_state=None, tp: TensorParallel | None = None):
    """x: (B, S, D) -> (y (B, S, D), final state {ssm (B, H, P, N) float32,
    conv (B, k-1, conv_dim)}).  Any S: the chunk is min(ssm_chunk, S), and
    a ragged last chunk is padded with dt = 0 after the softplus, which
    leaves the final state exact.  On a plan (``tp``) ``x`` and ``y`` are
    this rank's slice of the stream, the SSD runs on its heads over its
    rows' whole sequence, and ``init_state`` and the state hold its heads;
    a serving plan's state is its cache shard (its cache rows; the conv
    history gathered over the heads' x channels, cut to its stored
    channels)."""
    if tp is not None:
        x = tp.gather_seq(x)
    B, S, D = x.shape
    di, H, P, N, conv_dim = _dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    pad = (-S) % Q
    f32 = torch.float32
    heads = slice(None) if tp is None else tp.ssm_heads(H)

    z, xbc, dt = _in_proj(p, x, cfg, tp)
    di, H = z.shape[-1], dt.shape[-1]                      # this rank's
    conv_tail = xbc[:, -(cfg.ssm_conv - 1):, :]            # decode conv state seed
    xbc = _causal_conv(xbc, *_conv_params(p, cfg, tp, x.dtype))
    xs, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)     # (B,S,di),(B,S,N),(B,S,N)

    dt = _softplus(dt.to(f32) + p["dt_bias"][heads])       # (B,S,H)
    A = -torch.exp(p["a_log"][heads].to(f32))              # (H,)

    if pad:
        xs, Bc, Cc, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xs, Bc, Cc, dt))
    Sp = S + pad
    nc = Sp // Q

    xh = xs.reshape(B, nc, Q, H, P)
    Bh = Bc.reshape(B, nc, Q, N).to(f32)
    Ch = Cc.reshape(B, nc, Q, N).to(f32)
    dth = dt.reshape(B, nc, Q, H)                          # float32
    dA = dth * A                                           # (B,nc,Q,H)
    dAc = torch.cumsum(dA, dim=2)                          # within-chunk

    # ---- intra-chunk (dual/quadratic form), in the compute type ----
    L = torch.exp(_segsum(dA.movedim(-1, 2)))              # (B,nc,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", Ch, Bh)       # (B,nc,Q,Q)
    M = scores[:, :, None] * L                             # (B,nc,H,Q,Q)
    xdt = xh * dth[..., None].to(xh.dtype)                 # (B,nc,Q,H,P)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M.to(xh.dtype), xdt)

    # ---- chunk states, float32 ----
    decay_to_end = torch.exp(dAc[:, :, -1:, :] - dAc)      # (B,nc,Q,H)
    states = torch.einsum("bcqn,bcqhp->bchpn", Bh,
                          (dth * decay_to_end)[..., None] * xh.to(f32))  # (B,nc,H,P,N)

    # ---- inter-chunk recurrence, float32 ----
    chunk_decay = torch.exp(dAc[:, :, -1, :])              # (B,nc,H)
    carry = (init_state["ssm"].to(f32) if init_state is not None
             else torch.zeros((B, H, P, N), dtype=f32, device=x.device))
    prevs = []
    for c in range(nc):
        prevs.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)                # (B,nc,H,P,N)

    # ---- inter-chunk output: y_off[i] = C_i . (prev_state * decay_from_start) ----
    decay_in = torch.exp(dAc)                              # (B,nc,Q,H)
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", Ch, prev_states)
             * decay_in[..., None]).to(xh.dtype)

    y = (y_diag + y_off).reshape(B, Sp, H, P)[:, :S]
    y = y + xs.reshape(B, Sp, H, P)[:, :S] * p["d_skip"][heads].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    out = _out_proj(p, _gated_norm(p["norm"], y, z, cfg, tp), tp)
    if tp is not None and tp.cache_conv_axes is not None:
        conv_tail = torch.cat([tp.ssm_all_heads(conv_tail[..., :di]), conv_tail[..., di:]], -1)
    conv_tail = F.pad(conv_tail, (0, 0, max(0, cfg.ssm_conv - 1 - S), 0)).to(x.dtype)
    if tp is not None and tp.cache_conv_axes is not None:
        # copies, so that the whole state and conv history die with the layer
        shard = {"ssm": tp.cache_rows(carry), "conv": tp.cache_rows(tp.conv_shard(conv_tail))}
        return out, {k: t.clone() for k, t in shard.items()}
    return out, {"ssm": carry, "conv": conv_tail}


def ssd_decode(p, x, cfg: ArchConfig, state, tp: TensorParallel | None = None):
    """One-token recurrent step.  x: (B, 1, D); state: {ssm (B, H, P, N)
    float32, conv (B, k-1, conv_dim)} -> (y (B, 1, D), new state).

    As in the reference, the conv history takes the promoted type of the
    stored state and the new token (float32 from the decode cache, whatever
    the compute type), and so do the conv, its SiLU and x/B/C; the new state
    keeps that type.  The state is not written: the caller stores it.  On a
    plan (``tp``, a decode plan) see :func:`_ssd_decode_tp`."""
    if tp is not None:
        return _ssd_decode_tp(p, x, cfg, state, tp)
    B, _, D = x.shape
    di, H, P, N, conv_dim = _dims(cfg)
    f32 = torch.float32
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)

    ct = torch.promote_types(state["conv"].dtype, xbc.dtype)
    hist = torch.cat([state["conv"].to(ct), xbc.to(ct)], dim=1)          # (B,k,Cd)
    w = p["conv_w"].to(x.dtype).to(ct)
    conv = torch.einsum("bkc,kc->bc", hist, w) + p["conv_b"].to(x.dtype).to(ct)
    xbc1 = F.silu(conv)[:, None, :]
    xs, Bc, Cc = torch.split(xbc1, [di, N, N], dim=-1)

    dt1 = _softplus(dt[:, 0].to(f32) + p["dt_bias"])                     # (B,H)
    A = -torch.exp(p["a_log"].to(f32))
    dec = torch.exp(dt1 * A)                                              # (B,H)
    xh = xs[:, 0].reshape(B, H, P).to(f32)
    upd = (dt1[:, :, None] * xh)[..., None] * Bc[:, 0].to(f32)[:, None, None, :]
    new_ssm = state["ssm"] * dec[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].to(f32), new_ssm)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"ssm": new_ssm, "conv": hist[:, 1:]}


def _ssd_decode_tp(p, x, cfg: ArchConfig, state, tp: TensorParallel):
    """The decode step on a plan: ``x`` is this rank's stream rows, ``state``
    its cache shard (its cache rows: its heads' state, its stored channels
    of the conv history).  The one-token ``zxbcdt`` row is gathered whole
    and the history over the axes that split its channels, the conv runs on
    every channel of the cache rows and the recurrence on this rank's
    heads; the new state is this rank's shard (its heads, its stored
    channels), and the heads' outputs go back to the stream's rows for the
    gated norm and the row-parallel ``out_proj``.  On a plan whose weights
    stay on their embed shards, ``in_proj``'s partial products are summed
    before the row is gathered, the conv runs on this rank's stored
    channels with its shard of ``conv_w`` and ``conv_b`` and its output is
    gathered (the history does not move), and ``out_proj``'s columns are
    gathered after their sum."""
    di, H, P, N, _ = _dims(cfg)
    f32 = torch.float32
    zxbcdt = tp.ssm_whole_columns(tp.embed_in(x, p["in_proj"].to(x.dtype)))
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    own, heads = tp.ssm_heads(di), tp.ssm_heads(H)

    ct = torch.promote_types(state["conv"].dtype, xbc.dtype)
    local = tp.conv_local
    rows = tp.cache_rows(xbc)
    hist = torch.cat([(state["conv"] if local else tp.conv_rows(state["conv"])).to(ct),
                      (tp.conv_shard(rows) if local else rows).to(ct)], dim=1)
    w = p["conv_w"].to(x.dtype).to(ct)
    conv = torch.einsum("bkc,kc->bc", hist, w) + p["conv_b"].to(x.dtype).to(ct)
    xbc1 = (tp.conv_rows(F.silu(conv)) if local else F.silu(conv))[:, None, :]
    new_conv = hist[:, 1:] if local else tp.conv_shard(hist[:, 1:])
    xs, Bc, Cc = torch.split(xbc1, [di, N, N], dim=-1)

    B = hist.shape[0]                                                     # cache rows
    dt1 = _softplus(tp.cache_rows(dt)[:, 0, heads].to(f32) + p["dt_bias"][heads])
    A = -torch.exp(p["a_log"][heads].to(f32))
    dec = torch.exp(dt1 * A)
    xh = xs[:, 0, own].reshape(B, -1, P).to(f32)
    upd = (dt1[:, :, None] * xh)[..., None] * Bc[:, 0].to(f32)[:, None, None, :]
    new_ssm = state["ssm"] * dec[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].to(f32), new_ssm)
    y = y + xh * p["d_skip"][heads][None, :, None]
    y = tp.stream_rows(y.reshape(B, 1, -1).to(x.dtype))
    out = tp.columns(_out_proj(p, _gated_norm(p["norm"], y, z[..., own], cfg, tp), tp),
                     tp.stationary_axes, x.shape[-1])
    return out, {"ssm": new_ssm, "conv": new_conv}
