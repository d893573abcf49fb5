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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import PSpec
from .layers import rmsnorm


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


def ssd_prefill(p, x, cfg: ArchConfig, init_state=None):
    """x: (B, S, D) -> (y (B, S, D), final state {ssm (B, H, P, N) float32,
    conv (B, k-1, conv_dim)}).  Any S: the chunk is min(ssm_chunk, S), and
    a ragged last chunk is padded with dt = 0 after the softplus, which
    leaves the final state exact."""
    B, S, D = x.shape
    di, H, P, N, conv_dim = _dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    pad = (-S) % Q
    f32 = torch.float32

    zxbcdt = x @ p["in_proj"].to(x.dtype)                   # (B,S,2di+2N+H)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    conv_tail = xbc[:, -(cfg.ssm_conv - 1):, :]            # decode conv state seed
    xbc = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xs, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)     # (B,S,di),(B,S,N),(B,S,N)

    dt = _softplus(dt.to(f32) + p["dt_bias"])              # (B,S,H)
    A = -torch.exp(p["a_log"].to(f32))                     # (H,)

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
    y = y + xs.reshape(B, Sp, H, P)[:, :S] * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    state = {
        "ssm": carry,
        "conv": F.pad(conv_tail, (0, 0, max(0, cfg.ssm_conv - 1 - S), 0)).to(x.dtype),
    }
    return out, state


def ssd_decode(p, x, cfg: ArchConfig, state):
    """One-token recurrent step.  x: (B, 1, D); state: {ssm (B, H, P, N)
    float32, conv (B, k-1, conv_dim)} -> (y (B, 1, D), new state).

    As in the reference, the conv history takes the promoted type of the
    stored state and the new token (float32 from the decode cache, whatever
    the compute type), and so do the conv, its SiLU and x/B/C; the new state
    keeps that type.  The state is not written: the caller stores it."""
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
