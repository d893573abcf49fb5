"""GShard-style token-choice MoE (einsum dispatch, capacity-factor drops).

Tokens are processed in *groups* (a sequence slice) so the dispatch/combine
tensors stay O(tokens x E x C) with C = cf * group * k / E.  The reference's
scheme step for step; its ``jax.lax.top_k`` puts the lower expert index first
among equal probabilities, which ``torch.topk`` does not promise, so the top K
come from a stable descending sort.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import PSpec

AUX_COEF = 0.01
GROUP = 256


def moe_specs(cfg: ArchConfig) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    if cfg.mlp_style != "swiglu":
        raise ValueError("MoE experts are SwiGLU")
    return {
        "router": PSpec((d, e), ("embed", "experts")),
        "wg": PSpec((e, d, ff), ("experts", "embed", "ffn")),
        "wu": PSpec((e, d, ff), ("experts", "embed", "ffn")),
        "wd": PSpec((e, ff, d), ("experts", "ffn", "embed")),
    }


def top_k_first_index(probs, k: int):
    """The k largest values along the last axis and their indices, largest
    first; among equal values the lower index comes first (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(p, x, cfg: ArchConfig):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    gs = min(GROUP, S)
    nG = S // gs
    assert S % gs == 0, (S, gs)
    C = max(1, int(cfg.capacity_factor * gs * K / E))

    xg = x.reshape(B, nG, gs, D)
    logits = (xg @ p["router"].to(x.dtype)).float()                   # (B,nG,gs,E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k_first_index(probs, K)                           # (B,nG,gs,K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    mask = F.one_hot(idx, E).float()                                  # (B,nG,gs,K,E)
    # position of each (token, k) within its expert's capacity, per group
    flat = mask.reshape(B, nG, gs * K, E)
    pos = torch.cumsum(flat, dim=2) - 1.0
    pos = pos.reshape(B, nG, gs, K, E)
    keep = (pos < C) & (mask > 0)
    pos = torch.clamp(pos, 0, C - 1).long()

    # combine[b,g,s,e,c] = sum_k gate_k * keep * onehot(pos, C)
    poh = F.one_hot(pos, C).float() * keep[..., None]                # (B,nG,gs,K,E,C)
    combine = torch.einsum("bgsk,bgskec->bgsec", gate, poh)
    dispatch = (combine > 0).to(x.dtype)                              # (B,nG,gs,E,C)

    xe = torch.einsum("bgsec,bgsd->begcd", dispatch, xg)              # (B,E,nG,C,D)
    wg = p["wg"].to(x.dtype)
    wu = p["wu"].to(x.dtype)
    wd = p["wd"].to(x.dtype)
    h = F.silu(torch.einsum("begcd,edf->begcf", xe, wg))
    h = h * torch.einsum("begcd,edf->begcf", xe, wu)
    ye = torch.einsum("begcf,efd->begcd", h, wd)                      # (B,E,nG,C,D)
    out = torch.einsum("bgsec,begcd->bgsd", combine.to(x.dtype), ye)
    out = out.reshape(B, S, D)

    # Switch-style load-balance loss: E * sum_e f_e * p_e (per group, meaned)
    f = mask.sum(3).mean(2)          # (B,nG,E): fraction routed (pre-drop)
    pbar = probs.mean(2)             # (B,nG,E)
    aux = AUX_COEF * E * torch.mean(torch.sum(f * pbar, dim=-1))
    return out, aux
