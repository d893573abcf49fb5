"""GShard-style token-choice MoE (einsum dispatch, capacity-factor drops).

Tokens are processed in *groups* (a sequence slice) so the dispatch/combine
tensors stay O(tokens x E x C) with C = cf * group * k / E.  The reference's
scheme step for step; its ``jax.lax.top_k`` puts the lower expert index first
among equal probabilities, which ``torch.topk`` does not promise, so the top K
come from a stable descending sort.  On a mesh (a ``TensorParallel`` plan)
:func:`_moe_sharded` computes each tensor where the reference's rules and its
``constrain`` calls put it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..substrate import chunk_of
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


def slots(mask, C: int, before=None):
    """Each (token, k)'s capacity position within its expert's ``C`` slots
    and whether it keeps one: ``mask`` (B, nG, g, K, E) the one-hot choices
    of groups of g tokens; ``before`` (B, nG, 1, E), where given, the counts
    of the group's tokens that come before these (its earlier ranks' where
    a group spans ranks).  Returns (keep (B, nG, g, K, E) bool, pos int64
    clipped to [0, C)).  The counts are small integers, exact in float32, so
    a split group's positions equal the whole group's bit for bit."""
    B, nG, g, K, E = mask.shape
    flat = mask.reshape(B, nG, g * K, E)
    pos = torch.cumsum(flat, dim=2) - 1.0
    if before is not None:
        pos = pos + before
    pos = pos.reshape(B, nG, g, K, E)
    keep = (pos < C) & (mask > 0)
    return keep, torch.clamp(pos, 0, C - 1).long()


def _route(xg, router, cfg: ArchConfig, tp=None):
    """Routing of token groups ``xg`` (B, nG, g, D): the router's
    probabilities (B, nG, g, E), the top-K gates (B, nG, g, K) and the
    one-hot choices (B, nG, g, K, E).  On a plan whose weights stay on their
    embed shards (``tp``) the router's partial logits are summed and its
    columns gathered over the experts' axes."""
    E, K = cfg.n_experts, cfg.top_k
    if tp is None:
        logits = xg @ router.to(xg.dtype)
    else:
        logits = tp.columns(tp.embed_in(xg, router.to(xg.dtype)), tp.expert_axes, E)
    logits = logits.float()                                           # (B,nG,gs,E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k_first_index(probs, K)                           # (B,nG,gs,K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, F.one_hot(idx, E).float()                     # (B,nG,gs,K,E)


def _combine(gate, mask, C: int, before=None):
    """The combine weights (B, nG, g, E, C): each kept (token, k)'s gate at
    its expert's capacity slot (:func:`slots`)."""
    keep, pos = slots(mask, C, before)
    # combine[b,g,s,e,c] = sum_k gate_k * keep * onehot(pos, C)
    poh = F.one_hot(pos, C).float() * keep[..., None]                # (B,nG,gs,K,E,C)
    return torch.einsum("bgsk,bgskec->bgsec", gate, poh)


def moe(p, x, cfg: ArchConfig, tp=None):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).  On a mesh (``tp``,
    a ``TensorParallel``) see :func:`_moe_sharded`."""
    if tp is not None:
        return _moe_sharded(p, x, cfg, tp)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    gs = min(GROUP, S)
    nG = S // gs
    assert S % gs == 0, (S, gs)
    C = max(1, int(cfg.capacity_factor * gs * K / E))

    xg = x.reshape(B, nG, gs, D)
    probs, gate, mask = _route(xg, p["router"], cfg)
    combine = _combine(gate, mask, C)
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


def _moe_sharded(p, x, cfg: ArchConfig, tp):
    """The MoE block on one rank of a mesh, as the reference's rules and its
    ``constrain`` calls lay it out.  ``x`` (B / batch parts, S / seq parts,
    D) is this rank's rows and sequence slice of the stream, the router
    whole, the expert weights this rank's ``experts`` and ``ffn`` shards.

    * Groups are ``min(GROUP, S)`` tokens of the whole sequence; where one
      spans several ranks (a slice shorter than a group), a rank routes its
      share of it, its capacity positions offset by the group's earlier
      ranks' counts (:meth:`TensorParallel.group_before`: the (E,) counts
      gathered over the sequence), and the dispatch and the expert products
      run on that fragment with a whole group's ``C`` slots an expert.
    * Experts apart (``tp.expert_axes``): the dispatched tokens (B, E,
      groups, C, D) cross the expert axes that split the sequence by an
      all-to-all, trading the groups' split for the experts'; over hidden
      columns' axes that split the sequence they are gathered and the down
      projection's partial sums reduce-scattered back (row-parallel, as
      ``tp`` under ``moe_ep``); the outputs come back by the reverse
      all-to-all and combine on the rank's own tokens.  Where the expert
      axes hold the same tokens (decode), each rank runs its own experts
      and the outputs are summed there.  The dispatched tokens, the hidden
      activations and the outputs move; the weights do not.
    * Every expert on every rank (the count does not divide the axes): the
      rank computes its own groups with every expert, the expert weights
      gathered over the hidden columns' axes that split the sequence (the
      reference's pins give ``ffn``'s axis to the groups); over axes that
      hold the same tokens the experts run column-parallel and the outputs
      are summed.  The weights move; the tokens do not.
    * On a decode plan whose weights stay on their embed shards (one row:
      ``tp.stationary_axes``), the router's and the up projections' partial
      products are summed over those axes (the router's columns gathered
      over the experts' axes), the down projection and the combine run on
      this rank's embed columns, summed over the expert axes, then
      gathered.

    The aux term is this rank's share of the whole batch's: each group's
    ``f`` and ``pbar`` (summed over the group's ranks where it is split),
    meaned over every (row, group) of the batch, weighted by one over the
    ranks that compute the same groups, so the shares sum to it over the
    mesh."""
    B, Sl, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    S = Sl * tp.parts(tp.seq_axes)
    gs = min(GROUP, S)
    gl = min(gs, Sl)
    assert S % gs == 0 and Sl % gl == 0 and gs % gl == 0, (S, Sl, gs)
    nF, share = Sl // gl, gs // gl
    C = max(1, int(cfg.capacity_factor * gs * K / E))

    xg = x.reshape(B, nF, gl, D)
    probs, gate, mask = _route(xg, p["router"], cfg, tp)
    before = None if share == 1 else tp.group_before(mask.sum((2, 3))[:, :, None], share)
    combine = _combine(gate, mask, C, before)

    f, pbar = mask.sum(3).sum(2), probs.sum(2)                        # (B,nF,E)
    copies = tp.replicas
    if share > 1:
        f, pbar = tp.group_sums(f, share), tp.group_sums(pbar, share)
        copies *= tp.parts(tp.seq_axes)
    groups = B * tp.parts(tp.batch_axes) * (S // gs)
    aux = AUX_COEF * E * torch.sum((f / gs) * (pbar / gs)) / (groups * copies)

    if tp.experts_local:
        own = chunk_of(E, tp.mesh, tp.experts_local)
        combine = combine[..., own, :]
    dispatch = (combine > 0).to(x.dtype)                              # (B,nF,gl,E',C)
    if gl == 1:   # one-token groups (decode): nothing to contract, a broadcast product
        xe = dispatch[:, :, 0].movedim(2, 1)[..., None] * xg[:, None]
    else:
        xe = torch.einsum("bgsec,bgsd->begcd", dispatch, xg)
    xe = tp.dispatched(xe)
    wg = tp.expert_weight(p["wg"].to(x.dtype), 2)
    wu = tp.expert_weight(p["wu"].to(x.dtype), 2)
    wd = tp.expert_weight(p["wd"].to(x.dtype), 1)
    h = F.silu(tp.embed_in(xe, wg, 1, _up))
    h = h * tp.embed_in(xe, wu, 1, _up)
    ye = tp.returned(torch.einsum("begcf,efd->begcd", h, wd))         # (B,E',nF,C,D')
    out = torch.einsum("bgsec,begcd->bgsd", combine.to(x.dtype), ye)
    return tp.columns(tp.expert_sum(out.reshape(B, Sl, -1)), tp.stationary_axes, D), aux


def _up(xe, w):
    """The experts' up projections: (B, E', groups, C, D) tokens times (E',
    D, F) weights."""
    return torch.einsum("begcd,edf->begcf", xe, w)
