"""PyTorch oracles for the four kernels of the reference package, line for
line the reference's ``kernels/ref.py``: same operation order and the same tie
rules, so float32 results are bit-equal to it.  The tests hold the JAX oracles,
these, and the kernels' plain versions against each other."""
from __future__ import annotations

import torch

BIG = 3.0e38


def _off(P: int, like: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.eye(P, dtype=like.dtype, device=like.device)


def minplus_ref(a, b):
    """Tropical (min-plus) matrix product: C[i,j] = min_k A[i,k] + B[k,j]."""
    return torch.min(a[:, :, None] + b[None, :, :], dim=1).values


def edge_relax_ref(pv, pdata, L, bw):
    """pv (E, P), pdata (E,), L (P,), bw (P, P) -> (minl (E, P), argl (E, P) int32)."""
    P = L.shape[0]
    comm = (L[:, None] + pdata[:, None, None] / bw) * _off(P, pv)   # (E,Pl,Pj)
    cand = pv[:, :, None] + comm
    minl, argl = torch.min(cand, dim=1)
    return minl, argl.to(torch.int32)


def edge_relax_superstep_ref(pv, pdata, L, bw):
    """pv (R, E, P), pdata (R, E) -> (minl (R, E, P), argl (R, E, P) int32)."""
    P = L.shape[0]
    comm = (L[:, None] + pdata[..., None, None] / bw) * _off(P, pv)  # (R,E,Pl,Pj)
    cand = pv[..., :, None] + comm
    minl, argl = torch.min(cand, dim=-2)
    return minl, argl.to(torch.int32)


def ceft_relax_ref(pv, pdata, validp, L, bw):
    """pv (W, D, P), pdata (W, D), validp (W, D) 1.0/0.0 -> (maxk (W, P),
    argk (W, P) int32, argl (W, P) int32); rows with no valid parent give
    -BIG and indices -1."""
    P = L.shape[0]
    comm = (L[:, None] + pdata[..., None, None] / bw) * _off(P, pv)  # (W,D,Pl,Pj)
    cand = pv[..., :, None] + comm
    minl, argl = torch.min(cand, dim=2)                               # (W,D,Pj)
    minl = torch.where(validp[..., None] > 0, minl, torch.full_like(minl, -BIG))
    maxk, argk = torch.max(minl, dim=1)                               # (W,Pj)
    argl_sel = torch.gather(argl, 1, argk[:, None, :])[:, 0, :]
    has = (validp > 0).any(dim=1)[:, None]
    argk = torch.where(has, argk, -1)
    argl_sel = torch.where(has, argl_sel, -1)
    return maxk, argk.to(torch.int32), argl_sel.to(torch.int32)
