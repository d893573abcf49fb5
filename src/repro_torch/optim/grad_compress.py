"""Int8 gradient compression with error feedback for the cross-pod reduction.

The pod axis carries pure data parallelism over the slow inter-pod fabric; the
gradient all-reduce there is the dominant cross-pod collective.  Compressing
it 4x (float32 -> int8 with a per-tensor scale) cuts that traffic
proportionally.  Error feedback keeps the *accumulated* quantization error
bounded: the residual e_t is added back before the next quantization, so the
scheme is unbiased over time (Karimireddy et al. 2019).

``ef_quantize`` is the pure building block (tested for the error-feedback
invariant); ``compressed_psum`` is the ``shard_map`` form that moves int8 on
the wire over a pod axis.  The arithmetic is the reference's step for step
(``torch.round`` rounds half to even as ``jnp.round`` does), so the int8
payload and the sums are bit-equal to it.
"""
from __future__ import annotations

import torch

from ..substrate import all_gather, shard_map
from .adamw import tree_map_sorted


def _quant(x: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_quantize(g: torch.Tensor, ef: torch.Tensor):
    """Error-feedback int8 round trip: returns (g_hat, new_ef) with the
    invariant g + ef == g_hat + new_ef (up to float eps)."""
    corrected = g.float() + ef
    q, scale = _quant(corrected)
    g_hat = _dequant(q, scale)
    return g_hat, corrected - g_hat


def ef_quantize_tree(grads, ef_tree):
    """``ef_quantize`` over the leaves of two nested-dict trees of the same
    structure; returns (g_hat tree, new error-feedback tree)."""
    out = tree_map_sorted(ef_quantize, grads, ef_tree)
    return tree_map_sorted(lambda t: t[0], out), tree_map_sorted(lambda t: t[1], out)


def init_ef(params):
    """Zero float32 error-feedback buffers of the parameters' shapes."""
    return tree_map_sorted(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)


def compressed_psum(x: torch.Tensor, mesh, axis: str = "pod") -> torch.Tensor:
    """The sum over ``axis`` of each rank's part, with int8 on the wire.
    ``x`` is laid out with its dimension i over mesh axis i when that axis
    is ``axis`` (a full tensor, of which each rank takes its slice, or a
    ``DTensor``): each pod quantizes its part, the int8 values and the
    float32 scales cross the pod axis (all-gather), and each rank
    dequantizes and sums them in float32.  The result is the same on every
    rank."""
    spec = tuple(axis if ax == axis else None for ax in mesh.mesh_dim_names)

    def body(xs):
        q, scale = _quant(xs)
        qs = all_gather(q, axis)                     # int8 on the wire
        ss = all_gather(scale, axis)
        return torch.sum(qs.float() * ss.reshape((-1,) + (1,) * xs.ndim), dim=0)

    return shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=())(x)
