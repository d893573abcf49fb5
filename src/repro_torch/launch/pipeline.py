"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis (``shard_map`` +
``ppermute``), for the dense decoder family.

The CEFT partitioner (``repro_torch.sched``) decides *where* stages go on a
heterogeneous fleet; this module is the *execution* of a contiguous-stage
plan: the rank at pipe index i holds layers [i*L/S, (i+1)*L/S); microbatches
stream through with the classic (n_micro + n_stages - 1)-tick schedule.  The
SPMD formulation computes every stage every tick (bubble ticks process
garbage that is masked at the boundaries), as the reference does.

Forward only (serving / prefill pipelining).  Each stage applies each of its
layers in turn; the reference's stage scans its (1, L/S, ...) block over the
leading axis of one, which is right only at one layer a stage (ROADMAP
Queue 3).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.common import tree_leaves
from ..models.layers import rope_cos_sin
from ..models.transformer import _period_fwd, _uses_rope, layer_params
from ..substrate import axis_index, mesh_axis_sizes, ppermute, psum, shard_map


def _stage_fwd(cfg: ArchConfig, stage_params, x, cos_sin):
    """Apply this rank's periods (stacked on axis 0) to x, in order."""
    for i in range(tree_leaves(stage_params)[0].shape[0]):
        x, _, _ = _period_fwd(cfg, layer_params(stage_params, i), x, cos_sin)
    return x


@torch.no_grad()
def pipeline_forward(cfg: ArchConfig, blocks, x, mesh, *, n_micro: int,
                     axis: str = "pipe"):
    """blocks: the stacked per-period parameters (leading dim L periods),
    full on every rank or ``DTensor``s sharded on that dim over ``axis``;
    x: (B, S, D) embedded inputs, the same on every rank.  Returns the
    (B, S, D) hidden states after all periods, the same on every rank.

    B must divide into n_micro microbatches, and L into the stages."""
    n_stages = mesh_axis_sizes(mesh)[axis]
    L = cfg.n_layers // cfg.period
    if L % n_stages:
        raise ValueError(f"{L} periods do not divide into {n_stages} stages")
    B, S, D = x.shape
    if B % n_micro:
        raise ValueError(f"a batch of {B} does not divide into {n_micro} microbatches")
    mb = B // n_micro
    ticks = n_micro + n_stages - 1
    xm = x.reshape(n_micro, mb, S, D)
    cos_sin = None
    if _uses_rope(cfg):
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(mb, S)
        cos_sin = rope_cos_sin(cfg, positions)
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def per_stage(stage_params, xm_local):
        sid = axis_index(axis)
        buf = torch.zeros((mb, S, D), dtype=x.dtype, device=x.device)
        outs = []
        for t in range(ticks):
            # stage 0 takes microbatch t (clipped in the drain); the others
            # the activation received last tick
            inp = xm_local[min(max(t - sid, 0), n_micro - 1)] if sid == 0 else buf
            out = _stage_fwd(cfg, stage_params, inp, cos_sin)
            # pass to the next stage (ring; last -> first carries garbage)
            buf = ppermute(out, axis, ring)
            outs.append(out)
        # keep only the last stage's valid ticks: tick t emits microbatch
        # t - (n_stages - 1); zero elsewhere so a psum over the axis selects it
        contrib = torch.stack(outs[n_stages - 1:])         # (n_micro, mb, S, D)
        if sid != n_stages - 1:
            contrib = torch.zeros_like(contrib)
        return psum(contrib, axis)

    fn = shard_map(per_stage, mesh=mesh, in_specs=((axis,), ()), out_specs=())
    return fn(blocks, xm).reshape(B, S, D)
