"""AdamW from scratch: decoupled weight decay, global-norm clip, bias
correction, configurable moment dtype (bf16 moments for llama3-405b).

The reference's functional update (new trees out, the old ones donated)
becomes an update in place here: parameters and moments are written under
``torch.no_grad()``, with the reference's float32 arithmetic step for step.
Parameters laid out on a mesh (``DTensor``s) get moments of the same layout;
the sharded train step computes the global norm over the mesh and applies
the update to each rank's shards (:meth:`AdamW.apply`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..models.common import PSpec, sorted_leaves, torch_dtype, tree_map_pspec
from ..substrate import local_value


class AdamWState(NamedTuple):
    count: torch.Tensor     # int32 scalar: updates applied
    m: dict
    v: dict


def tree_map_sorted(fn, *trees):
    """``fn`` over the leaves of nested-dict trees of the same structure, in
    sorted key order (the reference's tree order)."""
    if isinstance(trees[0], dict):
        return {k: tree_map_sorted(fn, *(t[k] for t in trees)) for k in sorted(trees[0])}
    return fn(*trees)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        """Zero moments of the parameters' shapes and layouts; the count a
        scalar (replicated over the parameters' mesh, if they have one)."""
        dt = torch_dtype(self.moment_dtype)

        def zeros(p):
            if not isinstance(p, DTensor):
                return torch.zeros(p.shape, dtype=dt, device=p.device)
            local = p.to_local()
            return DTensor.from_local(torch.zeros(local.shape, dtype=dt, device=local.device),
                                      p.device_mesh, p.placements, run_check=False,
                                      shape=p.shape, stride=p.stride())
        some = sorted_leaves(params)[0]
        count = torch.zeros((), dtype=torch.int32, device=local_value(some).device)
        if isinstance(some, DTensor):
            count = DTensor.from_local(count, some.device_mesh,
                                       [Replicate()] * some.device_mesh.ndim, run_check=False)
        return AdamWState(count, tree_map_sorted(zeros, params), tree_map_sorted(zeros, params))

    def moment_specs(self, spec_tree):
        """PSpec tree for the moments (same logical axes as params)."""
        def f(_, p):
            return PSpec(p.shape, p.logical, init="zeros", dtype=self.moment_dtype)
        return tree_map_pspec(f, spec_tree)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step: writes ``params`` and the state (count and moments) in
        place; returns (params, the state, the float32 global gradient norm
        before the clip)."""
        # global-norm clip in float32: one sum of squares a leaf, added in
        # the reference's leaf order
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in sorted_leaves(grads)))
        return self.apply(grads, state, params, gn)

    @torch.no_grad()
    def apply(self, grads, state: AdamWState, params, gn: torch.Tensor):
        """:meth:`update` with the global gradient norm ``gn`` given: the
        elementwise update of each leaf, which may be a rank's shard."""
        cnt = state.count + 1
        lr = self.lr(cnt) if callable(self.lr) else self.lr
        scale = torch.clamp(self.clip_norm / (gn + 1e-9), max=1.0)
        bc1 = 1.0 - torch.pow(self.b1, cnt.float())
        bc2 = 1.0 - torch.pow(self.b2, cnt.float())

        def upd(g, m, v, p):
            g = g.float() * scale
            m2 = self.b1 * m.float() + (1 - self.b1) * g
            v2 = self.b2 * v.float() + (1 - self.b2) * g * g
            step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + self.eps)
            step = step + self.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
            m.copy_(m2)
            v.copy_(v2)

        tree_map_sorted(upd, grads, state.m, state.v, params)
        state.count.copy_(cnt)
        return params, state, gn
