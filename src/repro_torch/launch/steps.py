"""The train step on one device.

The reference jit-compiles its step with the full sharding contract; this
package runs the same function eagerly on one device, gradients from
``torch.autograd`` and the optimizer writing in place.  The reference's
input and cache shardings, its prefill and decode steps and abstract state
come with the distribution substrate (ROADMAP Queue 1 items 5 and 6).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from ..models.common import sorted_leaves
from ..models.model import Model
from ..optim import AdamW, for_config
from ..optim.adamw import tree_map_sorted


def make_optimizer(cfg: ArchConfig, total_steps: int = 10_000,
                   peak_lr: float = 3e-4) -> AdamW:
    lr = for_config(cfg.schedule, peak=peak_lr, warmup=min(500, total_steps // 10),
                    total=total_steps)
    return AdamW(lr=lr, moment_dtype=cfg.optstate_dtype)


@dataclasses.dataclass(frozen=True)
class TrainStep:
    model: Model
    optimizer: AdamW

    def loss_and_grads(self, params, batch):
        """The loss and its gradients (a tree like ``params``, in sorted key
        order); a leaf the loss does not reach (the token table under a
        VLM's embeds) gets a zero gradient, as in the reference."""
        leaves = sorted_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = self.model.loss(params, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        return loss.detach(), tree_map_sorted(lambda _: next(grads), params)

    def __call__(self, params, opt_state, batch):
        """One step: the loss and its gradients, then the update, which
        writes ``params`` and ``opt_state`` in place (the reference donates
        them).  Returns (params, opt_state, {"loss", "grad_norm"}), the
        metrics as float32 scalar tensors on the parameters' device."""
        loss, grads = self.loss_and_grads(params, batch)
        new_p, new_s, gnorm = self.optimizer.update(grads, opt_state, params)
        return new_p, new_s, {"loss": loss, "grad_norm": gnorm}


def build_train(model: Model, total_steps: int = 10_000, peak_lr: float = 3e-4):
    """Returns (step function, optimizer)."""
    opt = make_optimizer(model.cfg, total_steps, peak_lr)
    return TrainStep(model, opt), opt
