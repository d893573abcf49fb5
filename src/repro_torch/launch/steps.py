"""Step builders: the train, prefill and decode steps with the reference's
sharding contract (params, optimizer state, inputs, caches).

Without a mesh a step runs eagerly on the parameters' device, gradients from
``torch.autograd`` and the optimizer writing in place (the reference donates).

On a mesh the state lives as ``DTensor``s laid out by ``Model.shardings``
and ``AdamW.moment_specs`` (FSDP over ``data`` under the baseline profile).
:class:`ShardedTrainStep` splits the compute of every family (dense, MoE,
SSM, the hybrid, the VLM and the encoder-decoder) over the mesh as the
reference's ``LOGICAL_RULES`` lay it out (``models.tensor_parallel``):

  1. gather each parameter over its ``embed`` axes only (its working
     layout; a q / k / v weight whose heads do not split, a MoE router and
     an SSM block's conv weights whole; an SSM block's norm and
     ``out_proj`` on this rank's heads' rows; an expert weight in the
     compute type); the ``qkv``, ``ffn``, ``experts``, ``ssm_inner`` and
     ``vocab`` shards stay on their ranks.  The stacked blocks are
     gathered a period at a time, inside the period's checkpointed call
     and again in its recompute, as the reference's scan step gathers
     them; the other leaves (the tables, the final norms) before the
     model runs;
  2. take each input's own shard: this rank's batch rows and sequence slice
     of the tokens (or a VLM's embeds) and labels, the residual stream, and
     M-RoPE's positions on its rows over the whole sequence; each block
     gathers the normed stream's sequence, runs its column-parallel
     products on this rank's heads and columns and
     reduce-scatters its row-parallel partial sums back into the slice; the
     embedding and the cross-entropy are vocab-parallel where the
     vocabulary splits; a MoE block routes its own tokens, and the
     dispatched tokens cross the expert axes by an all-to-all (or, where the
     experts do not divide the axis, the layer gathers the expert weights'
     hidden columns and runs every expert on its own groups:
     ``models.moe``); an SSM block runs its heads' chunked SSD over its
     rows' whole sequence, ``in_proj``'s output moved from its stored
     columns to the heads' (``models.ssm``); an encoder-decoder's frames
     are a stream of their own (this rank's rows and, where they divide
     it, its slice of the frames), and its cross-attention reads its rows
     of the encoder's output over every frame (``models.encdec``);
  3. weight the rank's loss by its share of the valid labels (and by one
     over the ranks that hold the same tokens), and add its share of the
     load-balance term, so the per-rank values sum, over the mesh, to the
     whole batch's loss; the collectives are differentiated as their
     adjoints under that sum, so one ``torch.autograd.grad`` gives each
     working gradient;
  4. sum each working gradient, in its parameter's type, over the mesh axes
     its layout does not split into its parameter's layout
     (``TensorParallel.reduce_leaf``: a reduce-scatter over ``data`` for a
     weight, an all-reduce over every axis for a norm): a period's blocks'
     as the backward leaves the period, the other leaves' after it;
  5. the global norm: each leaf's sum of squares over its shards, one
     all-reduce of the vector of leaves over each mesh axis (a replicated
     shard counted once), then the float32 sum in the reference's leaf
     order;
  6. ``AdamW.apply`` on each rank's shards, in place.

No family gathers its weights whole on a mesh: a model whose plan raises
``ValueError`` there fails.  (``ShardedTrainStep._zero3``, every parameter
gathered whole, is kept only as the dry-run's yardstick that the tests
patch in.)

:class:`PrefillStep` and :class:`DecodeStep` on a mesh split serving the
same way (``plan_prefill``, ``plan_decode``): each parameter gathered over
its ``embed`` axes only, in the compute type (``weight_leaves``), a period's
blocks where the period runs; each
input's own shard; the decode cache kept in the reference's layout
(attention: the decode-SP one, rows on ``cache_batch``, sequence on
``cache_seq``, every kv head; an encoder-decoder's cross cache the same
over its frames; SSM: the state's heads and the conv history's channels on
``ssm_inner``), each rank reading and writing only its shard, in place.
A decode step whose rows leave a weight's embed axes whole (one row under
the baseline profile) gathers no weight: each stays on its embed shard and
the token's activations move (``TensorParallel.stationary_axes``).
Prefill returns its cache laid out so, every position (a sliding window's
too), and :func:`seed_cache` moves it into a decode cache, shard to shard (a
window's ring slots as the engine fills them; an SSM's state and conv
history and the cross cache as they are); both return the logits and the
next tokens whole on every rank.
``abstract_state`` and ``abstract_cache`` give the state and the cache as
``meta`` tensors for the dry-run (``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..configs.base import ArchConfig, ShapeCell
from ..models.common import (abstract_params, active_profile, param_shardings, resolve_spec,
                             sorted_leaves, torch_dtype, tree_map_pspec)
from ..models.model import Model
from ..models.tensor_parallel import (STACKED, TensorParallel, expert_leaves, grad_leaves,
                                      plan_decode, plan_prefill, plan_train, weight_leaves)
from ..optim import AdamW, AdamWState, for_config
from ..optim.adamw import tree_map_sorted
from ..substrate import (Sharding, chunk_of, exchange_over, from_shard,
                         full_value, gather_over, local_value, psum, reduce_over)
from .mesh import mesh_axis_sizes

# logical axes of every named model input
INPUT_LOGICAL: dict[str, tuple[str, ...]] = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "embeds": ("batch", "seq", "none"),
    "positions": ("none", "batch", "seq"),
    "frames": ("batch", "none", "none"),
    "pos": (),
}


def input_shardings(inputs: dict[str, torch.Tensor], mesh) -> dict[str, Sharding]:
    """A :class:`Sharding` per model input (``Model.input_specs``' meta
    tensors or real ones), from its logical axes."""
    ms = mesh_axis_sizes(mesh)
    return {k: Sharding(mesh, resolve_spec(tuple(v.shape), INPUT_LOGICAL[k], ms))
            for k, v in inputs.items()}


def make_optimizer(cfg: ArchConfig, total_steps: int = 10_000,
                   peak_lr: float = 3e-4) -> AdamW:
    lr = for_config(cfg.schedule, peak=peak_lr, warmup=min(500, total_steps // 10),
                    total=total_steps)
    return AdamW(lr=lr, moment_dtype=cfg.optstate_dtype)


def gathered(tree):
    """A nested-dict tree with every ``DTensor`` replaced by its full value
    (sorted key order, so every rank gathers in the same order)."""
    return tree_map_sorted(full_value, tree)


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


def _rows(name: str, x) -> tuple[torch.Tensor, tuple[str, ...]]:
    """This rank's batch rows of input ``name`` with every other dimension
    whole, and the mesh axes the rows are split over.  A tensor that is not
    a ``DTensor`` is the whole batch on every rank."""
    if not isinstance(x, DTensor):
        return x, ()
    logical = INPUT_LOGICAL[name]
    bdim = logical.index("batch") if "batch" in logical else -1
    keep = [p if p.is_shard(bdim) else Replicate() for p in x.placements]
    axes = tuple(ax for ax, p in zip(x.device_mesh.mesh_dim_names, keep) if p.is_shard())
    with torch.no_grad():
        return x.redistribute(x.device_mesh, keep).to_local(), axes


def _stream_rows(x, sharding: Sharding) -> torch.Tensor:
    """This rank's shard of input ``x`` laid out by ``sharding`` (a
    ``DTensor`` redistributed there, a whole tensor sliced)."""
    if not isinstance(x, DTensor):
        return sharding.local(x)
    with torch.no_grad():
        return x.redistribute(x.device_mesh, sharding.placements).to_local()


@torch.no_grad()
def _position_rows(x, tp: TensorParallel) -> torch.Tensor:
    """M-RoPE's (3, B, S) positions -> this rank's stream rows over the
    whole sequence (RoPE's angles are the whole sequence's): a whole tensor
    sliced, a ``DTensor``'s shard gathered over the axes that split its
    sequence (an input laid out by ``INPUT_LOGICAL`` splits its rows as the
    stream does)."""
    if not isinstance(x, DTensor):
        return x[:, chunk_of(x.shape[1], tp.mesh, tp.batch_axes)]
    names = x.device_mesh.mesh_dim_names
    rows = tuple(ax for ax, p in zip(names, x.placements) if p.is_shard(1) and ax in tp.mesh_axes)
    if rows != tp.batch_axes:
        raise ValueError(f"positions split their rows over {rows}, the stream over "
                         f"{tp.batch_axes}")
    seq = tuple(ax for ax, p in zip(names, x.placements) if p.is_shard(2))
    return gather_over(x.to_local(), tp.mesh, seq, 2)


def _stream_inputs(batch: dict, tp: TensorParallel) -> dict:
    """This rank's shard of each model input a planned step takes: the
    tokens (or a VLM's embeds) and the labels laid out as the stream, its
    rows and sequence slice; an encoder-decoder's frames as the frames'
    stream (its rows and slice of the frames); M-RoPE's positions by
    :func:`_position_rows`."""
    out = {k: _stream_rows(batch[k], Sharding(tp.mesh, tp.stream_spec + (None,) * (k == "embeds")))
           for k in ("tokens", "embeds", "labels") if k in batch}
    if "frames" in batch:
        out["frames"] = _stream_rows(batch["frames"],
                                     Sharding(tp.mesh, tp.enc_stream_spec + (None,)))
    if "positions" in batch:
        out["positions"] = _position_rows(batch["positions"], tp)
    return out


@dataclasses.dataclass(frozen=True)
class ShardedTrainStep(TrainStep):
    """The train step on a mesh: tensor-, sequence- and expert-parallel for
    every family, head-parallel for the SSM blocks (the module docstring)."""
    mesh: Any = None
    _plans: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def plan(self, labels) -> tuple[TensorParallel, list, list]:
        """The planned step's plan for a batch of ``labels``' (global) shape
        under the active profile, its working layouts in sorted leaf order
        and which leaves travel in the compute type (the expert weights):
        made at the first step of that shape and kept."""
        key = (tuple(labels.shape), active_profile().name)
        if key not in self._plans:
            specs = self.model.specs()
            tp = plan_train(self.model.cfg, specs, self.mesh, key[0])
            self._plans[key] = (tp, tp.layouts(specs), expert_leaves(specs))
        return self._plans[key]

    def loss_and_grads(self, params, batch):
        """The whole batch's loss (the same on every rank) and its
        gradients, each a ``DTensor`` laid out as its parameter.  The
        leaves outside the stacked blocks are gathered before the model
        runs and their gradients summed after the backward; each period's
        blocks are gathered inside its checkpointed call (again in its
        recompute) and their gradients summed into the shards as the
        backward leaves the period (``TensorParallel.weights``)."""
        mesh, model = self.mesh, self.model
        tp, layouts, cast = self.plan(batch["labels"])
        work = tp.weights(params, layouts, torch_dtype(model.cfg.compute_dtype), cast)
        rows = _stream_inputs(batch, tp)

        def over_mesh(x):
            for ax in tp.mesh_axes:
                x = psum(x, ax, mesh=mesh)
            return x
        valid = (rows["labels"] >= 0).sum().float()
        share = valid / torch.clamp(over_mesh(valid) / tp.replicas, min=1.0) / tp.replicas
        leaves = grad_leaves(work)
        for w in leaves:
            w.requires_grad_(True)
        xent, aux = model.loss_terms(work, rows, tp)
        part = xent * share + aux
        grads = list(torch.autograd.grad(part, leaves, allow_unused=True,
                                         materialize_grads=True))
        # the working leaves are not needed past the backward, the periods'
        # shards (views of the parameters) to stack their gradients
        stacks = {k: work[k] for k in STACKED if k in work}
        del work, leaves
        sharded = iter(tp.weight_grads(stacks, grads, params, layouts))
        return over_mesh(part.detach()), tree_map_sorted(lambda _: next(sharded), params)

    def _zero3(self, params, batch):
        """The ZeRO-3 step: every parameter gathered whole, each rank
        computing its batch rows' whole sequence, each gradient
        reduce-scattered over the batch axes.  No step runs it: it is the
        yardstick the dry-run tests patch in for ``loss_and_grads``, the
        temp a step that gathers everything would hold."""
        mesh = self.mesh
        full = gathered(params)
        rows, axes = {}, ()
        for k, v in batch.items():
            rows[k], ax = _rows(k, v)
            if k == "labels":
                axes = ax

        def over_batch(x):
            for ax in axes:
                x = psum(x, ax, mesh=mesh)
            return x
        labels = rows["labels"]
        valid = (labels >= 0).sum().float()
        share_labels = valid / torch.clamp(over_batch(valid), min=1.0)
        share_rows = labels.shape[0] / batch["labels"].shape[0]
        leaves = sorted_leaves(full)
        for p in leaves:
            p.requires_grad_(True)
        xent, aux = self.model.loss_terms(full, rows)
        part = xent * share_labels + aux * share_rows
        grads = torch.autograd.grad(part, leaves, allow_unused=True, materialize_grads=True)
        sharded = iter([reduce_over(g, mesh, axes, p.placements)
                        for g, p in zip(grads, sorted_leaves(params))])
        return over_batch(part.detach()), tree_map_sorted(lambda _: next(sharded), params)

    def global_norm(self, grads) -> torch.Tensor:
        """The float32 norm of the whole gradient tree: each leaf's sum of
        squares over its shards, a replicated shard counted once (only the
        rank at coordinate 0 of each axis the leaf does not split adds it),
        summed over the mesh, then added in the reference's leaf order."""
        mesh = self.mesh
        coord = mesh.get_coordinate()
        parts = []
        for g in sorted_leaves(grads):
            owner = all(c == 0 or not p.is_replicate() for c, p in zip(coord, g.placements))
            sq = torch.sum(torch.square(local_value(g).float()))
            parts.append(sq if owner else torch.zeros_like(sq))
        per_leaf = torch.stack(parts)
        for ax in mesh.mesh_dim_names:
            per_leaf = psum(per_leaf, ax, mesh=mesh)
        return torch.sqrt(sum(per_leaf[i] for i in range(len(parts))))

    def __call__(self, params, opt_state, batch):
        """One step on the mesh; ``params`` and ``opt_state`` are written in
        place, shard by shard.  Returns (params, opt_state, {"loss",
        "grad_norm"}), the metrics the same on every rank."""
        loss, grads = self.loss_and_grads(params, batch)
        gn = self.global_norm(grads)

        def local(tree):
            return tree_map_sorted(local_value, tree)
        self.optimizer.apply(local(grads), AdamWState(local_value(opt_state.count),
                                                      local(opt_state.m), local(opt_state.v)),
                             local(params), gn)
        return params, opt_state, {"loss": loss, "grad_norm": gn}


def build_train(model: Model, mesh=None, total_steps: int = 10_000, peak_lr: float = 3e-4):
    """Returns (step, optimizer, {"params", "opt"} shardings).  Without a
    mesh the step is the one-device step and the shardings are None."""
    opt = make_optimizer(model.cfg, total_steps, peak_lr)
    if mesh is None:
        return TrainStep(model, opt), opt, {"params": None, "opt": None}
    specs = model.specs()
    p_sh = param_shardings(specs, mesh)
    m_sh = param_shardings(opt.moment_specs(specs), mesh)
    o_sh = AdamWState(Sharding(mesh, ()), m_sh, m_sh)
    return ShardedTrainStep(model, opt, mesh), opt, {"params": p_sh, "opt": o_sh}


@dataclasses.dataclass(frozen=True)
class PrefillStep:
    model: Model
    mesh: Any = None
    _plans: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def plan(self, x) -> tuple[TensorParallel, list, dict]:
        """The sharded prefill's plan for the (global) (B, S) of input ``x``
        (the tokens, or a VLM's embeds) under the active profile, its
        working layouts and the shardings of the cache it returns (every
        position; an SSM's of the decode cache's shape): made at the first
        call of that shape and kept."""
        key = (tuple(x.shape[:2]), active_profile().name)
        if key not in self._plans:
            model, specs = self.model, self.model.specs()
            tp = plan_prefill(model.cfg, specs, self.mesh, key[0])
            self._plans[key] = (tp, tp.layouts(specs),
                                param_shardings(model.cache_specs(*key[0], ring=False),
                                                self.mesh))
        return self._plans[key]

    @torch.no_grad()
    def __call__(self, params, batch):
        """``Model.prefill``: (the cache, the last token's logits).  Without
        a mesh on the parameters and inputs as they are; on a mesh sharded,
        the cache as ``DTensor``s laid out by ``Model.cache_specs`` of the
        batch's shape at every position, the logits a ``DTensor`` on the
        stream's rows and the vocabulary's columns where it splits
        (:func:`logits_tensor`)."""
        if self.mesh is None:
            return self.model.prefill(params, batch)
        x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        tp, layouts, cache_sh = self.plan(x)
        work = tp.weights(params, layouts, torch_dtype(self.model.cfg.compute_dtype),
                          weight_leaves(self.model.specs()))
        cache, logits = self.model.prefill(work, _stream_inputs(batch, tp), tp)
        return tree_map_sorted(from_shard, cache, cache_sh), \
            logits_tensor(logits, tp, x.shape[0], self.model.cfg.vocab)


def build_prefill(model: Model, mesh):
    """Returns (prefill step, {"params"} shardings)."""
    return PrefillStep(model, mesh), {"params": param_shardings(model.specs(), mesh)}


@dataclasses.dataclass(frozen=True)
class DecodeStep:
    model: Model
    mesh: Any = None
    _plans: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def plan(self, tokens, cache) -> tuple[TensorParallel, list]:
        """The sharded decode step's plan for ``tokens``' (global) shape and
        the cache's length (dimension 2 of a self-attention layer's ``k``,
        by name: never an encoder-decoder's ``cross`` entry, whose length is
        the frames'; an SSM cache's layout does not depend on it) under the
        active profile, and its working layouts: made at the first step of
        that shape and kept."""
        seq = next((entry["k"].shape[2] for name, entry in cache.items()
                    if name != "cross" and "k" in entry), 1)
        key = (tuple(tokens.shape), seq, active_profile().name)
        if key not in self._plans:
            model, specs = self.model, self.model.specs()
            B = key[0][0]
            tp = plan_decode(model.cfg, specs, model.cache_specs(B, seq), self.mesh, B)
            self._plans[key] = (tp, tp.layouts(specs))
        return self._plans[key]

    @torch.no_grad()
    def __call__(self, params, cache, inputs: dict):
        """One greedy token: (next token (B,) int32, logits (B, 1, V), the
        cache), the token whole on every rank; the cache written in place
        (on a mesh each rank's shard, the same ``DTensor``s).  On a mesh the
        logits are a ``DTensor`` on the stream's rows and their columns
        (:func:`logits_tensor`), never gathered, and the token their argmax
        over the ranks that split the columns
        (``TensorParallel.next_tokens``)."""
        if self.mesh is None:
            logits, cache = self.model.decode(params, cache, inputs["tokens"], inputs["pos"],
                                              positions=inputs.get("positions"))
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), logits, cache
        tp, layouts = self.plan(inputs["tokens"], cache)
        V = self.model.cfg.vocab
        work = tp.weights(params, layouts, torch_dtype(self.model.cfg.compute_dtype),
                          weight_leaves(self.model.specs()))
        rows = _stream_inputs(inputs, tp)
        logits, _ = self.model.decode(work, tree_map_sorted(local_value, cache),
                                      rows["tokens"], inputs["pos"],
                                      positions=rows.get("positions"), tp=tp)
        return tp.next_tokens(logits, V), \
            logits_tensor(logits, tp, inputs["tokens"].shape[0], V), cache


def logits_tensor(logits: torch.Tensor, tp: TensorParallel, B: int, n_vocab: int) -> DTensor:
    """This rank's (rows, 1, columns) logits as the ``DTensor`` of the
    (B, 1, V) logits laid out by ``tp.logits_spec()`` (its columns uneven
    where the vocabulary does not divide their axes); no collective."""
    return from_shard(logits, Sharding(tp.mesh, tp.logits_spec()), shape=(B, 1, n_vocab))


def build_decode(model: Model, mesh, cell: ShapeCell):
    """Returns (decode step, {"params", "cache"} shardings) for a cache of
    the cell's batch and sequence."""
    c_sh = param_shardings(model.cache_specs(cell.global_batch, cell.seq_len), mesh)
    return DecodeStep(model, mesh), {"params": param_shardings(model.specs(), mesh),
                                     "cache": c_sh}


def _seq_axes(x: DTensor) -> tuple[str, ...]:
    return tuple(ax for ax, p in zip(x.device_mesh.mesh_dim_names, x.placements)
                 if p.is_shard(2))


def ring_positions(P: int, Sc: int, window: int) -> torch.Tensor:
    """The prompt position each of a decode cache's ``Sc`` slots holds once
    a prompt of ``P`` tokens is seeded, -1 for none, as the engine seeds it:
    with a sliding ``window`` and a prompt of at least ``Sc`` tokens, the
    last ``Sc`` positions t at ring slot t % Sc; else position s at slot s
    below ``P``."""
    s = torch.arange(Sc)
    if window and P >= Sc:
        return P - Sc + (s - (P - Sc)) % Sc
    return torch.where(s < P, s, -1)


@torch.no_grad()
def seed_cache(prefill_cache, shardings, seq: int, window: int = 0):
    """A decode cache of ``seq`` positions (``min(seq, window)`` ring slots
    under a sliding ``window``) laid out by ``shardings`` (``build_decode``'s)
    holding the prompt's k, v from a sharded ``PrefillStep``'s cache
    (``DTensor``s of P positions) at the slots :func:`ring_positions` gives
    and zeros elsewhere, as the engine seeds its cache.  Each rank allocates
    its own shard; the rows of every rank's prefill shard that land in
    another's decode shard travel with their slots, so nothing is gathered
    beyond a decode shard: the two caches' sequence may split differently
    (a prompt whose length divides an axis into a cache whose length does
    not).  Over an axis that splits the prefill's sequence and not the
    decode cache's, the rows are gathered (each rank of it holds the decode
    shard's every position); over one that splits both, one exchange of
    uneven runs (major axis first); over one that splits only the decode
    cache's, each rank keeps the rows of its slots.  An SSM layer's ``ssm``
    and ``conv`` leaves hold no sequence (dimension 2 is the heads, or the
    conv's k - 1 positions), and an encoder-decoder's ``cross`` leaves hold
    the frames, whatever ``seq`` is: each rank's shard is copied into its
    decode shard, laid out again only where the two shardings differ."""
    def seed(src: DTensor, sh: Sharding) -> DTensor:
        mesh, local, P = sh.mesh, src.to_local(), src.shape[2]
        sizes = mesh_axis_sizes(mesh)
        entry = sh.spec[2]
        src_axes = _seq_axes(src)
        dst_axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes[ax] for ax in dst_axes)
        Sc = min(seq, window) if window else seq
        own = chunk_of(Sc, mesh, dst_axes)
        shape = list(local.shape)
        shape[2] = Sc // n
        out = torch.zeros(shape, dtype=local.dtype, device=local.device)
        where = ring_positions(P, Sc, window).to(local.device)
        slot = torch.full((P,), -1, dtype=torch.long, device=local.device)
        kept = (where >= 0).nonzero()[:, 0]
        slot[where[kept]] = kept
        gathered_axes = tuple(ax for ax in src_axes if ax not in dst_axes)
        pos = torch.arange(P, device=local.device)[chunk_of(P, mesh, src_axes)]
        local = gather_over(local, mesh, gathered_axes, 2)
        slot = slot[gather_over(pos, mesh, gathered_axes, 0)]
        sent = (slot >= 0).nonzero()[:, 0]
        rows, slot = local.movedim(2, 0)[sent], slot[sent]
        rank = slot // (Sc // n)              # the destination's index, major axis first
        stride = n
        for ax in dst_axes:
            stride //= sizes[ax]
            dest = rank // stride % sizes[ax]
            if ax not in src_axes:            # every rank of the axis holds these rows
                mine = dest == chunk_of(sizes[ax], mesh, (ax,)).start
                rows, slot, rank = rows[mine], slot[mine], rank[mine]
                continue
            order = torch.argsort(dest, stable=True)
            rows, slot, rank = rows[order], slot[order], rank[order]
            send = torch.bincount(dest, minlength=sizes[ax])
            ones = [1] * sizes[ax]
            recv = exchange_over(send, mesh, ax, ones, ones).tolist()
            send = send.tolist()
            rows, slot, rank = (exchange_over(t, mesh, ax, send, recv)
                                for t in (rows, slot, rank))
        out[:, :, slot - own.start] = rows.movedim(0, 2)
        return from_shard(out, sh)

    def carry(src: DTensor, sh: Sharding) -> DTensor:
        if tuple(src.placements) != tuple(sh.placements):
            src = src.redistribute(sh.mesh, sh.placements)
        return from_shard(src.to_local().clone(), sh)
    return {pos: {n: (seed if n in ("k", "v") and pos != "cross" else carry)(
        prefill_cache[pos][n], shardings[pos][n]) for n in sorted(entry)}
            for pos, entry in sorted(prefill_cache.items())}


def abstract_state(model: Model, opt: AdamW):
    """(params, opt_state) as ``meta`` tensors (shapes and dtypes, no
    bytes): parameters in the config's ``param_dtype``, moments in the
    optimizer's ``moment_dtype``, the count an int32 scalar."""
    specs = model.specs()
    params = abstract_params(specs, torch_dtype(model.cfg.param_dtype))
    mspec = opt.moment_specs(specs)
    m = abstract_params(mspec, torch_dtype(opt.moment_dtype))
    v = abstract_params(mspec, torch_dtype(opt.moment_dtype))
    count = torch.empty((), dtype=torch.int32, device="meta")
    return params, AdamWState(count, m, v)


def abstract_cache(model: Model, cell: ShapeCell):
    """The decode cache of the cell's batch and sequence as ``meta``
    tensors, each leaf in its spec's dtype."""
    return tree_map_pspec(
        lambda _, p: torch.empty(p.shape, dtype=torch_dtype(p.dtype), device="meta"),
        model.cache_specs(cell.global_batch, cell.seq_len))
