"""The layout a tensor- and sequence-parallel train step computes in on one
rank of a mesh (the dense decoders), as the reference's ``LOGICAL_RULES``
(``models/common.py``) lay a step out and XLA partitions it.

* The residual stream is this rank's batch rows and sequence slice: the
  labels' own layout (``batch`` on ``("pod", "data")`` and ``seq`` on
  ``model`` under the baseline profile).  A block gathers the normed stream's
  sequence before its products; its output comes back summed into the slice.
* A weight is gathered over its ``embed`` / ``embed_d`` axes only (FSDP); its
  ``qkv``, ``ffn`` or ``vocab`` shard stays local (:meth:`TensorParallel.
  working_shardings`).  So ``wq``, ``wk``, ``wv``, ``wg``, ``wu`` (or ``w1``)
  are column-parallel and ``wo``, ``wd`` (or ``w2``) row-parallel: their
  partial sums are reduce-scattered into the sequence slice.
* Heads: attention runs head-parallel only where the heads split whole
  (:func:`head_split`); elsewhere ``wq``, ``wk`` and ``wv`` are gathered
  whole and every rank computes every head, and ``wo`` takes this rank's
  columns of the attention output.  Where the q heads split and the kv heads
  do not, ``wk`` and ``wv`` are gathered whole and each rank takes the
  columns of the kv heads its q heads use (GQA groups).
* The embedding and the loss: where ``vocab`` splits, the look-up and the
  cross-entropy are vocab-parallel (each rank its rows of the table; the
  softmax's max and sum and the gold logit summed over the vocab axes);
  where it does not, each rank holds the whole table and computes its own
  tokens.

Every rank computes a share of one loss and the step sums the shares, so the
collectives (``substrate.gather_over``, ``scatter_over``, ``sum_over``) are
differentiated as their adjoints under that sum, and a value several ranks
compute alike (the tokens the batch and sequence axes do not split) weighs
``1 / replicas`` on each.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..configs.base import ArchConfig
from ..optim.adamw import tree_map_sorted
from ..substrate import (Sharding, chunk_of, gather_over, max_over, mesh_axis_sizes,
                         reduce_over, scatter_over, sum_over)
from .common import resolve_spec, sorted_leaves, tree_map_pspec

#: the logical axes a weight is gathered over before its product (FSDP)
FSDP_LOGICAL = ("embed", "embed_d")


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def head_split(n_heads: int, n_kv_heads: int, n: int) -> tuple[bool, bool]:
    """Whether attention splits its q heads, and its kv heads, over ``n``
    ranks: the q heads where they split whole and each rank's q heads use
    whole kv heads or lie in one GQA group; the kv heads where they also
    split whole."""
    q = n_heads % n == 0 and (n_kv_heads % n == 0 or n % n_kv_heads == 0)
    return q, q and n_kv_heads % n == 0


def hand_train_flops(cfg: ArchConfig, B: int, S: int, parts: dict[str, int]) -> int:
    """The product FLOPs one rank runs in a swiglu decoder's tensor-parallel
    train step under ``remat = "full"``, counted by hand from the widths
    (the dry-run's trace of the step must equal it).  ``parts`` gives the
    ranks each of ``batch``, ``seq``, ``qkv``, ``ffn`` and ``vocab`` splits
    over (1 where it does not split).  Each layer's products run on this
    rank's rows of the whole sequence and its columns: its q heads (all of
    them where they do not split, :func:`head_split`), the kv heads they use,
    its rows of ``wo``, its columns of the MLP; every (q, k) tile of the
    chunked attention for its q heads (masked tiles included); the
    unembedding on its columns of the vocabulary where that splits, else on
    the whole vocabulary for its own tokens.  4 times the forward (the
    forward, the recompute and the chunked loss's, and the backward's two
    products a product), less each layer's down projection: the
    non-reentrant checkpoint stops once the tensors the backward needs are
    back, and the block's last product saves none."""
    if cfg.remat != "full":
        raise ValueError(f"counted for remat 'full', not {cfg.remat!r}")
    d, hd, L, V = cfg.d_model, cfg.hd, cfg.n_layers, cfg.vocab
    n = parts["qkv"]
    q_local, kv_local = head_split(cfg.n_heads, cfg.n_kv_heads, n)
    rows = B // parts["batch"]
    T = rows * S
    q_heads = cfg.n_heads // n if q_local else cfg.n_heads
    kv_heads = cfg.n_kv_heads // n if kv_local else 1 if q_local else cfg.n_kv_heads
    ff = cfg.d_ff // parts["ffn"]
    per_layer = 2 * T * d * hd * (q_heads + 2 * kv_heads) + 2 * T * (cfg.n_heads * hd // n) * d \
        + 3 * 2 * T * d * ff
    qc, kc = min(512, S), min(1024, S)
    sq, sk = -(-S // qc) * qc, -(-S // kc) * kc
    attn = 4 * rows * q_heads * hd * sq * sk
    if parts["vocab"] > 1:
        loss = 2 * T * d * (V // parts["vocab"])
    else:
        loss = 2 * rows * (S // parts["seq"]) * d * V
    return 4 * (L * (per_layer + attn) + loss) - L * 2 * T * ff * d


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    mesh: DeviceMesh
    batch_axes: tuple[str, ...]   # the stream's rows
    seq_axes: tuple[str, ...]     # the stream's sequence
    qkv_axes: tuple[str, ...]     # the q / k / v / o head dimension
    ffn_axes: tuple[str, ...]
    vocab_axes: tuple[str, ...]   # () where the vocabulary does not split
    q_local: bool                 # q heads split over qkv_axes (else all on every rank)
    kv_local: bool                # kv heads split too (else gathered whole)
    stream_spec: tuple            # the labels' resolved spec: the stream's layout

    @property
    def stream(self) -> Sharding:
        return Sharding(self.mesh, self.stream_spec)

    def parts(self, axes) -> int:
        sizes = mesh_axis_sizes(self.mesh)
        return math.prod(sizes[ax] for ax in axes)

    @property
    def replicas(self) -> int:
        """Ranks that hold the same tokens of the stream."""
        return self.mesh.mesh.numel() // self.parts(self.batch_axes + self.seq_axes)

    # ------------------------------------------------------------- stream
    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S / parts, ...) -> (B, S, ...): the whole sequence of this
        rank's rows."""
        return gather_over(x, self.mesh, self.seq_axes, 1)

    def to_stream(self, y: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
        """A (B, S, D) value summed over ``axes`` (a product's partial sums)
        and cut to this rank's sequence slice: a reduce-scatter where the
        two are the same axes, else an all-reduce and a local slice."""
        if axes and axes == self.seq_axes:
            return scatter_over(y, self.mesh, axes, 1)
        y = sum_over(y, self.mesh, axes)
        return y[:, chunk_of(y.shape[1], self.mesh, self.seq_axes)] if self.seq_axes else y

    def pad_seq(self, labels: torch.Tensor) -> torch.Tensor:
        """(B, S / parts) labels -> (B, S): this rank's at their positions,
        -1 (no label) elsewhere."""
        n = labels.shape[1] * self.parts(self.seq_axes)
        own = chunk_of(n, self.mesh, self.seq_axes)
        return F.pad(labels, (own.start, n - own.stop), value=-1)

    # -------------------------------------------------------------- heads
    def kv_heads(self, w: torch.Tensor, hd: int) -> torch.Tensor:
        """The columns of a whole ``wk`` / ``wv`` (D, Hkv * hd) holding the kv
        heads this rank's q heads use; a split or all-heads weight as it
        is."""
        if self.kv_local or not self.q_local:
            return w
        n = self.parts(self.qkv_axes)
        hkv = w.shape[-1] // hd
        # q heads [c * hq / n, (c + 1) * hq / n) lie in kv head c * hkv / n
        c = chunk_of(n, self.mesh, self.qkv_axes).start
        j = c * hkv // n
        return w[..., j * hd:(j + 1) * hd]

    def head_cols(self, ctx: torch.Tensor) -> torch.Tensor:
        """This rank's columns of the attention output, the rows of ``wo`` it
        holds: all of it where the heads split, its chunk where every rank
        computed every head."""
        if self.q_local:
            return ctx
        return ctx[..., chunk_of(ctx.shape[-1], self.mesh, self.qkv_axes)]

    # -------------------------------------------------------------- vocab
    def vocab_rows(self, n_vocab: int) -> slice:
        return chunk_of(n_vocab, self.mesh, self.vocab_axes)

    def vocab_sum(self, x: torch.Tensor) -> torch.Tensor:
        return sum_over(x, self.mesh, self.vocab_axes)

    def vocab_max(self, x: torch.Tensor) -> torch.Tensor:
        return max_over(x, self.mesh, self.vocab_axes)

    # ------------------------------------------------------------ weights
    def working_shardings(self, spec_tree):
        """Per parameter leaf, the layout the step computes with: its spec
        without the FSDP axes, or replicated for a ``wq`` / ``wk`` / ``wv``
        whose heads do not split."""
        sizes = mesh_axis_sizes(self.mesh)

        def work(path, p):
            name = path.rsplit("/", 1)[-1]
            whole = (name == "wq" and not self.q_local) or \
                (name in ("wk", "wv") and not self.kv_local)
            spec = resolve_spec(p.shape, p.logical, sizes)
            return Sharding(self.mesh, tuple(None if whole or lname in FSDP_LOGICAL else entry
                                             for entry, lname in zip(spec, p.logical)))
        return tree_map_pspec(work, spec_tree)

    def layouts(self, spec_tree) -> list:
        """:meth:`working_shardings` in sorted leaf order."""
        return sorted_leaves(self.working_shardings(spec_tree))

    def working(self, params, layouts) -> dict:
        """This rank's working shard of every parameter (``DTensor``s) in
        ``layouts`` (:meth:`layouts` of their specs): a tree like
        ``params``."""
        with torch.no_grad():
            work = iter([p.redistribute(self.mesh, sh.placements).to_local()
                         for p, sh in zip(sorted_leaves(params), layouts)])
        return tree_map_sorted(lambda _: next(work), params)

    def reduce_grads(self, grads, params, layouts) -> list:
        """Each working gradient (sorted leaf order) summed over the mesh
        axes its layout does not split (each rank's part of the loss reaches
        the leaf there) into its parameter's layout: ``DTensor``s."""
        def summed(sh):
            used = {ax for entry in sh.spec for ax in _axes(entry)}
            return tuple(ax for ax in self.mesh_axes if ax not in used)
        return [reduce_over(g, self.mesh, summed(sh), p.placements, layout=sh.placements,
                            shape=p.shape)
                for g, sh, p in zip(grads, layouts, sorted_leaves(params))]

    @property
    def mesh_axes(self) -> tuple[str, ...]:
        """The mesh axes of more than one rank (an axis of one moves
        nothing)."""
        return tuple(ax for ax, n in mesh_axis_sizes(self.mesh).items() if n > 1)


def tensor_parallel(cfg: ArchConfig, spec_tree, mesh: DeviceMesh,
                    stream_spec) -> TensorParallel:
    """The plan of ``cfg``'s step on ``mesh`` under the active profile:
    ``stream_spec`` is the labels' resolved spec (batch entry, seq entry),
    the weights' axes come from ``spec_tree``'s resolved specs (axes of one
    rank left out).  Raises ValueError where two leaves split one logical
    axis differently (``wk`` and ``wv`` count only where their heads split),
    or a weight's split meets the batch's axes (its ranks would hold other
    rows)."""
    sizes = mesh_axis_sizes(mesh)

    def live(axes):
        return tuple(ax for ax in axes if sizes[ax] > 1)
    found: dict[str, set] = {"qkv": set(), "kv": set(), "ffn": set(), "vocab": set()}

    def note(path, p):
        kv = path.rsplit("/", 1)[-1] in ("wk", "wv")
        for entry, lname in zip(resolve_spec(p.shape, p.logical, sizes), p.logical):
            if lname in found:
                found["kv" if kv and lname == "qkv" else lname].add(live(_axes(entry)))
    tree_map_pspec(note, spec_tree)
    batch_axes, seq_axes = (live(_axes(e)) for e in stream_spec)
    axes = {}
    for lname in ("qkv", "ffn", "vocab"):
        if len(found[lname]) > 1:
            raise ValueError(f"the leaves split {lname!r} as {sorted(found[lname])}")
        axes[lname] = next(iter(found[lname]), ())
        if set(axes[lname]) & set(batch_axes):
            raise ValueError(f"{lname!r} on {axes[lname]} meets the batch's {batch_axes}")
    q_local, kv_local = head_split(cfg.n_heads, cfg.n_kv_heads,
                                   math.prod(sizes[ax] for ax in axes["qkv"]))
    if kv_local and found["kv"] - {axes["qkv"]}:
        raise ValueError(f"wk / wv split as {sorted(found['kv'])}, wq as {axes['qkv']}")
    return TensorParallel(mesh, batch_axes, seq_axes, axes["qkv"], axes["ffn"], axes["vocab"],
                          q_local, kv_local, tuple(stream_spec))


def plan_train(cfg: ArchConfig, spec_tree, mesh: DeviceMesh, batch_shape) -> TensorParallel:
    """:func:`tensor_parallel` for a train batch of ``batch_shape`` (B, S)
    tokens: the stream laid out as the labels (``batch``, ``seq``)."""
    stream = resolve_spec(tuple(batch_shape), ("batch", "seq"), mesh_axis_sizes(mesh))
    return tensor_parallel(cfg, spec_tree, mesh, stream)
