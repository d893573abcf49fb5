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

Serving (:func:`plan_prefill`, :func:`plan_decode`) adds the k / v cache's
own resolved layout, the reference's decode-SP one: its rows on
``cache_batch`` (``("pod", "data")`` under every profile, so it stays split
under ``serve``, where the stream's batch does not) and its sequence on
``cache_seq`` (``model``); ``heads`` cannot take ``model`` once
``cache_seq`` has it, so a rank holds every kv head of its sequence slice.

* Prefill runs the train forward's layout, and lays each layer's k, v out as
  the cache: where every rank computed every head, its own rows and
  sequence slice of them; where the q heads split and the kv heads do not,
  ``wk`` and ``wv`` are whole on every rank, so each rank projects its
  sequence slice of the normed stream with them (no bytes move); where the
  kv heads split, an all-to-all over each ``qkv`` axis trades heads for the
  cache's sequence (``model``) or rows (``data`` under ``serve``): the cache
  shard's bytes, once an axis.  The last token's hidden state lies on
  the rank holding position S - 1: it is gathered over the sequence, and
  the logits (vocab-parallel where the vocabulary splits) gathered whole.
* Decode's stream is this rank's batch rows of one token.  q covers every
  head (gathered over the ``qkv`` axes, one token a row), each rank attends
  over its sequence slice of the cache with a partial softmax, the partials
  are combined over the ``cache_seq`` axes, and ``wo`` runs row-parallel.
* The weights move in the compute type: a leaf the working layout gathers
  is cast before it travels (each product casts it there anyway).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..optim.adamw import tree_map_sorted
from ..substrate import (Sharding, all_to_all_over, chunk_of, gather_over, max_over,
                         mesh_axis_sizes, reduce_over, scatter_over, sum_over)
from .common import resolve_spec, sorted_leaves, tree_map_pspec
from .transformer import cache_specs

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


def _heads(cfg: ArchConfig, n: int) -> tuple[int, int]:
    """This rank's q heads and the kv heads its attention uses over ``n``
    ranks of ``qkv`` (:func:`head_split`): a split share, or all of them,
    or the one kv head of this rank's GQA group."""
    q_local, kv_local = head_split(cfg.n_heads, cfg.n_kv_heads, n)
    q_heads = cfg.n_heads // n if q_local else cfg.n_heads
    kv_heads = cfg.n_kv_heads // n if kv_local else 1 if q_local else cfg.n_kv_heads
    return q_heads, kv_heads


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
    rows = B // parts["batch"]
    T = rows * S
    q_heads, kv_heads = _heads(cfg, n)
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


def hand_prefill_flops(cfg: ArchConfig, B: int, S: int, parts: dict[str, int]) -> int:
    """The product FLOPs one rank runs in a swiglu decoder's sharded prefill
    of (B, S) tokens, counted by hand from the widths (the dry-run's trace
    must equal it).  ``parts`` gives the ranks each of ``batch``, ``seq``,
    ``qkv``, ``ffn``, ``vocab``, ``cache_batch`` and ``cache_seq`` splits
    over.  The train forward's products (every (q, k) tile of the chunked
    attention for this rank's q heads, masked tiles included); where the q
    heads split and the kv heads do not, the cache's k and v projected on
    this rank's cache rows and sequence slice with every kv head; the last
    token's logits on this rank's rows and vocabulary columns."""
    d, hd, L, V = cfg.d_model, cfg.hd, cfg.n_layers, cfg.vocab
    n = parts["qkv"]
    q_local, kv_local = head_split(cfg.n_heads, cfg.n_kv_heads, n)
    q_heads, kv_heads = _heads(cfg, n)
    rows = B // parts["batch"]
    T = rows * S
    per_layer = 2 * T * d * hd * (q_heads + 2 * kv_heads) + 2 * T * (cfg.n_heads * hd // n) * d \
        + 3 * 2 * T * d * (cfg.d_ff // parts["ffn"])
    qc, kc = min(512, S), min(1024, S)
    per_layer += 4 * rows * q_heads * hd * (-(-S // qc) * qc) * (-(-S // kc) * kc)
    if q_local and not kv_local:
        per_layer += 2 * 2 * (B // parts["cache_batch"]) * (S // parts["cache_seq"]) * d \
            * cfg.n_kv_heads * hd
    return L * per_layer + 2 * rows * d * (V // parts["vocab"])


def hand_decode_flops(cfg: ArchConfig, B: int, S: int, parts: dict[str, int]) -> int:
    """The product FLOPs one rank runs in a swiglu decoder's sharded decode
    step of B tokens against a cache of S positions, counted by hand (the
    dry-run's trace must equal it; ``parts`` as :func:`hand_prefill_flops`).
    Each layer: q on this rank's stream rows and q heads, k and v on them
    with this rank's kv heads where they split, else every kv head (the
    whole ``wk`` / ``wv``); the scores and the weighted sum of v for every
    q head over this rank's cache rows and sequence slice; its rows of
    ``wo`` and its columns of the MLP; the logits on its rows and vocabulary
    columns."""
    d, hd, L, V = cfg.d_model, cfg.hd, cfg.n_layers, cfg.vocab
    n = parts["qkv"]
    q_local, kv_local = head_split(cfg.n_heads, cfg.n_kv_heads, n)
    q_heads = cfg.n_heads // n if q_local else cfg.n_heads
    kv_heads = cfg.n_kv_heads // n if kv_local else cfg.n_kv_heads
    rows = B // parts["batch"]
    per_layer = 2 * rows * d * hd * (q_heads + 2 * kv_heads) \
        + 2 * rows * (cfg.n_heads * hd // n) * d + 3 * 2 * rows * d * (cfg.d_ff // parts["ffn"]) \
        + 4 * (B // parts["cache_batch"]) * cfg.n_heads * hd * (S // parts["cache_seq"])
    return L * per_layer + 2 * rows * d * (V // parts["vocab"])


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
    # serving plans only: a k / v cache leaf's resolved spec, the mesh axes its
    # rows split over beyond the stream's, and those of its sequence
    cache_spec: tuple | None = None
    cache_row_axes: tuple[str, ...] = ()
    cache_seq_axes: tuple[str, ...] = ()

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

    def head_cols(self, ctx: torch.Tensor, all_heads: bool = False) -> torch.Tensor:
        """This rank's columns of the attention output, the rows of ``wo`` it
        holds: all of it where the heads split, its chunk where every rank
        computed every head (``all_heads``: ``ctx`` holds every head)."""
        if self.q_local and not all_heads:
            return ctx
        return ctx[..., chunk_of(ctx.shape[-1], self.mesh, self.qkv_axes)]

    def all_heads(self, t: torch.Tensor, split: bool) -> torch.Tensor:
        """(B, S, heads, hd) -> every head: gathered over the ``qkv`` axes
        where this rank holds a ``split`` share of them."""
        return gather_over(t, self.mesh, self.qkv_axes, 2) if split else t

    def heads_to_cache(self, t: torch.Tensor) -> torch.Tensor:
        """(B, S, heads / n, hd), this rank's kv heads over its stream rows'
        whole sequence -> its cache shard, every kv head over the cache's
        rows and sequence slice: an all-to-all over each ``qkv`` axis, the
        minor one first, each trading heads for the cache's rows or its
        sequence (:func:`plan_prefill` checks that each axis splits one of
        them)."""
        for ax in reversed(self.qkv_axes):
            t = all_to_all_over(t, self.mesh, ax, 0 if ax in self.cache_row_axes else 1, 2)
        return t

    # -------------------------------------------------------------- cache
    def cache_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's stream rows (dimension 0) -> its cache's rows."""
        return x[chunk_of(x.shape[0], self.mesh, self.cache_row_axes)]

    def stream_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The cache's rows -> the stream's (gathered where the cache
        splits them further)."""
        return gather_over(x, self.mesh, self.cache_row_axes, 0)

    def cache_seq(self, n: int) -> slice:
        """This rank's slice of a cache of ``n`` positions."""
        return chunk_of(n, self.mesh, self.cache_seq_axes)

    def seq_max(self, x: torch.Tensor) -> torch.Tensor:
        return max_over(x, self.mesh, self.cache_seq_axes)

    def seq_sum(self, x: torch.Tensor) -> torch.Tensor:
        return sum_over(x, self.mesh, self.cache_seq_axes)

    def last_token(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S / parts, D) -> (B, 1, D): the hidden state at the last
        position, from the rank of the sequence axes that holds it."""
        return gather_over(x[:, -1:], self.mesh, self.seq_axes, 1)[:, -1:]

    def whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's rows and vocabulary columns of (B, 1, V) logits ->
        all of them, the same on every rank."""
        logits = gather_over(logits, self.mesh, self.vocab_axes, -1)
        return gather_over(logits, self.mesh, self.batch_axes, 0)

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

    def working(self, params, layouts, dtype: torch.dtype | None = None) -> dict:
        """This rank's working shard of every parameter (``DTensor``s) in
        ``layouts`` (:meth:`layouts` of their specs): a tree like
        ``params``.  With ``dtype`` (serving: the compute type) a leaf that
        moves is cast before it travels; every such leaf of the dense family
        (a product's weight, the embedding table) is cast to the compute
        type at its use, so the values computed are the same."""
        def work(p, sh):
            if dtype is not None and tuple(p.placements) != tuple(sh.placements):
                # the shard cast and wrapped again: a DTensor op would build
                # its global-size output to propagate the layout
                p = DTensor.from_local(p.to_local().to(dtype), p.device_mesh, p.placements,
                                       run_check=False, shape=p.shape, stride=p.stride())
            return p.redistribute(self.mesh, sh.placements).to_local()
        with torch.no_grad():
            work = iter([work(p, sh) for p, sh in zip(sorted_leaves(params), layouts)])
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


def _with_cache(tp: TensorParallel, cfg: ArchConfig, cache_specs,
                mesh: DeviceMesh) -> TensorParallel:
    """``tp`` with the layout of ``cache_specs``' k / v leaves ((periods, B,
    S, Hkv, hd)).  Raises ValueError where the cache splits its heads (not
    the decode-SP layout) or its rows are not a split of the stream's."""
    sizes = mesh_axis_sizes(mesh)
    specs: set = set()

    def note(_, p):
        if p.logical[2] == "cache_seq":
            specs.add(resolve_spec(p.shape, p.logical, sizes))
    tree_map_pspec(note, cache_specs)
    if len(specs) != 1:
        raise ValueError(f"{cfg.name}: the cache's k / v leaves lay out as {sorted(specs)}")
    spec = next(iter(specs))

    def live(entry):
        return tuple(ax for ax in _axes(entry) if sizes[ax] > 1)
    rows, sq = live(spec[1]), live(spec[2])
    if live(spec[3]) or live(spec[4]):
        raise ValueError(f"{cfg.name}: the cache splits its heads as {spec}")
    if rows[:len(tp.batch_axes)] != tp.batch_axes:
        raise ValueError(f"the cache's rows on {rows} do not split the stream's {tp.batch_axes}")
    return dataclasses.replace(tp, cache_spec=spec, cache_row_axes=rows[len(tp.batch_axes):],
                               cache_seq_axes=sq)


def plan_prefill(cfg: ArchConfig, spec_tree, mesh: DeviceMesh, batch_shape) -> TensorParallel:
    """The plan of a sharded prefill of ``batch_shape`` (B, S) tokens: the
    stream laid out as the tokens (``batch``, ``seq``), and the cache of
    (B, S) as the decode-SP layout.  Where the kv heads split, each of their
    axes must split the cache's sequence or, beyond the stream's, its rows,
    at most one axis each, and the cache split over nothing else: the
    all-to-alls that lay it out (ValueError otherwise)."""
    sizes = mesh_axis_sizes(mesh)
    B, S = batch_shape
    stream = resolve_spec((B, S), ("batch", "seq"), sizes)
    tp = _with_cache(tensor_parallel(cfg, spec_tree, mesh, stream), cfg,
                     cache_specs(cfg, B, S), mesh)
    if tp.kv_local:
        rows, seq = set(tp.cache_row_axes), set(tp.cache_seq_axes)
        if set(tp.qkv_axes) != rows | seq or len(rows) > 1 or len(seq) > 1:
            raise ValueError(f"kv heads split over {tp.qkv_axes}, the cache's rows over "
                             f"{tp.cache_row_axes} and sequence over {tp.cache_seq_axes}: "
                             "no all-to-all lays the cache out")
    return tp


def plan_decode(cfg: ArchConfig, spec_tree, cache_spec_tree, mesh: DeviceMesh,
                batch: int) -> TensorParallel:
    """The plan of a sharded decode step of ``batch`` tokens against the
    cache of ``cache_spec_tree`` (``Model.cache_specs``): the stream this
    rank's batch rows of one token, the cache its own resolved layout."""
    stream = resolve_spec((batch, 1), ("batch", "seq"), mesh_axis_sizes(mesh))
    return _with_cache(tensor_parallel(cfg, spec_tree, mesh, stream), cfg, cache_spec_tree,
                       mesh)
