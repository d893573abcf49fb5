"""The layout a tensor- and sequence-parallel train step computes in on one
rank of a mesh (every family: the dense, MoE, SSM, hybrid and VLM decoders
and the encoder-decoder), as the reference's ``LOGICAL_RULES``
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
  whole, each rank projects k and v over its rows' whole sequence and q,
  every head, over its query slice of it (:attr:`TensorParallel.
  q_slice_axes`, the ``qkv`` axes; the sequence padded to a multiple of
  their ranks), attends there (the causal mask and any window at the
  slice's positions), and an all-to-all over those axes brings the output
  to the columns of ``wo``'s rows this rank holds, over the whole sequence
  (its backward the inverse all-to-all).  Where the q heads split and the
  kv heads do not, ``wk`` and ``wv`` are gathered whole and each rank takes
  the columns of the kv heads its q heads use (GQA groups).
* Experts (``models.moe``): the router is whole on every rank, which
  routes its own tokens.  Where ``experts`` resolves to mesh axes
  (:attr:`TensorParallel.expert_axes`: dbrx's 16 on ``model``, ``expert``
  under ``moe_ep``), an expert weight keeps its ``experts`` and ``ffn``
  shards and the dispatched tokens, the hidden activations and the
  experts' outputs move (an all-to-all over the expert axes that split the
  sequence, a gather and reduce-scatter over the hidden columns' axes that
  do); where it resolves to nothing (mixtral's 8 on a 16-way ``model``),
  every rank runs every expert on its own groups and the expert weights
  move, gathered over the hidden columns' axes that split the sequence (the
  reference's pins give ``ffn``'s axis to the groups there).
* SSM heads (``models.ssm``): head-parallel over the axes the decode
  cache's ``ssm`` leaf splits its heads over (:attr:`TensorParallel.
  ssm_head_axes`: ``model`` at (16, 16) under both profiles), one layout
  for the train step, prefill and decode.  ``in_proj`` keeps its stored
  ``ssm_inner`` columns; its output (z | x, B, C | dt, split contiguously)
  moves to this rank's heads' z, x and dt and the shared B and C by an
  exchange of uneven runs over the head axis (:meth:`TensorParallel.
  ssm_columns`); ``conv_w``, ``conv_b`` and the per-head vectors are whole,
  ``norm`` and ``out_proj`` this rank's heads' rows (gathered to whole
  heads where ``serve`` splits them further).  Each head's chunked SSD and
  its float32 recurrence are the one-device code; the gated norm's sum of
  squares is summed over the head axes, and ``out_proj`` is row-parallel.
* The hybrid (jamba) and the VLM (qwen2-vl) compose these blocks on one
  plan: the hybrid's attention, MLP, MoE and SSM layers each as above (its
  decode cache holds k / v and ``ssm`` / ``conv`` leaves, each kind in its
  own layout: :func:`_with_cache`); the VLM is the dense family fed
  ``embeds`` on the stream and M-RoPE's (3, B, S) positions on its rows
  over the whole sequence.  The hand FLOP counts sum each layer of the
  pattern (:func:`_layer_products`).
* The encoder-decoder (whisper): the encoder's frames are a stream of their
  own, this rank's rows and its slice of the frames' sequence where
  ``enc_seq`` divides the ``seq`` axes (:attr:`TensorParallel.encoder`, the
  decoder's plan with that sequence; at (16, 16) the 1500 frames do not
  split, and a block's partial sums are then all-reduced).  Cross-attention
  takes q from the decoder's gathered stream and k, v from this rank's rows
  of the encoder's output over every frame (gathered over the frames' axes
  once a forward), on the heads :func:`head_split` gives (where they do not
  split, q on this rank's query slice, as the self-attention's); ``wo`` sums
  into the decoder's slice.
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
  the logits (vocab-parallel where the vocabulary splits) stay on this
  rank's rows and columns.
* Decode's stream is this rank's batch rows of one token.  ``wq``, ``wk``
  and ``wv`` keep their ``qkv`` columns whether or not the heads split
  (gathered over their embed axes only): each rank projects its rows onto
  its columns and q, k and v are gathered over the ``qkv`` axes, every head
  a row; each rank attends over its sequence slice of the cache with a
  partial softmax, the partials are combined over the ``cache_seq`` axes,
  and ``wo`` runs row-parallel.
* Where decode's rows split over the tables' embed axes (``data`` under the
  baseline profile: :attr:`TensorParallel.table_axes`), the tables stay on
  their embed shards, as XLA partitions the reference's step: the rows'
  token ids are gathered over those axes, each rank looks up its columns of
  every row and one all-to-all brings each row's columns to the rank that
  holds it; the unembedding sends the columns back by the inverse
  all-to-all, each rank computes every row's partial logits on its
  vocabulary columns (the ``vocab`` shard, or a ``torch.chunk``-style
  slice of them over the other axes where the vocabulary does not split:
  :attr:`TensorParallel.logit_axes`) and a reduce-scatter brings them back
  onto the rows.  No serving step gathers the logits: they stay on the
  stream's rows and their columns (:meth:`TensorParallel.logits_spec`), and
  decode's next token is an argmax over the column axes
  (:meth:`TensorParallel.next_tokens`).
* Where decode's rows do not split over a weight's ``embed`` axes (one row
  under the baseline profile: the rows leave ``data`` whole), the weights
  stay on their embed shards and the token moves, as XLA partitions the
  reference's step (:attr:`TensorParallel.stationary_axes`): a product
  contracting ``embed`` takes this rank's slice of the row and sums the
  partial products over those axes (:meth:`TensorParallel.embed_in`), one
  whose output lies on ``embed`` computes this rank's columns, sums them as
  the stream needs and gathers the columns (:meth:`TensorParallel.columns`
  over those axes); q, k, v, the router's logits and the SSM conv's output
  (:attr:`TensorParallel.conv_local`) are computed on the weights' own
  columns or channels and gathered.  No weight moves.
* The encoder-decoder's cross cache has a layout of its own (its length is
  the frames', not the prompt's): :attr:`TensorParallel.cross` is the plan
  with it in the self cache's place.  Prefill lays it out as the self cache;
  decode attends over it with the same partial softmax, combined over its
  sequence axes, and never writes it.
* The SSM family's cache is the reference's too: the state's rows on
  ``cache_batch`` and its heads on ``ssm_inner`` (this rank's heads: the
  prefill's final state is its shard, no bytes move), the conv history's
  channels on ``ssm_inner`` (a contiguous split that straddles heads: the
  prefill's last k - 1 positions and decode's history are gathered over
  the axes that split them, a few rows of channels, and each rank keeps
  its stored shard).  Decode gathers the one-token ``zxbcdt`` row whole,
  runs the conv on every channel and the recurrence on this rank's heads.
* The stacked blocks are gathered a period at a time, where the period runs
  (:class:`StackedWeights`, :class:`_PeriodGather`), as the reference's
  ``lax.scan`` of ``jax.checkpoint(body)`` gathers its step's weight shards:
  again in the train step's recompute, and each period's gradients summed
  into the shards as the backward leaves it.  The tables and the final norms
  are gathered before the model runs and summed after the backward
  (:meth:`TensorParallel.weights`).
* The serving steps' weights, and the train step's expert weights, move in
  the compute type: a leaf the working layout gathers is cast before it
  travels (each product casts it there anyway; the SSM's gated-norm scale,
  applied in float32, travels in its own type: :func:`weight_leaves`).
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
from ..substrate import (Sharding, all_to_all_over, chunk_of, gather_over, local_value,
                         max_over, mesh_axis_sizes, scatter_over, sum_over, trade_over)
from . import encdec
from .common import resolve_spec, sorted_leaves, tree_map_pspec
from .moe import GROUP
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


def _moe_products(cfg: ArchConfig, rows: int, S: int, parts: dict[str, int]) -> dict:
    """One MoE block's forward product FLOPs on one rank (:func:`moe.moe` on a
    plan): ``rows`` batch rows of ``S // parts["seq"]`` tokens, in groups of
    ``min(GROUP, S)`` tokens of the whole sequence (a rank's fragment of a
    group where it spans ranks, with a whole group's ``C`` slots an
    expert); ``parts["experts"]`` and ``parts["expert_ffn"]`` are the ranks
    that split the experts and their hidden columns among the ranks holding
    the same tokens (1 where those axes split the sequence: the tokens cross
    them instead).  The router; the combine weights (the gate over the
    capacity slots); the dispatch and the combine einsums on this rank's
    experts; the three expert products over every capacity slot.  An
    einsum that contracts one element (a one-token group's dispatch; the
    combine of one expert's one slot) is a broadcast product: no FLOPs.
    ``parts["embed"]`` (a decode plan's stationary axes) splits ``d_model``
    in every product but the combine weights', and the router's columns
    over the experts' axes."""
    d, E, K = cfg.d_model // parts.get("embed", 1), cfg.n_experts, cfg.top_k
    s_local = S // parts["seq"]
    gs = min(GROUP, S)
    gl = min(gs, s_local)
    C = max(1, int(cfg.capacity_factor * gs * K / E))
    T = rows * s_local
    e_local = E // parts.get("experts", 1)
    router_cols = E // parts.get("experts", 1) if parts.get("embed", 1) > 1 else E
    return dict(router=2 * T * d * router_cols, route=2 * T * E * C * K,
                dispatch=2 * T * e_local * C * d if gl > 1 else 0,
                experts=3 * 2 * rows * (s_local // gl) * e_local * C * d
                * (cfg.d_ff // parts.get("expert_ffn", 1)),
                combine=2 * T * e_local * C * d if e_local * C > 1 else 0)


def spec_entry(axes: tuple[str, ...]):
    """Mesh axes as a spec entry: None, one name, or a tuple of names."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


def ssm_runs(cfg: ArchConfig, n: int, j: int) -> list[tuple[int, int]]:
    """The columns of ``in_proj``'s output (z | x, B, C | dt) that the heads
    of rank ``j`` of ``n`` use, as [start, stop) runs in column order: its
    heads' z and x channels, the B and C every head shares, its heads' dt."""
    di, H, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    w, h = di // n, H // n
    return [(w * j, w * (j + 1)), (di + w * j, di + w * (j + 1)), (2 * di, 2 * di + 2 * N),
            (2 * di + 2 * N + h * j, 2 * di + 2 * N + h * (j + 1))]


def _ssm_products(cfg: ArchConfig, rows: int, S: int, parts: dict[str, int]) -> dict:
    """One SSM block's forward product FLOPs on one rank (:func:`ssm.
    ssd_prefill` on a plan): ``rows`` batch rows of the whole sequence of S
    tokens in ``ceil(S / Q)`` chunks of Q = min(ssm_chunk, S);
    ``parts["ssm_inner"]`` the ranks ``in_proj``'s columns split over and
    ``parts["ssm_heads"]`` those of the heads.  ``in_proj`` on the stored
    columns; the chunks' C.B scores on every rank (B and C are shared); the
    intra-chunk output, the chunk states and the inter-chunk output on this
    rank's heads; ``out_proj`` on its heads' rows."""
    d, di, H, P, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    nc = -(-S // Q)
    h = H // parts["ssm_heads"]
    T = rows * S
    return dict(in_proj=2 * T * d * ((2 * di + 2 * N + H) // parts["ssm_inner"]),
                scores=2 * rows * nc * Q * Q * N, y_diag=2 * rows * nc * h * Q * Q * P,
                states=2 * rows * nc * Q * N * h * P, y_off=2 * rows * nc * Q * N * h * P,
                out_proj=2 * T * (di // parts["ssm_heads"]) * d)


def _query_rows(cfg: ArchConfig, S: int, n: int) -> int:
    """The queries one rank's full-sequence attention runs over ``n`` ranks
    of ``qkv``: all S where the q heads split, else its slice of them
    (``TensorParallel.query_rows``: S padded to a multiple of n)."""
    return S if head_split(cfg.n_heads, cfg.n_kv_heads, n)[0] else -(-S // n)


def _tiles(rows: int, q_heads: int, hd: int, Sq: int, Sk: int) -> int:
    """The product FLOPs of every (q, k) tile of the chunked attention of
    ``Sq`` queries over ``Sk`` keys (each padded to its chunk; masked tiles
    included)."""
    qc, kc = min(512, Sq), min(1024, Sk)
    return 4 * rows * q_heads * hd * (-(-Sq // qc) * qc) * (-(-Sk // kc) * kc)


def _attn_products(cfg: ArchConfig, rows: int, S: int, parts: dict[str, int]) -> dict:
    """One attention layer's forward product FLOPs on one rank over its rows'
    whole sequence: q on this rank's q heads (where they do not split,
    :func:`head_split`, every head of its query slice: :func:`_query_rows`),
    k and v on the kv heads they use over every position, every (q, k)
    tile of the chunked attention for its queries (masked tiles included),
    its rows of ``wo``."""
    d, hd = cfg.d_model, cfg.hd
    n = parts["qkv"]
    q_heads, kv_heads = _heads(cfg, n)
    Sq = _query_rows(cfg, S, n)
    return dict(qkv=2 * rows * d * hd * (Sq * q_heads + S * 2 * kv_heads),
                tiles=_tiles(rows, q_heads, hd, Sq, S),
                wo=2 * rows * S * (cfg.n_heads * hd // n) * d)


def _mlp_products(cfg: ArchConfig, rows: int, S: int, parts: dict[str, int]) -> dict:
    """One MLP's forward product FLOPs on this rank's columns over its rows'
    whole sequence: the gate and up projections (a GELU MLP's one ``w1``),
    then ``wd`` (``w2``); ``d_model`` split over ``parts["embed"]``."""
    T, ff, d = rows * S, cfg.d_ff // parts["ffn"], cfg.d_model // parts.get("embed", 1)
    n_in = 2 if cfg.mlp_style == "swiglu" else 1
    return dict(gate_up=n_in * 2 * T * d * ff, wd=2 * T * ff * d)


def _cross_products(cfg: ArchConfig, rows: int, S: int, parts: dict[str, int]) -> dict:
    """One cross-attention's forward product FLOPs on one rank: k and v of
    the kv heads this rank's q heads use over its rows' ``enc_seq`` frames,
    q on its q heads over its rows' whole sequence of S tokens (where they
    do not split, every head of its query slice), every (q, frame) tile of
    the chunked attention, its rows of ``wo``."""
    d, hd, T, n = cfg.d_model, cfg.hd, cfg.enc_seq, parts["qkv"]
    q_heads, kv_heads = _heads(cfg, n)
    Sq = _query_rows(cfg, S, n)
    return dict(kv=2 * 2 * rows * T * d * hd * kv_heads, q=2 * rows * Sq * d * hd * q_heads,
                tiles=_tiles(rows, q_heads, hd, Sq, T),
                wo=2 * rows * S * (cfg.n_heads * hd // n) * d)


def _encoder_products(cfg: ArchConfig, rows: int, parts: dict[str, int]) -> list[dict]:
    """The encoder-decoder's encoder, one block at a time, on one rank: the
    non-causal attention and the MLP over its rows' ``enc_seq`` frames."""
    one = [_attn_products(cfg, rows, cfg.enc_seq, parts),
           _mlp_products(cfg, rows, cfg.enc_seq, parts)]
    return [one] * cfg.enc_layers


def _layer_products(cfg: ArchConfig, mixer: str, channel: str, rows: int, S: int,
                    parts: dict[str, int]) -> list[dict]:
    """One layer of the pattern (``cfg.layer_pattern()``'s (mixer, channel)):
    its sequence mixer's products (an encoder-decoder's decoder block: its
    self-attention's, then its cross-attention's) and its channel mixer's,
    each in forward order."""
    out = [(_attn_products if mixer == "attn" else _ssm_products)(cfg, rows, S, parts)]
    if cfg.family == "encdec":
        out.append(_cross_products(cfg, rows, S, parts))
    if channel != "none":
        out.append((_mlp_products if channel == "mlp" else _moe_products)(cfg, rows, S, parts))
    return out


def hand_train_flops(cfg: ArchConfig, B: int, S: int, parts: dict[str, int]) -> int:
    """The product FLOPs one rank runs in a decoder's tensor-parallel train
    step under ``remat = "full"``, counted by hand from the widths (the
    dry-run's trace of the step must equal it).  ``parts`` gives the ranks
    each of ``batch``, ``seq``, ``qkv``, ``ffn`` and ``vocab`` splits over
    (1 where it does not split), with a MoE block ``experts`` and
    ``expert_ffn`` (:func:`_moe_products`), with an SSM block ``ssm_inner``
    and ``ssm_heads`` (:func:`_ssm_products`).  Each layer of the pattern
    runs on this rank's rows of the whole sequence and its columns: the
    attention's (:func:`_attn_products`) or the SSM block's products, then
    the MLP's (:func:`_mlp_products`) or the MoE block's; the unembedding on
    its columns of the vocabulary where that splits, else on the whole
    vocabulary for its own tokens.  4 times the forward (the forward, the
    recompute and the chunked loss's, and the backward's two products a
    product), but the MoE block's combine weights and dispatch, which
    differentiate one operand (3 times: no second backward product), and
    less each period's last product (a layer's ``wd``, a MoE block's
    combine einsum, an SSM block's ``out_proj``): the non-reentrant
    checkpoint of a period stops once the tensors the backward needs are
    back, and the period's last product saves none.  A period is one layer
    but in the hybrid, whose period is ``attn_every`` layers.  The
    encoder-decoder's decoder block adds its cross-attention
    (:func:`_cross_products`), and its encoder blocks (each checkpointed on
    its own) run at ``enc_seq`` frames (:func:`_encoder_products`)."""
    if cfg.remat != "full":
        raise ValueError(f"counted for remat 'full', not {cfg.remat!r}")
    d, V = cfg.d_model, cfg.vocab
    rows = B // parts["batch"]
    if parts["vocab"] > 1:
        loss = 2 * rows * S * d * (V // parts["vocab"])
    else:
        loss = 2 * rows * (S // parts["seq"]) * d * V
    period = 0
    for mixer, channel in cfg.layer_pattern():
        for m in _layer_products(cfg, mixer, channel, rows, S, parts):
            period += 4 * sum(m.values()) - m.get("route", 0) - m.get("dispatch", 0)
    period -= list(m.values())[-1]
    encoder = sum(4 * sum(sum(m.values()) for m in block) - block[-1]["wd"]
                  for block in (_encoder_products(cfg, rows, parts)
                                if cfg.family == "encdec" else ()))
    return cfg.n_layers // cfg.period * period + encoder + 4 * loss


def hand_prefill_flops(cfg: ArchConfig, B: int, S: int, parts: dict[str, int]) -> int:
    """The product FLOPs one rank runs in a decoder's sharded prefill of (B,
    S) tokens, counted by hand from the widths (the dry-run's trace must
    equal it).  ``parts`` gives the ranks each of ``batch``, ``seq``,
    ``qkv``, ``ffn``, ``vocab``, ``cache_batch`` and ``cache_seq`` splits
    over (with the MoE and SSM blocks' axes as :func:`hand_train_flops`).
    The train forward's products (:func:`_layer_products` a layer); where
    the q heads split and the kv heads do not, an attention layer's cache k
    and v projected on this rank's cache rows and sequence slice with every
    kv head (the encoder-decoder's cross cache too, over its ``cross_seq``
    slice of the frames); the encoder-decoder's encoder blocks; the last
    token's logits on this rank's rows and vocabulary columns."""
    d, hd = cfg.d_model, cfg.hd
    rows = B // parts["batch"]
    q_local, kv_local = head_split(cfg.n_heads, cfg.n_kv_heads, parts.get("qkv", 1))
    period = 0
    for mixer, channel in cfg.layer_pattern():
        period += sum(sum(m.values()) for m in _layer_products(cfg, mixer, channel, rows, S, parts))
        if mixer == "attn" and q_local and not kv_local:
            lengths = [S // parts["cache_seq"]]
            if cfg.family == "encdec":
                lengths.append(cfg.enc_seq // parts.get("cross_seq", 1))
            period += sum(2 * 2 * (B // parts["cache_batch"]) * n * d * cfg.n_kv_heads * hd
                          for n in lengths)
    encoder = sum(sum(m.values()) for block in (_encoder_products(cfg, rows, parts)
                                                if cfg.family == "encdec" else ())
                  for m in block)
    return cfg.n_layers // cfg.period * period + encoder \
        + 2 * rows * d * (cfg.vocab // parts["vocab"])


def hand_decode_flops(cfg: ArchConfig, B: int, S: int, parts: dict[str, int]) -> int:
    """The product FLOPs one rank runs in a decoder's sharded decode step of
    B tokens against a cache of S positions, counted by hand (the dry-run's
    trace must equal it; ``parts`` as :func:`hand_prefill_flops`, with
    ``parts["kv"]`` the ranks ``wk``'s columns split over where the kv heads
    do not split).  An attention layer: q, k and v on this rank's stream
    rows and its columns of ``wq``, ``wk`` and ``wv`` (whether or not their
    heads split); the scores and the weighted sum of v for every q
    head over this rank's cache rows and sequence slice (a sliding window's
    cache holds ``min(S, window)`` positions); its rows of ``wo``.  An SSM
    layer: ``in_proj`` on this rank's stream rows and stored columns, the
    conv (an einsum over the k positions) on every channel of its cache
    rows, the state's output C.h on its cache rows and heads, ``out_proj``
    on its stream rows and heads' rows.  The encoder-decoder's
    cross-attention: q and ``wo`` as the self-attention's, the scores and the
    weighted sum over this rank's cache rows and ``cross_seq`` slice of the
    frames.  Then its columns of the MLP, or the MoE block
    (:func:`_moe_products` of one-token groups); the logits on its rows and
    vocabulary columns: where ``parts["table"]`` > 1 (the plan's table
    axes) on every row of those ranks and this rank's columns of
    ``d_model`` over them, and on its chunk of ``ceil(V /
    parts["logits"])`` columns where the vocabulary does not split.  Where
    ``parts["embed"]`` > 1 (the plan's stationary axes) every product's
    ``d_model`` is split over them and the conv runs on this rank's
    channels of the history (``parts["conv"]``)."""
    e = parts.get("embed", 1)
    d, hd = cfg.d_model // e, cfg.hd
    rows = B // parts["batch"]
    period = 0
    for mixer, channel in cfg.layer_pattern():
        if mixer == "attn":
            n = parts["qkv"]
            kv_local = head_split(cfg.n_heads, cfg.n_kv_heads, n)[1]
            q_cols = cfg.n_heads * hd // n
            kv_cols = cfg.n_kv_heads * hd // (n if kv_local else parts["kv"])
            period += 2 * rows * d * (q_cols + 2 * kv_cols) \
                + 2 * rows * (cfg.n_heads * hd // n) * d \
                + 4 * (B // parts["cache_batch"]) * cfg.n_heads * hd \
                * ((min(S, cfg.window) if cfg.window else S) // parts["cache_seq"])
            if cfg.family == "encdec":
                period += 2 * rows * d * q_cols + 2 * rows * (cfg.n_heads * hd // n) * d \
                    + 4 * (B // parts["cache_batch"]) * cfg.n_heads * hd \
                    * (cfg.enc_seq // parts.get("cross_seq", 1))
        else:
            di, H, P, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            rc, h = B // parts["cache_batch"], H // parts["ssm_heads"]
            conv = parts.get("conv", 1) if e > 1 else 1
            period += 2 * rows * d * ((2 * di + 2 * N + H) // parts["ssm_inner"]) \
                + 2 * rc * cfg.ssm_conv * ((di + 2 * N) // conv) + 2 * rc * N * h * P \
                + 2 * rows * (di // parts["ssm_heads"]) * d
        if channel != "none":
            m = (_mlp_products if channel == "mlp" else _moe_products)(
                cfg, rows, 1, dict(parts, seq=1))
            period += sum(m.values())
    t = parts.get("table", 1)
    return cfg.n_layers // cfg.period * period \
        + 2 * rows * t * (d // t) * -(-cfg.vocab // parts.get("logits", parts["vocab"]))


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
    # the MoE family: the mesh axes its experts and their hidden columns split over
    expert_axes: tuple[str, ...] = ()
    expert_ffn_axes: tuple[str, ...] = ()
    # serving plans only: a k / v cache leaf's resolved spec, the mesh axes its
    # rows split over beyond the stream's, and those of its sequence
    cache_spec: tuple | None = None
    cache_row_axes: tuple[str, ...] = ()
    cache_seq_axes: tuple[str, ...] = ()
    # the SSM family: the mesh axes its heads split over (the decode cache's
    # ``ssm`` leaf's) and those of ``in_proj``'s stored ``ssm_inner`` columns;
    # serving plans: those of the conv history's channels
    ssm_head_axes: tuple[str, ...] = ()
    ssm_in_axes: tuple[str, ...] = ()
    cache_conv_axes: tuple[str, ...] | None = None
    # the encoder-decoder: the frames' resolved (batch, seq) spec (their own
    # stream); serving plans: the cross cache's resolved spec and the mesh
    # axes of its sequence (its rows split as the self cache's)
    enc_stream_spec: tuple | None = None
    cross_cache_spec: tuple | None = None
    cross_seq_axes: tuple[str, ...] = ()
    # the mesh axes wk / wv's columns split over (their ``qkv`` entry's)
    kv_axes: tuple[str, ...] = ()
    # decode plans only: the weights' embed axes the stream's rows leave
    # whole, over which every weight stays on its shard and the token moves,
    # and whether the SSM conv then runs on this rank's stored channels
    # (its weights' channels split as the conv history's)
    stationary_axes: tuple[str, ...] = ()
    conv_local: bool = False
    # where the q heads do not split: the mesh axes (the ``qkv`` axes) a
    # full-sequence attention splits its queries' sequence over (every head
    # of a query slice a rank, :meth:`query_rows`); () where the heads split
    q_slice_axes: tuple[str, ...] = ()
    # decode plans: the q / k / v weights keep their columns; and the mesh
    # axes that split both the stream's rows and the tables' embed columns,
    # over which the tables stay on their shards and the rows trade for
    # columns (``data`` for the rows of ``decode_32k`` under the baseline)
    decode: bool = False
    table_axes: tuple[str, ...] = ()

    @property
    def stream(self) -> Sharding:
        return Sharding(self.mesh, self.stream_spec)

    def parts(self, axes) -> int:
        sizes = mesh_axis_sizes(self.mesh)
        return math.prod(sizes[ax] for ax in axes)

    @property
    def encoder(self) -> "TensorParallel":
        """The plan the encoder's blocks run on: the frames' stream, this
        rank's rows and its slice of the frames' sequence (every frame
        where ``enc_seq`` does not divide the ``seq`` axes), and no cache."""
        sizes = mesh_axis_sizes(self.mesh)
        return dataclasses.replace(self, stream_spec=self.enc_stream_spec, seq_axes=tuple(
            ax for ax in _axes(self.enc_stream_spec[1]) if sizes[ax] > 1), cache_spec=None)

    @property
    def cross(self) -> "TensorParallel":
        """The plan with the cross cache's layout in the cache's place."""
        return dataclasses.replace(self, cache_spec=self.cross_cache_spec,
                                   cache_seq_axes=self.cross_seq_axes)

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

    def seq_start(self, n: int) -> int:
        """This rank's first position in a stream of ``n`` positions a rank
        (its sequence slice's offset)."""
        return chunk_of(n * self.parts(self.seq_axes), self.mesh, self.seq_axes).start

    def pad_seq(self, labels: torch.Tensor) -> torch.Tensor:
        """(B, S / parts) labels -> (B, S): this rank's at their positions,
        -1 (no label) elsewhere."""
        n = labels.shape[1] * self.parts(self.seq_axes)
        own = chunk_of(n, self.mesh, self.seq_axes)
        return F.pad(labels, (own.start, n - own.stop), value=-1)

    # ------------------------------------------------- stationary weights
    def embed_in(self, x: torch.Tensor, w: torch.Tensor, dim: int = 0,
                 product=torch.matmul) -> torch.Tensor:
        """``product(x, w)``, which contracts ``x``'s last dimension (the
        stream's whole ``d_model``) with ``w``'s dimension ``dim``.  Where
        ``w`` holds this rank's embed shard of it (a decode plan's
        :attr:`stationary_axes`), this rank's slice of ``x`` times the
        shard, the partial products summed over those axes."""
        D = x.shape[-1]
        if w.shape[dim] == D:
            return product(x, w)
        part = product(x[..., chunk_of(D, self.mesh, self.stationary_axes)], w)
        return sum_over(part, self.mesh, self.stationary_axes)

    def columns(self, y: torch.Tensor, axes: tuple[str, ...], n: int) -> torch.Tensor:
        """(..., n / parts) -> (..., n): a product's output on a weight's
        columns split over ``axes`` (an output on this rank's embed columns,
        summed as the stream needs it, over the :attr:`stationary_axes`),
        gathered; all ``n`` as it is."""
        return y if y.shape[-1] == n else gather_over(y, self.mesh, axes, -1)

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
        holds: all of ``ctx`` (its heads, or where they do not split the
        columns :meth:`query_cols` brought), its chunk where ``ctx`` holds
        every head (``all_heads``, as decode's does)."""
        if not all_heads:
            return ctx
        return ctx[..., chunk_of(ctx.shape[-1], self.mesh, self.qkv_axes)]

    # ------------------------------------------------------ query slices
    def _query_len(self, n: int) -> int:
        """A sequence of ``n`` positions padded to a multiple of the
        :attr:`q_slice_axes`' ranks."""
        parts = self.parts(self.q_slice_axes)
        return -(-n // parts) * parts

    def query_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(B, S, ...) over the whole sequence -> this rank's query slice,
        (B, ceil(S / parts), ...) over the :attr:`q_slice_axes` (the last
        slice padded with zeros past S); all of ``t`` where the heads
        split."""
        if not self.q_slice_axes:
            return t
        pad = self._query_len(t.shape[1]) - t.shape[1]
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t[:, chunk_of(t.shape[1], self.mesh, self.q_slice_axes)]

    def query_start(self, n: int) -> int:
        """The position of this rank's first query in a sequence of ``n``."""
        if not self.q_slice_axes:
            return 0
        return chunk_of(self._query_len(n), self.mesh, self.q_slice_axes).start

    def query_cols(self, ctx: torch.Tensor, n: int) -> torch.Tensor:
        """(B, ceil(n / parts), Hq·hd), every head of this rank's query slice
        -> (B, n, Hq·hd / parts), its chunk of the columns (the rows of
        ``wo`` it holds) over the whole sequence: an all-to-all over the
        :attr:`q_slice_axes` (its backward the inverse all-to-all), the
        padding dropped; ``ctx`` as it is where the heads split."""
        if not self.q_slice_axes:
            return ctx
        return all_to_all_over(ctx, self.mesh, self.q_slice_axes, 2, 1)[:, :n]

    def all_heads(self, t: torch.Tensor, split: bool) -> torch.Tensor:
        """(B, S, heads, hd) -> every head: gathered over the ``qkv`` axes
        where this rank holds a ``split`` share of them."""
        return gather_over(t, self.mesh, self.qkv_axes, 2) if split else t

    @property
    def heads_traded(self) -> bool:
        """Whether collectives over the ``qkv`` axes lay this rank's kv heads
        out as its cache shard: the axes are the cache sequence's, or each
        splits the cache's sequence or, beyond the stream's, its rows, at
        most one axis each, or neither (the cache is whole over it), and the
        cache splits over nothing else."""
        if self.qkv_axes == self.cache_seq_axes:
            return True
        rows, seq = set(self.cache_row_axes), set(self.cache_seq_axes)
        return rows | seq <= set(self.qkv_axes) and len(rows) <= 1 and len(seq) <= 1

    def heads_to_cache(self, t: torch.Tensor) -> torch.Tensor:
        """(B, S, heads / n, hd), this rank's kv heads over its stream rows'
        whole sequence -> its cache shard, every kv head over the cache's
        rows and sequence slice: an all-to-all over the ``qkv`` axes,
        trading heads for the cache's sequence where those are its axes too
        (``moe_ep``'s (expert, tp)), else a collective over each ``qkv``
        axis, the minor one first: an all-to-all trading heads for the
        cache's rows or its sequence where the axis splits them, an
        all-gather of the heads where the cache is whole over it (``serve``'s
        ``data`` where the rows do not divide it) (:attr:`heads_traded`,
        which :func:`plan_prefill` checks)."""
        if self.qkv_axes == self.cache_seq_axes:
            return all_to_all_over(t, self.mesh, self.qkv_axes, 1, 2)
        for ax in reversed(self.qkv_axes):
            if ax in self.cache_row_axes or ax in self.cache_seq_axes:
                t = all_to_all_over(t, self.mesh, (ax,), 0 if ax in self.cache_row_axes else 1, 2)
            else:
                t = gather_over(t, self.mesh, (ax,), 2)
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

    # ------------------------------------------------------------- tables
    def table_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's rows of (B, 1) token ids -> every row of the
        :attr:`table_axes` (gathered over them, in chunk order)."""
        return gather_over(tokens, self.mesh, self.table_axes, 0)

    def table_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(rows of the table axes, 1, D / parts), this rank's embed columns
        of every row -> (this rank's rows, 1, D): one all-to-all over the
        :attr:`table_axes`; ``x`` as it is without them."""
        return all_to_all_over(x, self.mesh, self.table_axes, 0, -1)

    def table_cols(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`table_rows`' inverse: (this rank's rows, 1, D) -> every
        row of the :attr:`table_axes` on this rank's embed columns."""
        return all_to_all_over(x, self.mesh, self.table_axes, 0, -1, reverse=True)

    def logit_rows(self, y: torch.Tensor) -> torch.Tensor:
        """Every row's partial logits over the :attr:`table_axes` -> this
        rank's rows of their sum (a reduce-scatter)."""
        return scatter_over(y, self.mesh, self.table_axes, 0)

    @property
    def logit_axes(self) -> tuple[str, ...]:
        """The mesh axes the logits' columns split over: the vocabulary's;
        where it does not split and the tables trade rows for columns
        (:attr:`table_axes`), every other axis of more than one rank that
        the rows leave whole (each such rank computes a ``torch.chunk``-
        style slice of the vocabulary: :meth:`logit_cols`); else none."""
        if self.vocab_axes or not self.table_axes:
            return self.vocab_axes
        return tuple(ax for ax in self.mesh_axes if ax not in self.batch_axes)

    def logit_cols(self, n_vocab: int) -> slice:
        """This rank's columns of ``n_vocab`` logits: its ``vocab`` shard,
        or where the vocabulary does not split, its ``DTensor`` chunk over
        the :attr:`logit_axes` (ceil-sized, the last ones shorter or empty;
        each mesh axis in order splits the chunk of the one before it)."""
        if self.vocab_axes:
            return self.vocab_rows(n_vocab)
        start, size = 0, n_vocab
        for ax in self.logit_axes:
            n = self.parts((ax,))
            c = -(-size // n)
            first = min(chunk_of(n, self.mesh, (ax,)).start * c, size)
            start, size = start + first, min(c, size - first)
        return slice(start, start + size)

    def logits_spec(self) -> tuple:
        """The spec of the (B, 1, V) logits the serving steps return: the
        stream's rows, and the :attr:`logit_axes`' columns (uneven where the
        vocabulary does not divide them)."""
        return (spec_entry(self.batch_axes), None, spec_entry(self.logit_axes))

    def next_tokens(self, logits: torch.Tensor, n_vocab: int) -> torch.Tensor:
        """(rows, 1, this rank's :meth:`logit_cols`) logits -> the greedy
        token of every row of the batch, (B,) int32 on every rank: each
        rank's maximum and first index over its columns, the maximum over
        the :attr:`logit_axes` (a NaN above everything), the least global
        index that reaches it (``torch.argmax`` of the whole logits, ties
        and NaN included), gathered over the batch axes."""
        z = logits[:, -1]
        i = torch.argmax(z, dim=-1)
        v = z.gather(-1, i[:, None])[:, 0]
        nan = torch.isnan(v)
        top = max_over(torch.stack([nan.to(v.dtype), torch.where(nan, math.inf, v)], -1),
                       self.mesh, self.logit_axes)
        mine = torch.where(top[:, 0] > 0, nan, v == top[:, 1])
        best = -max_over(-torch.where(mine, self.logit_cols(n_vocab).start + i, n_vocab),
                         self.mesh, self.logit_axes)
        return gather_over(best.to(torch.int32), self.mesh, self.batch_axes, 0)

    # -------------------------------------------------------------- vocab
    def vocab_rows(self, n_vocab: int) -> slice:
        return chunk_of(n_vocab, self.mesh, self.vocab_axes)

    def vocab_sum(self, x: torch.Tensor) -> torch.Tensor:
        return sum_over(x, self.mesh, self.vocab_axes)

    def vocab_max(self, x: torch.Tensor) -> torch.Tensor:
        return max_over(x, self.mesh, self.vocab_axes)

    # ------------------------------------------------------------ experts
    @property
    def experts_traded(self) -> tuple[str, ...]:
        """The expert axes that split the stream's sequence: the dispatched
        tokens cross them by an all-to-all, each rank's groups for each
        rank's experts."""
        return self.expert_axes if set(self.expert_axes) <= set(self.seq_axes) else ()

    @property
    def experts_local(self) -> tuple[str, ...]:
        """The expert axes whose ranks hold the same tokens (decode's one
        token a row, a batch the sequence does not split): each rank runs
        its experts on them and the outputs are summed there."""
        return () if self.experts_traded else self.expert_axes

    @property
    def expert_ffn_traded(self) -> tuple[str, ...]:
        """The axes of the experts' hidden columns that split the sequence:
        with experts apart, the dispatched tokens are gathered over them
        and the down projection's partial sums reduce-scattered back; with
        every expert on every rank, the weights are gathered over them."""
        return tuple(ax for ax in self.expert_ffn_axes if ax in self.seq_axes)

    @property
    def expert_ffn_local(self) -> tuple[str, ...]:
        """The axes of the experts' hidden columns whose ranks hold the same
        tokens: column-parallel there, the outputs summed over them."""
        return tuple(ax for ax in self.expert_ffn_axes if ax not in self.seq_axes)

    def group_before(self, counts: torch.Tensor, share: int) -> torch.Tensor:
        """(B, 1, ..., E) counts of this rank's share of a token group that
        spans ``share`` consecutive ranks of the sequence -> the sum of the
        group's earlier ranks' counts (zero on its first rank): the
        exclusive prefix a rank's capacity positions start from."""
        every = gather_over(counts, self.mesh, self.seq_axes, 1)
        i = chunk_of(self.parts(self.seq_axes), self.mesh, self.seq_axes).start
        return every[:, i // share * share:i].sum(1, keepdim=True)

    def group_sums(self, x: torch.Tensor, share: int) -> torch.Tensor:
        """(B, 1, E) sums over this rank's share of a group that spans
        ``share`` ranks of the sequence -> (B, groups, E), each of this
        rank's rows' groups summed over its ranks."""
        return gather_over(x, self.mesh, self.seq_axes, 1).unflatten(1, (-1, share)).sum(2)

    def dispatched(self, xe: torch.Tensor) -> torch.Tensor:
        """(B, E, groups, C, D), this rank's groups dispatched to every
        expert -> this rank's experts' slots: an all-to-all over the traded
        expert axes (the groups of every rank there), then gathered over the
        traded axes of the experts' hidden columns."""
        xe = all_to_all_over(xe, self.mesh, self.experts_traded, 1, 2)
        return gather_over(xe, self.mesh, self.expert_ffn_traded, 2) if self.expert_axes else xe

    def returned(self, ye: torch.Tensor) -> torch.Tensor:
        """:meth:`dispatched`'s reverse for the experts' outputs: the down
        projection's partial sums reduce-scattered over the traded hidden
        axes, then the reverse all-to-all."""
        if self.expert_axes:
            ye = scatter_over(ye, self.mesh, self.expert_ffn_traded, 2)
        return all_to_all_over(ye, self.mesh, self.experts_traded, 1, 2, reverse=True)

    def expert_weight(self, w: torch.Tensor, ffn_dim: int) -> torch.Tensor:
        """An expert weight as the products use it: as it is with experts
        apart, or (every expert on every rank) gathered over the traded
        axes of its hidden columns (dimension ``ffn_dim``)."""
        if self.expert_axes:
            return w
        return gather_over(w, self.mesh, self.expert_ffn_traded, ffn_dim)

    def expert_sum(self, y: torch.Tensor) -> torch.Tensor:
        """The MoE output summed over the ranks that hold the same tokens
        and split the experts or their hidden columns."""
        return sum_over(y, self.mesh, self.experts_local + self.expert_ffn_local)

    # ---------------------------------------------------------------- ssm
    def ssm_heads(self, n: int) -> slice:
        """This rank's share of ``n`` elements split as the SSM heads are:
        its heads, or their channels."""
        return chunk_of(n, self.mesh, self.ssm_head_axes)

    def ssm_columns(self, zxbcdt: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
        """(..., C / parts) ``in_proj`` output on its stored columns -> (...,
        this rank's heads' z | x, B, C | dt channels) (:func:`ssm_runs`).
        Where the heads split over one axis, the major one of the columns'
        split, the columns are gathered over the split's other axes, then
        each rank sends every other the runs of its columns that the
        other's heads use (an exchange of uneven runs over the head axis:
        the bytes the heads need, B and C to every rank); elsewhere every
        column is gathered and the runs are sliced.  Differentiable: the
        exchange's backward returns each gradient to the rank that computed
        the column."""
        heads = self.ssm_head_axes
        traded = heads if len(heads) == 1 and self.ssm_in_axes[:1] == heads else ()
        x = gather_over(zxbcdt, self.mesh, self.ssm_in_axes[len(traded):], -1)
        n = self.parts(self.ssm_head_axes)
        me = chunk_of(n, self.mesh, self.ssm_head_axes).start
        if not traded:
            return torch.cat([x[..., a:b] for a, b in ssm_runs(cfg, n, me)], -1)
        c = x.shape[-1]
        lo = me * c
        send, pieces = [], []
        for j in range(n):
            k = 0
            for a, b in ssm_runs(cfg, n, j):
                a, b = max(a, lo), min(b, lo + c)
                if a < b:
                    pieces.append(x[..., a - lo:b - lo])
                    k += b - a
            send.append(k)
        recv = [sum(max(0, min(b, (i + 1) * c) - max(a, i * c)) for a, b in ssm_runs(cfg, n, me))
                for i in range(n)]
        return trade_over(torch.cat(pieces, -1) if pieces else x[..., :0], self.mesh, traded[0],
                          send, recv, -1)

    def ssm_whole_columns(self, zxbcdt: torch.Tensor) -> torch.Tensor:
        """``in_proj``'s output on its stored columns -> every column,
        gathered over the axes of their split (decode's one-token row)."""
        return gather_over(zxbcdt, self.mesh, self.ssm_in_axes, -1)

    def ssm_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A per-head partial (the gated norm's sum of squares, ``out_proj``'s
        partial sums) summed over the head axes."""
        return sum_over(x, self.mesh, self.ssm_head_axes)

    def ssm_all_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(..., this rank's heads' channels) -> every head's, gathered over
        the head axes."""
        return gather_over(x, self.mesh, self.ssm_head_axes, -1)

    def conv_rows(self, conv: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a conv history (..., channels / parts) ->
        every channel, gathered over the axes that split them."""
        return gather_over(conv, self.mesh, self.cache_conv_axes, -1)

    def conv_shard(self, conv: torch.Tensor) -> torch.Tensor:
        """A conv history over every channel -> this rank's stored shard."""
        return conv[..., chunk_of(conv.shape[-1], self.mesh, self.cache_conv_axes)]

    # ------------------------------------------------------------ weights
    def working_shardings(self, spec_tree):
        """Per parameter leaf, the layout the step computes with: its spec
        without the FSDP axes, or replicated for a ``wq`` / ``wk`` / ``wv``
        whose heads do not split and for a MoE router.  An expert weight
        keeps its ``experts`` and ``ffn`` shards (:meth:`expert_weight`
        gathers the traded hidden columns in the layer where every expert
        is on every rank).  The SSM block's ``conv_w`` and ``conv_b`` are
        whole; its ``norm`` and ``out_proj`` keep this rank's heads' rows
        (their ``ssm_inner`` split cut to the head axes, its major ones).
        On a plan with :attr:`stationary_axes` every leaf keeps them on its
        embed entries and nothing is whole: the q / k / v weights and the
        router keep their columns, ``conv_w`` and ``conv_b`` their channels
        where the conv history's shard holds the same ones
        (:attr:`conv_local`).  On any decode plan the q / k / v weights keep
        their columns, and the tables their embed shards over the
        :attr:`table_axes`."""
        sizes = mesh_axis_sizes(self.mesh)

        def work(path, p):
            name = path.rsplit("/", 1)[-1]
            spec = resolve_spec(p.shape, p.logical, sizes)
            conv = "ssm_inner" in p.logical and name in ("conv_w", "conv_b")
            if self.stationary_axes:
                whole = conv and not self.conv_local
            else:
                whole = (not self.decode and ((name == "wq" and not self.q_local) or (
                    name in ("wk", "wv") and not self.kv_local))) or name == "router" or conv
            kept = self.stationary_axes + (self.table_axes if path in TABLES else ())
            heads = "ssm_inner" in p.logical and name in ("norm", "out_proj")
            return Sharding(self.mesh, tuple(
                None if whole else
                spec_entry(tuple(ax for ax in _axes(entry) if ax in kept))
                if lname in FSDP_LOGICAL else
                spec_entry(self.ssm_head_axes) if heads and lname == "ssm_inner" else entry
                for entry, lname in zip(spec, p.logical)))
        return tree_map_pspec(work, spec_tree)

    def layouts(self, spec_tree) -> list:
        """Each leaf's (resolved spec, working spec), in sorted leaf order."""
        sizes = mesh_axis_sizes(self.mesh)
        specs = tree_map_pspec(lambda _, p: Sharding(self.mesh, resolve_spec(
            p.shape, p.logical, sizes)), spec_tree)
        return [(sh.spec, work.spec) for sh, work in
                zip(sorted_leaves(specs), sorted_leaves(self.working_shardings(spec_tree)))]

    def _moved(self, spec, work_spec) -> list[tuple[int, tuple[str, ...]]]:
        """Each dimension of a leaf laid out by ``spec`` and the axes of its
        split that ``work_spec`` drops (its minor ones), in the order they
        are gathered: mesh axis by mesh axis from the last, as ``DTensor``
        orders them."""
        order = list(reversed(self.mesh_axes))
        moved = {d: tuple(ax for ax in _axes(e) if ax in order and ax not in _axes(w))
                 for d, (e, w) in enumerate(zip(spec, work_spec))}
        return sorted(((d, axes) for d, axes in moved.items() if axes),
                      key=lambda kv: min(order.index(a) for a in kv[1]))

    def gather_leaf(self, x: torch.Tensor, spec, work_spec,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
        """This rank's shard ``x`` of a leaf laid out by ``spec`` -> its
        working shard (``work_spec``): gathered over the axes the working
        layout drops (``gather_over``: staged through the host on a gloo
        group, as ``DTensor``'s own collectives are not), cast to ``dtype``
        first where it moves."""
        moved = self._moved(spec, work_spec)
        if moved and dtype is not None:
            x = x.to(dtype)
        for d, axes in moved:
            x = gather_over(x, self.mesh, axes, d)
        return x

    def reduce_leaf(self, g: torch.Tensor, spec, work_spec, dtype: torch.dtype) -> torch.Tensor:
        """:meth:`gather_leaf`'s adjoint: a working gradient in ``dtype``
        (its parameter's type), summed over the mesh axes ``work_spec``
        does not split (each rank's part of the loss reaches the leaf
        there) into the layout of ``spec``: a reduce-scatter over each such
        axis that splits the parameter (in the spec's order, a tuple's major
        axis first), then an all-reduce over each other one, in mesh
        order."""
        g = g.to(dtype)
        used = {ax for entry in work_spec for ax in _axes(entry)}
        summed = [ax for ax in self.mesh_axes if ax not in used]
        for d, entry in enumerate(spec):
            g = scatter_over(g, self.mesh, tuple(ax for ax in _axes(entry) if ax in summed), d)
        split = {ax for entry in spec for ax in _axes(entry)}
        return sum_over(g, self.mesh, tuple(ax for ax in summed if ax not in split))

    def working(self, params, layouts, dtype: torch.dtype | None = None,
                cast: list[bool] | None = None) -> dict:
        """This rank's working shard of every parameter (``DTensor``s) in
        ``layouts`` (:meth:`layouts` of their specs), gathered now, outside
        autograd (:meth:`gather_leaf`): a tree like ``params``.  With
        ``dtype`` (the compute type) a leaf that moves is cast before it
        travels, every such leaf where ``cast`` (sorted leaf order) is None,
        else those it marks (the train step's expert weights,
        :func:`expert_leaves`); every leaf cast so is a product's weight,
        cast to the compute type at its use (the embedding table at its
        look-up, but serving only), so the values computed, and the
        gradients, are the same.  The steps gather so only the leaves
        outside the stacked blocks (:meth:`weights`)."""
        cast = cast or [True] * len(layouts)
        with torch.no_grad():
            work = iter([self.gather_leaf(local_value(p), *lay, dtype if c else None)
                         for p, lay, c in zip(sorted_leaves(params), layouts, cast)])
        return tree_map_sorted(lambda _: next(work), params)

    def reduce_grads(self, grads, params, layouts) -> list:
        """Each working gradient (sorted leaf order) in its parameter's type,
        summed into its parameter's layout (:meth:`reduce_leaf`);
        ``DTensor``s.  A list of gradients is emptied as it goes, so each
        working gradient (and its copy in the parameter's type) is released
        once reduced."""
        out = []
        for i, ((spec, work_spec), p) in enumerate(zip(layouts, sorted_leaves(params))):
            g = grads[i]
            if isinstance(grads, list):
                grads[i] = None
            g = self.reduce_leaf(g, spec, work_spec, p.dtype)
            out.append(DTensor.from_local(g, self.mesh, p.placements, run_check=False,
                                          shape=p.shape, stride=p.stride()))
            del g
        return out

    def gather_period(self, tree, layouts, dtype: torch.dtype | None = None,
                      cast: list[bool] | None = None) -> dict:
        """One period's working weights from this rank's shards ``tree``
        (tensors laid out by ``layouts``, a period's (spec, working spec)
        in sorted leaf order), gathered by one :class:`_PeriodGather`, whose
        backward sums each gradient into its shard's layout: a tree like
        ``tree``.  ``dtype`` and ``cast`` as :meth:`working`."""
        cast = cast or [True] * len(layouts)
        out = iter(_PeriodGather.apply(self, tuple(layouts),
                                       tuple(dtype if c else None for c in cast),
                                       *sorted_leaves(tree)))
        return tree_map_sorted(lambda _: next(out), tree)

    def weights(self, params, layouts, dtype: torch.dtype | None = None,
                cast: list[bool] | None = None) -> dict:
        """``params`` (``DTensor``s; ``layouts`` and ``cast`` in sorted leaf
        order) as the layers take them on this plan: each leaf outside the
        stacked blocks gathered now (:meth:`working`: the embedding and
        unembedding tables, the final norms), each stacked tree
        (:data:`STACKED`) a :class:`StackedWeights` that gathers a period
        where the period runs, as the reference's scan step does.  The train
        step differentiates :func:`grad_leaves` and lays the gradients out
        by :meth:`weight_grads`."""
        cast = cast or [True] * len(layouts)
        lays, casts = _by_key(params, layouts), _by_key(params, cast)
        return {k: StackedWeights(self, params[k], lays[k], dtype, casts[k])
                if k in STACKED else self.working(params[k], lays[k], dtype, casts[k])
                for k in sorted(params)}

    def weight_grads(self, stacks: dict, grads: list, params, layouts) -> list:
        """The gradients of :func:`grad_leaves` of a :meth:`weights` tree,
        whose stacked trees are ``stacks`` -> each parameter's, laid out as
        it is (``DTensor``s, sorted leaf order): a leaf outside the stacked
        blocks summed here (:meth:`reduce_grads`), a stacked leaf's periods,
        already summed in the backward, stacked.  ``grads`` is emptied as it
        goes."""
        lays = _by_key(params, layouts)
        out, i = [], 0
        for k in sorted(params):
            n = len(stacks[k].leaves()) if k in STACKED else len(lays[k])
            part, grads[i:i + n] = grads[i:i + n], [None] * n
            i += n
            out += stacks[k].stacked_grads(part) if k in STACKED \
                else self.reduce_grads(part, params[k], lays[k])
        return out

    @property
    def mesh_axes(self) -> tuple[str, ...]:
        """The mesh axes of more than one rank (an axis of one moves
        nothing)."""
        return tuple(ax for ax, n in mesh_axis_sizes(self.mesh).items() if n > 1)


#: the top-level keys of a parameter tree whose leaves are stacked over
#: periods (the reference's scanned blocks)
STACKED = ("blocks", "enc_blocks", "dec_blocks")
#: the paths of the (un)embedding tables
TABLES = ("/embed", "/unembed")


def _by_key(params, seq) -> dict:
    """``seq`` (one entry a leaf of ``params``, sorted leaf order) cut into
    each top-level key's run."""
    out, i = {}, 0
    for k in sorted(params):
        n = len(sorted_leaves(params[k]))
        out[k], i = list(seq[i:i + n]), i + n
    return out


class _PeriodGather(torch.autograd.Function):
    """One period's working weights from this rank's shards: forward, each
    leaf in sorted leaf order cast where it travels in the compute type and
    gathered axis by axis (:meth:`TensorParallel.gather_leaf`); backward,
    the exact adjoint, leaf by leaf in the same order: each gradient in its
    shard's type summed into the shard's layout
    (:meth:`TensorParallel.reduce_leaf`).  One function a period, so every
    rank issues the period's collectives in one order (autograd does not
    order the backward of separate leaves)."""

    @staticmethod
    def forward(ctx, tp, layouts, dtypes, *shards):
        ctx.tp, ctx.layouts = tp, layouts
        ctx.types = tuple(s.dtype for s in shards)
        return tuple(tp.gather_leaf(s, spec, work, dt)
                     for s, (spec, work), dt in zip(shards, layouts, dtypes))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(
            ctx.tp.reduce_leaf(g, spec, work, dt)
            for g, (spec, work), dt in zip(grads, ctx.layouts, ctx.types))


class StackedWeights:
    """A stacked block tree's weights on a plan, as the layers take them:
    this rank's shard of each leaf, split into periods once (views, so each
    period's gradient is a shard-sized tensor of its own), and gathered a
    period at a time where the period runs (:meth:`period`; inside a
    checkpointed period, so the recompute gathers it again, as the
    reference's ``jax.checkpoint`` of its scan body does)."""

    def __init__(self, tp: TensorParallel, tree, layouts, dtype: torch.dtype | None,
                 cast: list[bool]) -> None:
        self.tp, self.tree, self.dtype, self.cast = tp, tree, dtype, cast
        # a period's leaf drops the stacking dimension ("layers": never split)
        self.layouts = [(spec[1:], work[1:]) for spec, work in layouts]
        self.periods = [tree_map_sorted(lambda p, i=i: local_value(p)[i].detach(), tree)
                        for i in range(sorted_leaves(tree)[0].shape[0])]

    def period(self, i: int) -> dict:
        """Period ``i``'s working weights, gathered now
        (:meth:`TensorParallel.gather_period`)."""
        return self.tp.gather_period(self.periods[i], self.layouts, self.dtype, self.cast)

    def leaves(self) -> list[torch.Tensor]:
        """Every period's shards, period by period, each in sorted leaf
        order."""
        return [x for tree in self.periods for x in sorted_leaves(tree)]

    def stacked_grads(self, grads: list) -> list:
        """The gradients of :meth:`leaves` -> each leaf's, its periods
        stacked, laid out as its parameter (``DTensor``s, sorted leaf
        order); ``grads`` is emptied leaf by leaf."""
        k, n = len(self.layouts), len(self.periods)
        out = []
        for j, p in enumerate(sorted_leaves(self.tree)):
            parts = [grads[i * k + j] for i in range(n)]
            for i in range(n):
                grads[i * k + j] = None
            g = torch.stack(parts) if n > 1 else parts[0].unsqueeze(0)
            del parts
            out.append(DTensor.from_local(g, self.tp.mesh, p.placements, run_check=False,
                                          shape=p.shape, stride=p.stride()))
        return out


def grad_leaves(work) -> list[torch.Tensor]:
    """The tensors a planned train step differentiates in ``work``
    (:meth:`TensorParallel.weights`), in sorted key order: each working leaf
    outside the stacked blocks, each stacked tree's periods' shards."""
    out = []
    for k in sorted(work):
        w = work[k]
        out += w.leaves() if isinstance(w, StackedWeights) else sorted_leaves(w)
    return out


def _is_expert_weight(p) -> bool:
    """A MoE block's ``wg``, ``wu`` or ``wd``: its experts' hidden columns."""
    return "experts" in p.logical and "ffn" in p.logical


def expert_leaves(spec_tree) -> list[bool]:
    """Whether each leaf (sorted order) is an expert weight: the train
    step's working copy casts these to the compute type before they travel
    (:meth:`TensorParallel.working`)."""
    return sorted_leaves(tree_map_pspec(lambda _, p: _is_expert_weight(p), spec_tree))


def weight_leaves(spec_tree) -> list[bool]:
    """Whether each leaf (sorted order) may travel in the compute type in
    the serving steps' working copy: every leaf but the SSM block's
    gated-norm scale, which multiplies a float32 value (the others are cast
    to the compute type at their use)."""
    return sorted_leaves(tree_map_pspec(
        lambda path, p: not ("ssm_inner" in p.logical and path.rsplit("/", 1)[-1] == "norm"),
        spec_tree))


def _live(entry, sizes) -> tuple[str, ...]:
    return tuple(ax for ax in _axes(entry) if sizes[ax] > 1)


def _cache_layout(cache_specs, sizes) -> dict[str, set]:
    """The resolved layouts of a decode cache's leaves, by kind: the k / v
    leaves' specs (an encoder-decoder's ``cross`` entry's apart, by its
    path), and the live mesh axes of every leaf's rows, of the SSM state's
    heads and of the conv history's channels."""
    out: dict[str, set] = {"kv": set(), "cross": set(), "rows": set(), "heads": set(),
                           "conv": set()}

    def note(path, p):
        spec = resolve_spec(p.shape, p.logical, sizes)
        out["rows"].add(_live(spec[1], sizes))
        if p.logical[2] == "cache_seq":
            out["cross" if path.split("/")[1] == "cross" else "kv"].add(spec)
        elif p.logical[2] == "ssm_inner":
            out["heads"].add(_live(spec[2], sizes))
        else:
            out["conv"].add(_live(spec[3], sizes))
    tree_map_pspec(note, cache_specs)
    return out


def _ssm_head_axes(cache_specs, sizes) -> tuple[str, ...]:
    heads = _cache_layout(cache_specs, sizes)["heads"]
    if len(heads) > 1:
        raise ValueError(f"the cache's ssm leaves split their heads as {sorted(heads)}")
    return next(iter(heads), ())


def tensor_parallel(cfg: ArchConfig, spec_tree, mesh: DeviceMesh, stream_spec,
                    ssm_head_axes: tuple[str, ...] = (),
                    enc_stream_spec: tuple | None = None) -> TensorParallel:
    """The plan of ``cfg``'s step on ``mesh`` under the active profile:
    ``stream_spec`` is the labels' resolved spec (batch entry, seq entry),
    ``enc_stream_spec`` an encoder-decoder's frames' (B rows, as the
    stream's),
    the weights' axes come from ``spec_tree``'s resolved specs (axes of one
    rank left out): ``experts`` from a MoE block's router and expert
    weights, and their ``ffn`` apart from a dense MLP's; ``ssm_head_axes``
    are the decode cache's (:func:`_ssm_head_axes`).  Raises ValueError
    where two leaves split one logical axis differently (``wk`` and ``wv``
    count only where their heads split; an SSM leaf's ``ssm_inner`` is held
    to the heads instead: ``norm`` and ``out_proj`` must split their rows
    over the head axes first), a weight's split or the SSM heads' meets the
    batch's axes (its ranks would hold other rows), the experts' axes split
    the sequence in part, or, with every expert on every rank, the hidden
    columns' axes that split the sequence are not the minor ones (the
    layer gathers those)."""
    sizes = mesh_axis_sizes(mesh)

    def live(axes):
        return tuple(ax for ax in axes if sizes[ax] > 1)
    found: dict[str, set] = {"qkv": set(), "kv": set(), "ffn": set(), "vocab": set(),
                             "experts": set(), "expert_ffn": set(), "ssm_in": set()}
    ssm_rows: set = set()

    def note(path, p):
        name = path.rsplit("/", 1)[-1]
        kv = name in ("wk", "wv")
        expert = _is_expert_weight(p)
        for entry, lname in zip(resolve_spec(p.shape, p.logical, sizes), p.logical):
            if lname == "ssm_inner" and name == "in_proj":
                found["ssm_in"].add(live(_axes(entry)))
            elif lname == "ssm_inner" and name in ("norm", "out_proj"):
                ssm_rows.add(live(_axes(entry)))
            if lname in found:
                if kv and lname == "qkv":
                    lname = "kv"
                elif expert and lname == "ffn":
                    lname = "expert_ffn"
                found[lname].add(live(_axes(entry)))
    tree_map_pspec(note, spec_tree)
    batch_axes, seq_axes = (live(_axes(e)) for e in stream_spec)
    axes = {}
    for lname in ("qkv", "kv", "ffn", "vocab", "experts", "expert_ffn", "ssm_in"):
        if len(found[lname]) > 1:
            raise ValueError(f"the leaves split {lname!r} as {sorted(found[lname])}")
        axes[lname] = next(iter(found[lname]), ())
        if set(axes[lname]) & set(batch_axes):
            raise ValueError(f"{lname!r} on {axes[lname]} meets the batch's {batch_axes}")
    heads = live(ssm_head_axes)
    if set(heads) & set(batch_axes):
        raise ValueError(f"the SSM heads on {heads} meet the batch's {batch_axes}")
    for rows in ssm_rows:
        if rows[:len(heads)] != heads:
            raise ValueError(f"the SSM's norm / out_proj split on {rows}, not first over the "
                             f"heads' {heads}")
    q_local, kv_local = head_split(cfg.n_heads, cfg.n_kv_heads,
                                   math.prod(sizes[ax] for ax in axes["qkv"]))
    if kv_local and found["kv"] - {axes["qkv"]}:
        raise ValueError(f"wk / wv split as {sorted(found['kv'])}, wq as {axes['qkv']}")
    tp = TensorParallel(mesh, batch_axes, seq_axes, axes["qkv"], axes["ffn"], axes["vocab"],
                        q_local, kv_local, tuple(stream_spec), axes["experts"],
                        axes["expert_ffn"], ssm_head_axes=heads, ssm_in_axes=axes["ssm_in"],
                        enc_stream_spec=None if enc_stream_spec is None
                        else tuple(enc_stream_spec), kv_axes=axes["kv"],
                        q_slice_axes=() if q_local else axes["qkv"])
    if set(tp.expert_axes) & set(seq_axes) and not tp.experts_traded:
        raise ValueError(f"experts on {tp.expert_axes} split the sequence's {seq_axes} in part")
    traded = tp.expert_ffn_traded
    if not tp.expert_axes and traded and tp.expert_ffn_axes[-len(traded):] != traded:
        raise ValueError(f"the experts' hidden columns on {tp.expert_ffn_axes} split the "
                         f"sequence over {traded}, not their minor axes")
    return tp


def _frames(cfg: ArchConfig, B: int, sizes) -> tuple | None:
    """An encoder-decoder's frames' resolved (``batch``, ``seq``) spec for B
    rows of ``enc_seq`` frames; None for a decoder."""
    if cfg.family != "encdec":
        return None
    return resolve_spec((B, cfg.enc_seq), ("batch", "seq"), sizes)


def _serving_cache(cfg: ArchConfig, B: int, S: int) -> dict:
    """The PSpecs of a prefill's cache of (B, S) (every position)."""
    if cfg.family == "encdec":
        return encdec.cache_specs(cfg, B, S)
    return cache_specs(cfg, B, S, ring=False)


def plan_train(cfg: ArchConfig, spec_tree, mesh: DeviceMesh, batch_shape) -> TensorParallel:
    """:func:`tensor_parallel` for a train batch of ``batch_shape`` (B, S)
    tokens: the stream laid out as the labels (``batch``, ``seq``), the SSM
    heads as a decode cache of B rows splits them, an encoder-decoder's
    frames as B rows of ``enc_seq`` (``batch``, ``seq``)."""
    sizes = mesh_axis_sizes(mesh)
    stream = resolve_spec(tuple(batch_shape), ("batch", "seq"), sizes)
    return tensor_parallel(cfg, spec_tree, mesh, stream,
                           _ssm_head_axes(cache_specs(cfg, *batch_shape), sizes),
                           _frames(cfg, batch_shape[0], sizes))


def _with_cache(tp: TensorParallel, cfg: ArchConfig, cache_specs,
                mesh: DeviceMesh) -> TensorParallel:
    """``tp`` with the layout of ``cache_specs``: its k / v leaves'
    ((periods, B, S, Hkv, hd); an encoder-decoder's ``cross`` leaves apart)
    and its SSM leaves' (the conv history's channels; the state's heads are
    the plan's).  Raises ValueError where
    the cache splits its kv heads (not the decode-SP layout), its leaves
    split their rows differently or not as a split of the stream's, or its
    state's heads not as the plan's."""
    sizes = mesh_axis_sizes(mesh)
    lay = _cache_layout(cache_specs, sizes)
    if len(lay["kv"]) > 1 or not (lay["kv"] or lay["heads"]) or len(lay["cross"]) > 1:
        raise ValueError(f"{cfg.name}: the cache's k / v leaves lay out as {sorted(lay['kv'])}, "
                         f"its cross leaves as {sorted(lay['cross'])}")
    if len(lay["rows"]) != 1:
        raise ValueError(f"{cfg.name}: the cache's leaves split their rows as "
                         f"{sorted(lay['rows'])}")
    rows = next(iter(lay["rows"]))
    if rows[:len(tp.batch_axes)] != tp.batch_axes:
        raise ValueError(f"the cache's rows on {rows} do not split the stream's {tp.batch_axes}")
    fields: dict = dict(cache_row_axes=rows[len(tp.batch_axes):])
    for kind, spec_field, seq_field in (("kv", "cache_spec", "cache_seq_axes"),
                                        ("cross", "cross_cache_spec", "cross_seq_axes")):
        if lay[kind]:
            spec = next(iter(lay[kind]))
            if _live(spec[3], sizes) or _live(spec[4], sizes):
                raise ValueError(f"{cfg.name}: the cache splits its heads as {spec}")
            fields.update({spec_field: spec, seq_field: _live(spec[2], sizes)})
    if lay["heads"]:
        if lay["heads"] != {tp.ssm_head_axes} or len(lay["conv"]) != 1:
            raise ValueError(f"{cfg.name}: the cache's ssm heads on {sorted(lay['heads'])} and "
                             f"conv channels on {sorted(lay['conv'])}, the plan's heads on "
                             f"{tp.ssm_head_axes}")
        fields["cache_conv_axes"] = next(iter(lay["conv"]))
    return dataclasses.replace(tp, **fields)


def plan_prefill(cfg: ArchConfig, spec_tree, mesh: DeviceMesh, batch_shape) -> TensorParallel:
    """The plan of a sharded prefill of ``batch_shape`` (B, S) tokens: the
    stream laid out as the tokens (``batch``, ``seq``), an encoder-decoder's
    frames as B rows of ``enc_seq``, and the cache of (B, S) (every
    position, a sliding window's too; the cross cache at its frames) as the
    decode-SP layout.  Where the kv heads split, their axes must be each
    cache's sequence's, or each must split the cache's sequence or, beyond
    the stream's, its rows, at most one axis each, or leave the cache whole,
    and the cache split over nothing else: the collectives that lay it out
    (:attr:`TensorParallel.heads_traded`; ValueError otherwise)."""
    sizes = mesh_axis_sizes(mesh)
    B, S = batch_shape
    stream = resolve_spec((B, S), ("batch", "seq"), sizes)
    cache = _serving_cache(cfg, B, S)
    tp = _with_cache(tensor_parallel(cfg, spec_tree, mesh, stream, _ssm_head_axes(cache, sizes),
                                     _frames(cfg, B, sizes)), cfg, cache, mesh)
    for plan in (tp, tp.cross) if tp.cross_cache_spec is not None else (tp,):
        if plan.kv_local and not plan.heads_traded:
            raise ValueError(f"kv heads split over {plan.qkv_axes}, the cache's rows over "
                             f"{plan.cache_row_axes} and sequence over {plan.cache_seq_axes}: "
                             "no collective lays the cache out")
    return tp


def plan_decode(cfg: ArchConfig, spec_tree, cache_spec_tree, mesh: DeviceMesh,
                batch: int) -> TensorParallel:
    """The plan of a sharded decode step of ``batch`` tokens against the
    cache of ``cache_spec_tree`` (``Model.cache_specs``): the stream this
    rank's batch rows of one token, the cache its own resolved layout, the
    weights' embed axes that the rows do not split
    (:attr:`TensorParallel.stationary_axes`: ``data`` for one row under the
    baseline profile; none where the rows split over it), and the tables'
    embed axes that they do (:attr:`TensorParallel.table_axes`)."""
    sizes = mesh_axis_sizes(mesh)
    stream = resolve_spec((batch, 1), ("batch", "seq"), sizes)
    tp = _with_cache(tensor_parallel(cfg, spec_tree, mesh, stream,
                                     _ssm_head_axes(cache_spec_tree, sizes)),
                     cfg, cache_spec_tree, mesh)
    embed, table, conv = set(), set(), set()

    def note(path, p):
        spec = resolve_spec(p.shape, p.logical, sizes)
        for entry, lname in zip(spec, p.logical):
            if lname in FSDP_LOGICAL:
                embed.update(_live(entry, sizes))
                if path in TABLES:
                    table.update(_live(entry, sizes))
        if "ssm_inner" in p.logical and path.rsplit("/", 1)[-1] in ("conv_w", "conv_b"):
            conv.add(_live(spec[-1], sizes))
    tree_map_pspec(note, spec_tree)
    stationary = tuple(ax for ax in tp.mesh_axes if ax in embed and ax not in tp.batch_axes)
    return dataclasses.replace(tp, stationary_axes=stationary, conv_local=bool(
        stationary and tp.cache_conv_axes and conv == {tp.cache_conv_axes}), q_slice_axes=(),
        decode=True, table_axes=tuple(ax for ax in tp.batch_axes if ax in table))
