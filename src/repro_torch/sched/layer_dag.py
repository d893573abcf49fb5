"""Lower an architecture config to a pipeline task DAG with per-device-class
costs: the bridge between the LM stack and the paper's scheduler.

The DAG is the (microbatch x stage) grid of pipeline execution:

    fwd(mb, s-1) -> fwd(mb, s)            activations flow between stages
    fwd(mb, s)   -> bwd(mb, s)            stashed activations (training)
    bwd(mb, s+1) -> bwd(mb, s)            gradient flow (training)

Stages: embed, layer_0..layer_{L-1}, head.  Node cost on a device class is
the roofline max(flops/peak, bytes/bw) of that stage for one microbatch.

Device classes are slices whose compute/bandwidth balances cross: the
flops-richer class favours the compute-bound attention stages, the
bandwidth-richer one the SSM, MoE and decode stages -- the CPU/GPU matching
structure of the paper (§2) on an accelerator fleet.  numpy only, as the
reference's copy; the plans it yields are identical to the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import ArchConfig, ShapeCell
from ..core.machine import Machine
from ..core.taskgraph import from_edges


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    name: str
    flops: float        # peak FLOP/s of the slice (bf16)
    hbm_bw: float       # bytes/s aggregate of the slice
    link_bw: float      # bytes/s egress of the slice
    count: int          # available slices


# The reference's fleet description, value for value: a planning input that
# every default plan depends on, not a measurement of any card.  Its TPU
# classes' figures are quoted data, marked so on their lines; no peak of the
# port's own hardware model comes from them.
DEFAULT_FLEET = [
    DeviceClass("v5e-96", 96 * 197e12, 96 * 819e9, 50e9, 12),  # quoted fleet data
    DeviceClass("v5p-32", 32 * 459e12, 32 * 2765e9, 90e9, 6),  # quoted fleet data
    DeviceClass("v5e-96-degraded", 48 * 197e12, 48 * 819e9, 25e9, 4),  # quoted fleet data
    DeviceClass("host-cpu", 3e12, 100e9, 12.5e9, 32),
]


def fleet_machine(fleet=None) -> Machine:
    fleet = fleet or DEFAULT_FLEET
    P = len(fleet)
    L = np.full(P, 1e-5)                      # ~10us collective setup
    bw = np.empty((P, P))
    for i, a in enumerate(fleet):
        for j, b in enumerate(fleet):
            bw[i, j] = min(a.link_bw, b.link_bw)
    counts = np.array([c.count for c in fleet], np.int64)
    return Machine(L=L, bw=bw, counts=counts)


def _stage_costs(cfg: ArchConfig, kind: str, tokens: int) -> tuple[list[str], list[float], list[float]]:
    """Per-stage (label, flops, hbm bytes) for `tokens` tokens (one microbatch)."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.hd
    mult = 3 if cfg.mlp_style == "swiglu" else 2
    labels = ["embed"]
    flops = [2.0 * tokens * d]
    bytes_ = [2.0 * min(cfg.vocab, tokens) * d + 4.0 * tokens * d]
    pattern = cfg.layer_pattern()
    for layer in range(cfg.n_layers):
        mixer, channel = pattern[layer % cfg.period]
        f = 0.0
        b = 0.0
        if mixer == "attn":
            f += 2 * tokens * d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
            f += 2 * tokens * cfg.n_heads * hd * d
            ctx = tokens if kind != "decode" else cfg.window or tokens
            f += 4 * tokens * ctx * cfg.n_heads * hd
            b += 2 * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
            if kind == "decode":
                b += 2 * 2 * ctx * cfg.n_kv_heads * hd  # KV cache stream
        else:
            di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            f += 2 * tokens * d * (2 * di + 2 * N + H) + 2 * tokens * di * d
            f += 6 * tokens * di * N + 2 * tokens * cfg.ssm_chunk * di
            b += 2 * (d * (2 * di + 2 * N + H) + di * d)
            if kind == "decode":
                b += 4 * H * (di // max(H, 1)) * N  # recurrent state read/write
        if channel == "mlp":
            f += 2 * mult * tokens * d * ff
            b += 2 * mult * d * ff
        elif channel == "moe":
            f += 2 * mult * tokens * cfg.top_k * d * ff
            b += 2 * mult * d * ff * min(cfg.n_experts, max(cfg.top_k * tokens, 1))
        b += 4.0 * tokens * d  # residual stream in/out
        labels.append(f"L{layer}:{mixer}/{channel}")
        flops.append(f)
        bytes_.append(b)
    labels.append("head")
    flops.append(2.0 * tokens * d * cfg.vocab)
    bytes_.append(2.0 * d * cfg.vocab + 4.0 * tokens * d)
    return labels, flops, bytes_


def build_layer_dag(cfg: ArchConfig, cell: ShapeCell, fleet=None, n_micro: int = 8):
    """Returns (TaskGraph, comp (v,P), Machine, labels).

    Node v = mb * n_stages + s (fwd), then the mirrored bwd grid for training.
    """
    fleet = fleet or DEFAULT_FLEET
    m = fleet_machine(fleet)
    if cell.kind == "decode":
        n_micro = 1
    total_tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    tokens = max(1, total_tokens // n_micro)
    s_labels, s_flops, s_bytes = _stage_costs(cfg, cell.kind, tokens)
    S = len(s_labels)
    act = 2.0 * tokens * cfg.d_model

    train = cell.kind == "train"
    labels: list[str] = []
    flops: list[float] = []
    bytes_: list[float] = []
    edges: list[tuple[int, int, float]] = []

    def fid(mb, s):
        return mb * S + s

    def bid(mb, s):
        return n_micro * S + mb * S + (S - 1 - s)  # bwd nodes in topo order

    for mb in range(n_micro):
        for s in range(S):
            labels.append(f"mb{mb}/{s_labels[s]}")
            flops.append(s_flops[s])
            bytes_.append(s_bytes[s])
            if s > 0:
                edges.append((fid(mb, s - 1), fid(mb, s), act))
    if train:
        for mb in range(n_micro):
            for s in range(S - 1, -1, -1):
                labels.append(f"mb{mb}/{s_labels[s]}'")
                flops.append(2.0 * s_flops[s])
                bytes_.append(2.0 * s_bytes[s])
        for mb in range(n_micro):
            for s in range(S):
                edges.append((fid(mb, s), bid(mb, s), act))      # stashed acts
                if s + 1 < S:
                    edges.append((bid(mb, s + 1), bid(mb, s), act))  # grad flow

    g = from_edges(len(labels), edges)
    v = len(labels)
    comp = np.empty((v, m.P))
    for j, cl in enumerate(fleet):
        comp[:, j] = np.maximum(np.asarray(flops) / cl.flops,
                                np.asarray(bytes_) / cl.hbm_bw)
    return g, comp, m, labels
