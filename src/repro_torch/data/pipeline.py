"""Deterministic, restart-safe synthetic data pipeline.

Batch ``i`` is a pure function of (seed, i): after a crash/restart or an
elastic re-shard, resuming at step ``i`` reproduces the exact token stream --
no iterator state to checkpoint.  Tokens follow a skewed (zipf-ish) marginal with a short-range
bigram structure, so losses decrease measurably during the smoke-scale
training runs (a uniform stream would pin loss at ln(V)).  The host batches
are numpy, identical to the reference's for the same config.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..substrate import distribute


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed random bigram table: next-token dist depends on prev bucket
        self.n_buckets = 16
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        base = 1.0 / ranks  # zipf marginal
        self.tables = np.stack([
            np.roll(base, rng.integers(0, cfg.vocab)) for _ in range(self.n_buckets)
        ])
        self.tables /= self.tables.sum(axis=1, keepdims=True)
        self.cum = np.cumsum(self.tables, axis=1)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        B, S = cfg.global_batch, cfg.seq_len
        u = rng.random((B, S + 1))
        toks = np.zeros((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, B)
        for t in range(1, S + 1):
            bucket = toks[:, t - 1] % self.n_buckets
            toks[:, t] = np.argmax(self.cum[bucket] > u[:, t, None], axis=1)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def device_batch(self, step: int, device) -> dict[str, torch.Tensor]:
        """Batch ``step`` as int32 tensors on ``device``."""
        return {k: torch.as_tensor(v, device=device) for k, v in self.batch(step).items()}

    def sharded_batch(self, step: int, shardings: dict) -> dict:
        """Batch ``step`` laid out by ``shardings`` (``input_shardings``):
        every rank makes the host batch and keeps its own shard of each input
        as a ``DTensor``; an input without a sharding stays a host array."""
        return {k: distribute(torch.as_tensor(v), shardings[k]) if k in shardings else v
                for k, v in self.batch(step).items()}
