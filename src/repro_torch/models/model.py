"""Model facade: one object per architecture exposing spec trees, init and
the prefill/decode functions."""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from . import encdec, transformer
from .common import abstract_params, init_params, torch_dtype


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def specs(self):
        if self.cfg.family == "encdec":
            return encdec.model_specs(self.cfg)
        return transformer.model_specs(self.cfg)

    def init(self, generator: torch.Generator, device):
        return init_params(self.specs(), generator, device,
                           torch_dtype(self.cfg.param_dtype))

    def abstract(self):
        return abstract_params(self.specs(), torch_dtype(self.cfg.param_dtype))

    def cache_specs(self, batch: int, seq: int):
        if self.cfg.family == "encdec":
            return encdec.cache_specs(self.cfg, batch, seq)
        return transformer.cache_specs(self.cfg, batch, seq)

    def prefill(self, params, batch):
        """Returns (per-layer cache stacked over periods, last-token logits);
        the encoder-decoder takes ``batch["frames"]`` beside the tokens."""
        cfg = self.cfg
        if cfg.family == "encdec":
            enc_out = encdec.encode(params, cfg, batch["frames"])
            hidden, cache = encdec.decode_full(params, cfg, batch["tokens"], enc_out,
                                               want_cache=True)
            return cache, (hidden[:, -1:] @ params["unembed"].to(hidden.dtype)).float()
        hidden, _, cache = transformer.forward_full(
            params, self.cfg,
            tokens=batch.get("tokens"),
            embeds=batch.get("embeds"),
            positions=batch.get("positions"),
            want_cache=True,
        )
        return cache, transformer.unembed(params, self.cfg, hidden[:, -1:])

    def decode(self, params, cache, tokens, pos: int, positions=None):
        """One token at position ``pos``; the cache is written in place."""
        if self.cfg.family == "encdec":
            return encdec.decode_step(params, self.cfg, cache, tokens, pos)
        return transformer.decode_step(params, self.cfg, cache, tokens=tokens,
                                       pos=pos, positions=positions)


def build(cfg: ArchConfig) -> Model:
    return Model(cfg)
