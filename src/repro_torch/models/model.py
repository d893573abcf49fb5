"""Model facade: one object per architecture exposing spec trees, init,
the loss, the prefill/decode functions and input specs for every shape
cell."""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig, ShapeCell
from . import encdec, transformer
from .common import abstract_params, init_params, param_shardings, torch_dtype


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

    def shardings(self, mesh):
        return param_shardings(self.specs(), mesh)

    def cache_specs(self, batch: int, seq: int, ring: bool = True):
        """The decode cache's PSpecs; not ``ring``: a sliding window's
        attention cache at every position, as ``prefill`` returns it."""
        if self.cfg.family == "encdec":
            return encdec.cache_specs(self.cfg, batch, seq)
        return transformer.cache_specs(self.cfg, batch, seq, ring)

    def loss(self, params, batch) -> torch.Tensor:
        """batch: tokens/labels (+ frames for encdec, embeds/positions for vlm);
        the mean cross-entropy plus the MoE load-balance term, float32."""
        xent, aux = self.loss_terms(params, batch)
        return xent + aux

    def loss_terms(self, params, batch, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The loss's two terms apart: the cross-entropy's mean over the
        valid labels, and the MoE load-balance term (a mean over batch
        rows and token groups; zero without experts).  ``tp`` (a
        ``TensorParallel``): ``params``
        are this rank's working shards and ``batch`` its slice of the
        stream, the mean is over its own labels, and the load-balance term
        is this rank's share of the whole batch's (the shares sum to it
        over the mesh)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.loss(params, cfg, batch["frames"], batch["tokens"], batch["labels"],
                               tp)
        hidden, aux, _ = transformer.forward_full(
            params, cfg,
            tokens=batch.get("tokens"),
            embeds=batch.get("embeds"),
            positions=batch.get("positions"),
            tp=tp,
        )
        return transformer.xent_loss(params, cfg, hidden, batch["labels"], tp), aux

    def prefill(self, params, batch, tp=None):
        """Returns (per-layer cache stacked over periods, last-token logits);
        the encoder-decoder takes ``batch["frames"]`` beside the tokens.
        ``tp`` (a ``plan_prefill`` plan): ``params`` are this rank's working
        shards and ``batch`` its slice of the stream (and of the frames);
        the cache is this rank's shard (every position, a sliding window's
        too; the cross cache in its own layout) and the logits its rows and
        vocabulary columns (``TensorParallel.logits_spec``)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.prefill(params, cfg, batch["frames"], batch["tokens"], tp)
        hidden, _, cache = transformer.forward_full(
            params, self.cfg,
            tokens=batch.get("tokens"),
            embeds=batch.get("embeds"),
            positions=batch.get("positions"),
            want_cache=True,
            tp=tp,
        )
        return cache, transformer.unembed(params, self.cfg, hidden[:, -1:] if tp is None
                                          else tp.last_token(hidden))

    def decode(self, params, cache, tokens, pos: int, positions=None, tp=None):
        """One token at position ``pos``; the cache is written in place.
        ``tp`` (a ``plan_decode`` plan): this rank's working shards, stream
        rows and cache shard; the logits its rows and columns of them."""
        if self.cfg.family == "encdec":
            return encdec.decode_step(params, self.cfg, cache, tokens, pos, tp)
        return transformer.decode_step(params, self.cfg, cache, tokens=tokens,
                                       pos=pos, positions=positions, tp=tp)

    def input_specs(self, cell: ShapeCell) -> dict[str, torch.Tensor]:
        """Stand-ins on the ``meta`` device (shape and dtype, no bytes) for
        every model input of a shape cell, as the reference's
        ``jax.ShapeDtypeStruct`` stand-ins."""
        cfg = self.cfg
        B, S = cell.global_batch, cell.seq_len

        def spec(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        frames = (B, cfg.enc_seq, cfg.d_model)
        if cell.kind == "train":
            if cfg.family == "encdec":
                return {"frames": spec(frames, torch.float32), "tokens": spec((B, S)),
                        "labels": spec((B, S))}
            if cfg.family == "vlm":
                return {"embeds": spec((B, S, cfg.d_model), torch.float32),
                        "labels": spec((B, S)), "positions": spec((3, B, S))}
            return {"tokens": spec((B, S)), "labels": spec((B, S))}
        if cell.kind == "prefill":
            if cfg.family == "encdec":
                return {"frames": spec(frames, torch.float32), "tokens": spec((B, S))}
            if cfg.family == "vlm":
                return {"embeds": spec((B, S, cfg.d_model), torch.float32),
                        "positions": spec((3, B, S))}
            return {"tokens": spec((B, S))}
        # decode: one new token against a seq_len cache
        out = {"tokens": spec((B, 1)), "pos": spec(())}
        if cfg.family == "vlm":
            out["positions"] = spec((3, B, 1))
        return out


def build(cfg: ArchConfig) -> Model:
    return Model(cfg)
