"""Batched serving engine: prefill once, decode greedily with per-sequence
EOS stop, KV cache reconciliation between the prefill and decode layouts
(including SWA ring-buffer packing).

Serves the dense, MoE, SSM and hybrid decoders; SSM states pass from the
prefill to the decode cache unchanged.  The VLM backbone runs only through
``forward_full``/``decode_step`` with explicit (3, B, S) positions: its
M-RoPE refuses the token positions ``generate`` builds, as the reference's
does.  The encoder-decoder family is refused: the reference's ``Engine``
fails on it too (ROADMAP Queue 3), and its model runs through
``Model.prefill``/``Model.decode``.  ``ServeConfig`` is shared with the
router, the pool and its workers, which run against any object with
``generate(prompts, ServeConfig)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.ceft_torch import resolve_device
from ..models.common import (
    ShardingProfile,
    active_profile,
    init_params,
    resolve_profile,
    sharding_profile,
    tree_leaves,
)
from ..models.model import build


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    eos_id: int = 1


class Engine:
    """Greedy batched generation for one architecture on one device.

    ``params`` (a tree as ``Model.init`` makes it, on ``device``) is used as
    given, never copied, so several engines can share one parameter set;
    without it the engine initializes its own from ``seed`` on ``device``.
    Parameters stay in ``cfg.param_dtype`` and are cast to
    ``cfg.compute_dtype`` at each product, as in the reference.  ``device``
    is the card unless the caller passes ``device="cpu"``; asking for CUDA
    without it raises."""

    def __init__(self, cfg: ArchConfig, params=None, seed: int = 0,
                 profile: str | ShardingProfile | None = None, device="cuda"):
        if cfg.family == "encdec":
            raise NotImplementedError(
                f"{cfg.name}: the engine does not serve the encoder-decoder family; the "
                "reference's Engine fails on it too (ROADMAP Queue 3); run its model "
                "through Model.prefill and Model.decode")
        self.cfg = cfg
        self.device = resolve_device(device)
        # pinned at construction (default: whatever is active right now) and
        # re-entered by every generate(), so two engines with different
        # profiles in one process each keep their own
        self.profile = (resolve_profile(profile) if profile is not None
                        else active_profile())
        self.model = build(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            with sharding_profile(self.profile):
                params = self.model.init(gen, self.device)
        else:
            where = {leaf.device.type for leaf in tree_leaves(params)}
            if where != {self.device.type}:
                raise ValueError(f"params lie on {sorted(where)}, "
                                 f"the engine runs on {self.device}")
        self.params = params

    # ------------------------------------------------------------------ cache
    def _seed_cache(self, prefill_cache, B: int, total: int, prompt: int):
        """Pack the prefill K/V (length=prompt) into the decode layout
        (length=total or window); SSM states pass through unchanged.  The
        decode cache is float32, as the reference's (its ``init_params``
        default type), whatever the compute type."""
        cfg = self.cfg
        target = init_params(self.model.cache_specs(B, total), None, self.device)
        w = min(total, cfg.window) if cfg.window else 0
        for k, sub in target.items():
            if "k" not in sub:   # SSM state and conv history: copy_ casts to the cache type
                for n, dst in sub.items():
                    dst.copy_(prefill_cache[k][n])
                continue
            for n in ("k", "v"):
                dst, src = sub[n], prefill_cache[k][n]
                # src: (periods, B, prompt, H, hd) -> dst: (periods, B, Sc, H, hd)
                if w and prompt >= w:
                    # ring layout: slot(t) = t % w for t in [prompt-w, prompt)
                    idx = torch.arange(prompt - w, prompt, device=dst.device) % w
                    dst[:, :, idx] = src[:, :, prompt - w:].to(dst.dtype)
                else:
                    s = min(prompt, dst.shape[2])
                    dst[:, :, :s] = src[:, :, :s].to(dst.dtype)
        return target

    # --------------------------------------------------------------- generate
    def generate(self, prompts: np.ndarray, scfg: ServeConfig | None = None):
        """prompts: (B, P) int32.  Returns (B, P+new) int32 tokens (greedy).

        Runs under ``torch.inference_mode()``, entered here because grad mode
        is per thread and the router calls engines from its own threads."""
        with sharding_profile(self.profile), torch.inference_mode():
            return self._generate(prompts, scfg)

    def _generate(self, prompts: np.ndarray, scfg: ServeConfig | None = None):
        scfg = scfg or ServeConfig()
        prompts = np.asarray(prompts, np.int32)
        B, P = prompts.shape
        total = P + scfg.max_new_tokens
        batch = {"tokens": torch.as_tensor(prompts, device=self.device)}
        pf_cache, logits = self.model.prefill(self.params, batch)
        cache = self._seed_cache(pf_cache, B, total, P)
        del pf_cache

        toks = np.zeros((B, total), np.int32)
        toks[:, :P] = prompts
        done = np.zeros(B, bool)
        cur = torch.argmax(logits[:, -1], dim=-1)
        for t in range(P, total):
            toks[:, t] = np.where(done, scfg.eos_id, cur.cpu().numpy())
            done |= toks[:, t] == scfg.eos_id
            if done.all() or t == total - 1:
                break
            logits, cache = self.model.decode(
                self.params, cache, torch.as_tensor(toks[:, t:t + 1], device=self.device), t)
            cur = torch.argmax(logits[:, -1], dim=-1)
        return toks
