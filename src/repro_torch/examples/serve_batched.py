"""Serve small models with batched requests: prefill once, decode greedily
with per-sequence EOS; a dense model, a sliding-window (ring-buffer KV
cache) variant and an SSM (state cache) variant.

On the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from .. import configs as C
from ..configs.base import ArchConfig
from ..serve import Engine, ServeConfig

# small dense model (trained weights would come from checkpoint.restore)
CFG = ArchConfig(
    name="demo-serve", family="dense",
    n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=512,
    vocab=4096, head_dim=32, remat="none",
)
B, P, NEW, EOS = 8, 16, 24, 1
SMALL_B, SMALL_P, SMALL_NEW = 2, 12, 8


def engine_configs(compute_dtype: str | None = None) -> dict:
    """The three engines' configs: the demo dense model, mixtral smoke with
    a window of 8 (shorter than the prompt: the ring cache) and mamba2
    smoke; each in ``compute_dtype`` where given, else its own."""
    cfgs = {"dense": CFG,
            "swa": dataclasses.replace(C.get("mixtral-8x22b", smoke=True), window=8),
            "ssm": C.get("mamba2-2.7b", smoke=True)}
    if compute_dtype is None:
        return cfgs
    return {k: dataclasses.replace(c, compute_dtype=compute_dtype) for k, c in cfgs.items()}


def prompts() -> dict:
    """Each engine's (prompts, new tokens): 8 prompts of 16 tokens (seed 0)
    for the dense model, the first 2 cut to 12 tokens for the others, taken
    modulo each one's vocabulary (256 for both smoke models; the reference's
    example takes the SSM's so and gives the sliding-window model ids past
    its vocabulary, which JAX's gather clamps to its last row)."""
    cfgs = engine_configs()
    p = np.random.default_rng(0).integers(2, CFG.vocab, (B, P)).astype(np.int32)
    small = p[:SMALL_B, :SMALL_P]
    return {"dense": (p, NEW), "swa": (small % cfgs["swa"].vocab, SMALL_NEW),
            "ssm": (small % cfgs["ssm"].vocab, SMALL_NEW)}


def run(device="cuda", params: dict | None = None, compute_dtype: str | None = None) -> dict:
    """Each engine's greedy tokens and seconds (the first call: no warm-up).
    ``params`` maps an engine's name to its parameter tree on ``device``;
    an engine without one makes its own from seed 0 there."""
    params = params or {}
    out, inputs = {}, prompts()
    for name, cfg in engine_configs(compute_dtype).items():
        eng = Engine(cfg, params=params.get(name), device=device)
        x, new = inputs[name]
        t0 = time.perf_counter()
        toks = eng.generate(x, ServeConfig(max_new_tokens=new, eos_id=EOS))
        out[name] = dict(tokens=toks, seconds=time.perf_counter() - t0)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)
    dense = out["dense"]
    new = dense["tokens"].shape[1] - P
    print(f"batched decode: {dense['tokens'].shape[0]} seqs x {new} new tokens "
          f"in {dense['seconds']:.2f}s ({dense['tokens'].shape[0] * new / dense['seconds']:.0f} "
          f"tok/s, first call)")
    print("sample:", dense["tokens"][0, :24].tolist())
    print("SWA ring-cache decode ok:", out["swa"]["tokens"].shape)
    print("SSM state decode ok:", out["ssm"]["tokens"].shape)
    return out


if __name__ == "__main__":
    main()
