"""Where the LM engine's and the train step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.lm_profile [--arch mamba2-2.7b]
    PYTHONPATH=src python -m repro_torch.lm_profile --train

A decoder LM as published (granite-3-8b unless ``--arch`` names another;
weights made on the card from a seed), one engine, a (4, 512) batch: it
prints one JSON line for the prefill and one for a decode step at position
543 of a 544-slot cache (the engine's last step of 32 new tokens).  Each line holds the host wall time (median of 5, no
profiler), and from one call under ``torch.profiler`` the number of device
kernels, their summed device time in three groups (matrix products; casts
and copies; everything else) with the top kernels by name, and the device's
idle share of the unprofiled wall time.  ``--train`` profiles minicpm-2b's
train step as published instead, at (B, S) = (2, 4096) (``chip_smoke.py``
phase g2's cell): one line for the forward + backward and one for the AdamW
update (medians of 3).  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import configs
from .data import DataConfig, SyntheticLM
from .launch.steps import build_train
from .models import build
from .serve import Engine

ARCH, SEED, B, P, NEW = "granite-3-8b", 0, 4, 512, 32
TRAIN_ARCH, TRAIN_B, TRAIN_S = "minicpm-2b", 2, 4096


def _median_wall(fn, reps: int) -> float:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return sorted(walls)[reps // 2]


def _group(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
        return "matmul"
    if "copy" in low or "cast" in low:
        return "cast_copy"
    return "other"


def profile_call(name: str, fn, reps: int = 5) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    wall = _median_wall(fn, reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in by_name.values())
    groups: dict[str, float] = {}
    for k, v in by_name.items():
        groups[_group(k)] = groups.get(_group(k), 0.0) + v[1] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "call": name,
        "wall_ms": wall * 1e3,
        "device_kernels": sum(v[0] for v in by_name.values()),
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_idle_share": 1 - busy_us / (wall * 1e6) if busy_us else "not measured",
        "busy_ms_by_group": groups if busy_us else "not measured",
        "top_kernels": [{"name": k[:90], "count": v[0], "ms": v[1] / 1e3} for k, v in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    served = [a for a in configs.ARCHS if configs.get(a).family not in ("encdec", "vlm")]
    ap.add_argument("--arch", choices=served, default=ARCH,
                    help="a decoder the engine serves (it must fit the card as published)")
    ap.add_argument("--train", action="store_true",
                    help="profile minicpm-2b's train step at (2, 4096) instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_profile: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    cfg = configs.get(TRAIN_ARCH if args.train else args.arch)
    params = build(cfg).init(torch.Generator("cuda").manual_seed(SEED), "cuda")
    rows = train_rows(cfg, params) if args.train else serve_rows(cfg, params)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for r in rows:
        r["arch"], r["card"] = cfg.name, smi
        print(json.dumps(r), flush=True)
    return 0


def train_rows(cfg, params) -> list:
    """The train step's two halves at (TRAIN_B, TRAIN_S), a SyntheticLM batch."""
    step, opt, _ = build_train(build(cfg))
    state = opt.init(params)
    batch = SyntheticLM(DataConfig(cfg.vocab, TRAIN_S, TRAIN_B, SEED)).device_batch(0, "cuda")
    fwd_bwd = profile_call(f"fwd_bwd_{TRAIN_B}x{TRAIN_S}",
                           lambda: step.loss_and_grads(params, batch), reps=3)
    _, grads = step.loss_and_grads(params, batch)
    return [fwd_bwd, profile_call("adamw_update", lambda: opt.update(grads, state, params),
                                  reps=3)]


def serve_rows(cfg, params) -> list:
    """The engine's (B, P) prefill and one decode step."""
    eng = Engine(cfg, params=params, device="cuda")
    prompts = np.random.default_rng(SEED).integers(2, cfg.vocab, (B, P)).astype(np.int32)
    tokens = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        cache, _ = eng.model.prefill(params, {"tokens": tokens})
        cache = eng._seed_cache(cache, B, P + NEW, P)
        step = tokens[:, -1:]
        rows = [profile_call("prefill_4x512",
                             lambda: eng.model.prefill(params, {"tokens": tokens})),
                profile_call("decode_step_b4",
                             lambda: eng.model.decode(params, cache, step, P + NEW - 1))]
    return rows


if __name__ == "__main__":
    sys.exit(main())
