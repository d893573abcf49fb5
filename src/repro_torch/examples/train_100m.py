"""End-to-end example: train a ~100M-parameter GQA decoder for a few hundred
steps on a mesh of the world this process was started in, with
checkpointing, the WSD schedule, straggler monitoring (re-plans sweep on the
trainer's device) and a simulated mid-run node failure and recovery.

On the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300]
  PYTHONPATH=src python -m repro_torch.examples.train_100m --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import tempfile

import torch.distributed as dist

from ..configs.base import ArchConfig, ShapeCell
from ..launch.mesh import make_test_mesh
from ..train import Trainer, TrainerConfig

# ~100M params: 12L x 768d (GPT-2-small-ish, llama-style blocks)
CFG_100M = ArchConfig(
    name="demo-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=2048,
    vocab=32768, head_dim=64, schedule="wsd", remat="none", loss_chunk=128,
)
# ~2M params: the same code path, seconds on a CPU
SMOKE = dict(name="demo-smoke", n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
             d_ff=512, vocab=2048)
CKPT_EVERY, LOG_EVERY, PEAK_LR = 50, 10, 3e-4


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_100m_ckpt"))
    ap.add_argument("--fail-at", type=int, default=0,
                    help="simulate a node failure at this step")
    ap.add_argument("--smoke", action="store_true",
                    help="~2M-param model: same code path, finishes in seconds on a CPU")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains and the straggler re-plans sweep")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps = min(args.steps, 20)
    # explicit --seq/--batch always win; otherwise scale-appropriate defaults
    args.seq = args.seq or (64 if args.smoke else 256)
    args.batch = args.batch or (4 if args.smoke else 8)
    return args


def run(args: argparse.Namespace) -> dict:
    """One ``Trainer`` run as ``args`` set it, on a ``make_test_mesh`` of
    ``args.device``: its logged losses, its events and the model's size.
    A process group this run starts, it ends."""
    cfg = dataclasses.replace(CFG_100M, **SMOKE) if args.smoke else CFG_100M
    cell = ShapeCell("train_demo", seq_len=args.seq, global_batch=args.batch, kind="train")
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=CKPT_EVERY, ckpt_dir=args.ckpt,
                         log_every=LOG_EVERY, peak_lr=PEAK_LR,
                         fail_at_steps=(args.fail_at,) if args.fail_at else ())
    started = not dist.is_initialized()
    try:
        tr = Trainer(cfg, cell, tcfg,
                     mesh_factory=functools.partial(make_test_mesh, device_type=args.device),
                     device=args.device)
        metrics = tr.run()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return dict(n_params=cfg.n_params(), steps=args.steps, batch=args.batch, seq=args.seq,
                losses=[m for m in metrics if "loss" in m],
                events=[m for m in metrics if "event" in m], restarts=tr.restarts)


def main(argv=None) -> dict:
    args = parse(argv)
    n = (dataclasses.replace(CFG_100M, **SMOKE) if args.smoke else CFG_100M).n_params()
    print(f"model: {n/1e6:.1f}M params, {args.steps} steps, "
          f"{args.batch}x{args.seq} tokens/step")
    out = run(args)
    losses = out["losses"]
    print(f"\nstep {losses[0]['step']:4d}  loss {losses[0]['loss']:.4f}")
    print(f"step {losses[-1]['step']:4d}  loss {losses[-1]['loss']:.4f}")
    for e in out["events"]:
        print("event:", e)
    if not losses[-1]["loss"] < losses[0]["loss"]:
        raise RuntimeError(f"loss did not improve: {losses[0]} -> {losses[-1]}")
    print("OK: loss improved; checkpoints in", args.ckpt)
    return out


if __name__ == "__main__":
    main()
