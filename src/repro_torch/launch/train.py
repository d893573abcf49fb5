"""Training launcher: any assigned architecture at smoke scale, on the card
unless ``--device cpu``, over a ``make_test_mesh`` of the world it was started
in: one rank, or every rank ``torchrun`` started (a card each under NCCL, or
host ranks under gloo with ``--device cpu``).  Rank 0 prints the metrics.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --steps 50
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu

``--resume`` is parsed and, as in the reference, not read: a run always
starts from a fresh state (ROADMAP Queue 3).
"""
import argparse
import os
import tempfile

import torch.distributed as dist

from .. import configs as C
from ..configs.base import ShapeCell
from ..models.common import profile_names
from ..train import Trainer, TrainerConfig
from .mesh import make_test_mesh


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=C.ARCHS, default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid checkpoint before training")
    ap.add_argument("--profile", default="opt1", choices=profile_names(),
                    help="sharding profile, scoped to this trainer")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains and the straggler re-plans sweep")
    args = ap.parse_args()

    cfg = C.get(args.arch, smoke=args.smoke)
    cell = ShapeCell("cli", seq_len=args.seq, global_batch=args.batch, kind="train")
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, log_every=max(1, args.steps // 20),
                         profile=args.profile)
    tr = Trainer(cfg, cell, tcfg, lambda: make_test_mesh(device_type=args.device),
                 device=args.device)
    try:
        metrics = tr.run()
        if dist.get_rank() == 0:
            for m in metrics:
                print(m, flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
