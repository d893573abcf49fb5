"""Learning-rate schedules: warmup+cosine, and WSD (warmup-stable-decay,
MiniCPM's schedule [arXiv:2404.06395] -- minicpm-2b trains with this).

Each schedule takes the step as a tensor and computes in float32, as the
reference does."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup: int, total: int, floor_frac: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        wu = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, wu, cos)
    return lr


def wsd(peak: float, warmup: int, total: int, decay_frac: float = 0.1,
        floor_frac: float = 0.01):
    """Warmup -> Stable (constant peak) -> Decay (last decay_frac of steps,
    geometric drop to floor)."""
    decay_start = int(total * (1.0 - decay_frac))

    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        wu = peak * s / max(warmup, 1)
        t = torch.clamp((s - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
        dec = peak * torch.exp(math.log(floor_frac) * t)  # geometric decay to floor
        stable = torch.full_like(s, peak)
        return torch.where(s < warmup, wu, torch.where(s < decay_start, stable, dec))
    return lr


def for_config(schedule: str, peak: float, warmup: int, total: int):
    if schedule == "wsd":
        return wsd(peak, warmup, total)
    return warmup_cosine(peak, warmup, total)
