"""repro_torch.optim — optimizer + schedules built from scratch."""
from .adamw import AdamW, AdamWState
from .schedules import for_config, warmup_cosine, wsd

__all__ = ["AdamW", "AdamWState", "for_config", "warmup_cosine", "wsd"]
