"""repro_torch.train — the fault-tolerant training loop."""
from .trainer import SimulatedFailure, Trainer, TrainerConfig

__all__ = ["SimulatedFailure", "Trainer", "TrainerConfig"]
