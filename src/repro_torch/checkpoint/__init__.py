"""repro_torch.checkpoint — atomic, checksummed checkpoints in the
reference's format."""
from .checkpointer import available_steps, latest_valid, restore, save

__all__ = ["available_steps", "latest_valid", "restore", "save"]
