"""repro_torch.data — the deterministic synthetic token stream."""
from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
