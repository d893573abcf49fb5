"""repro_torch.models — the decoder LMs (dense, MoE, VLM backbone) in plain
PyTorch."""
from .common import (
    PSpec,
    ShardingProfile,
    abstract_params,
    active_profile,
    init_params,
    profile_names,
    resolve_profile,
    sharding_profile,
)
from .model import Model, build

__all__ = [
    "Model", "PSpec", "ShardingProfile", "abstract_params", "active_profile",
    "build", "init_params", "profile_names", "resolve_profile", "sharding_profile",
]
