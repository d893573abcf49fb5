"""repro_torch.models — every assigned architecture in plain PyTorch: the
decoder LMs (dense, MoE, SSM, hybrid, VLM backbone; ``transformer``,
``moe``, ``ssm``) and the encoder-decoder (``encdec``)."""
from . import encdec, ssm, transformer
from .common import (
    PSpec,
    ShardingProfile,
    abstract_params,
    active_profile,
    init_params,
    profile_names,
    resolve_profile,
    set_sharding_profile,
    sharding_profile,
)
from .model import Model, build

__all__ = [
    "Model", "PSpec", "ShardingProfile", "abstract_params", "active_profile",
    "build", "encdec", "init_params", "profile_names", "resolve_profile",
    "set_sharding_profile", "sharding_profile", "ssm", "transformer",
]
