"""Mamba-2 2.7B — attention-free SSD (state-space duality) [arXiv:2405.21060].

64 pure-SSM layers, d_state=128, O(1) decode state -> runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=64, ssm_conv=4,
    tie_embeddings=True,
    supports_long=True,
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_chunk=16, ssm_conv=4,
    tie_embeddings=True, loss_chunk=32,
    supports_long=True,
)
