"""Mixtral 8x22B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].  The 4096-token window bounds the decode KV cache (ring
buffer), making long_500k tractable (sub-quadratic per the assignment)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, head_dim=128,
    n_experts=8, top_k=2, window=4096,
    supports_long=True,
)

SMOKE = ArchConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16,
    n_experts=4, top_k=2, window=32, loss_chunk=32,
    supports_long=True,
)
