"""Jamba v0.1 52B — Mamba+attention 1:7 interleave with MoE [arXiv:2403.19887].

32 layers, one attention layer per 8 (index 4), MoE (16 experts, top-2) on every
second layer; no positional encoding (use_rope=False).  Sub-quadratic sequence
mixing (28/32 layers are SSM) -> runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, head_dim=128,
    n_experts=16, top_k=2, moe_every=2,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    attn_every=8, attn_pos=4,
    use_rope=False,
    supports_long=True,
)

SMOKE = ArchConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16,
    n_experts=4, top_k=2, moe_every=2,
    ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_conv=4, ssm_chunk=16,
    attn_every=4, attn_pos=2,
    use_rope=False, loss_chunk=32,
    supports_long=True,
)
