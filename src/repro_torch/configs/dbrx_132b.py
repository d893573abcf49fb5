"""DBRX 132B — fine-grained MoE: 16 experts top-4 [hf:databricks/dbrx-base]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, head_dim=128,
    n_experts=16, top_k=4,
)

SMOKE = ArchConfig(
    name="dbrx-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=256, head_dim=16,
    n_experts=8, top_k=4, loss_chunk=32,
)
