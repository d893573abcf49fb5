"""Granite-3 8B — dense GQA decoder [hf:ibm-granite]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
    vocab=49155, head_dim=128,
)

SMOKE = ArchConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, loss_chunk=32,
)
