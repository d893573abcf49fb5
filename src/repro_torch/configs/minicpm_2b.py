"""MiniCPM 2B — llama-like MHA, tied embeddings, WSD schedule [arXiv:2404.06395]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753, head_dim=64,
    tie_embeddings=True, schedule="wsd",
)

SMOKE = ArchConfig(
    name="minicpm-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=6, d_ff=96,
    vocab=256, head_dim=8, tie_embeddings=True, schedule="wsd", loss_chunk=32,
)
