"""Llama-3 405B — dense GQA, 128k vocab [arXiv:2407.21783].

optstate_dtype=bfloat16: fp32 AdamW moments put 405B at 19 GiB/chip on a
256-chip pod (> v5e 16 GiB HBM); bf16 moments bring params+opt to ~12.7 GiB
(documented trade-off, DESIGN.md §6 / EXPERIMENTS.md §Dry-run).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab=128256, head_dim=128, rope_theta=5e5,
    optstate_dtype="bfloat16",
)

SMOKE = ArchConfig(
    name="llama3-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192,
    vocab=512, head_dim=8, rope_theta=5e5, optstate_dtype="bfloat16",
    loss_chunk=32,
)
