"""GLM-4 9B — dense, extreme GQA (2 kv heads), RoPE [hf:THUDM/glm-4-9b]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=151552, head_dim=128,
)

SMOKE = ArchConfig(
    name="glm4-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=256, head_dim=16, loss_chunk=32,
)
