"""Qwen2-VL 72B — VLM backbone with M-RoPE [arXiv:2409.12191].

Vision frontend is a stub per the assignment: input_specs() feeds precomputed
patch embeddings plus (temporal, h, w) position ids; the backbone applies
multimodal RoPE over head_dim sections (16, 24, 24) * 2.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128,
    mrope=True, mrope_sections=(16, 24, 24), frontend="vision_stub",
)

SMOKE = ArchConfig(
    name="qwen2vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16,
    mrope=True, mrope_sections=(2, 3, 3), frontend="vision_stub", loss_chunk=32,
)
