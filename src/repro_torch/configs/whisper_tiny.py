"""Whisper tiny — encoder-decoder, conv audio frontend stubbed [arXiv:2212.04356].

input_specs() supplies precomputed frame embeddings (1500, d) in place of the
conv frontend.  GELU 2-proj MLPs, MHA (kv == q heads).  Enc-dec => decode cells
run (decoder self-attn KV cache sized to the cell's seq_len; cross-attn over
the fixed 1500-frame encoder output).  Full attention -> long_500k skipped.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab=51865, head_dim=64, enc_seq=1500,
    mlp_style="gelu", use_rope=False,
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, head_dim=16, enc_seq=64,
    mlp_style="gelu", use_rope=False, loss_chunk=32,
)
