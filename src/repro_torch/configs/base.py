"""Architecture config schema + the assigned input-shape cells.

Every assigned architecture gets one module defining ``CONFIG`` (the exact
published dims) and ``SMOKE`` (a reduced same-family variant for CPU smoke
tests).  ``repro_torch.configs.get(name)`` resolves either.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int             # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int                # per-expert FF width for MoE families
    vocab: int
    head_dim: int = 0        # 0 -> d_model // n_heads
    # -- MoE --
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1       # MoE replaces MLP every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    # -- SSM (Mamba-2 / SSD) --
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4
    # -- hybrid --
    attn_every: int = 0      # jamba: 1 attention layer per 8 (index attn_pos)
    attn_pos: int = 4
    # -- attention flavour --
    window: int = 0          # sliding-window size (0 = full causal)
    use_rope: bool = True    # jamba: no positional encoding
    rope_theta: float = 1e4
    mrope: bool = False      # qwen2-vl multimodal RoPE
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    mlp_style: str = "swiglu"  # swiglu | gelu (whisper)
    schedule: str = "cosine"   # cosine | wsd (minicpm)
    # -- encoder-decoder --
    enc_layers: int = 0
    enc_seq: int = 1500      # whisper audio frames (stubbed frontend)
    # -- misc --
    frontend: str = "none"   # none | audio_stub | vision_stub
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    optstate_dtype: str = "float32"   # bf16 for llama3-405b (fits 16 GiB HBM)
    remat: str = "full"      # full | none  (activation checkpointing policy)
    loss_chunk: int = 512    # sequence chunking for the CE loss
    # -- shape-cell applicability --
    supports_long: bool = False   # run long_500k (sub-quadratic mixers only)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def period(self) -> int:
        """Layer-pattern period for the scanned stack."""
        if self.family == "hybrid":
            return self.attn_every
        return 1

    def layer_pattern(self) -> list[tuple[str, str]]:
        """(sequence-mixer, channel-mixer) per period position."""
        if self.family in ("dense", "vlm", "encdec"):  # encdec: decoder stack
            return [("attn", "mlp")]
        if self.family == "moe":
            return [("attn", "moe")]
        if self.family == "ssm":
            return [("ssm", "none")]
        if self.family == "hybrid":
            out = []
            for i in range(self.attn_every):
                mixer = "attn" if i == self.attn_pos else "ssm"
                channel = "moe" if (i % self.moe_every == 1) else "mlp"
                out.append((mixer, channel))
            return out
        raise ValueError(self.family)

    def n_params(self) -> int:
        """Analytic parameter count (excludes negligible norms/biases)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        for mixer, channel in self.layer_pattern():
            reps = self.n_layers // self.period
            if mixer == "attn":
                attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.hd * d
                total += attn * reps
            else:
                di, st = self.d_inner, self.ssm_state
                ssm = d * (2 * di + 2 * st + self.ssm_heads) + di * d  # in/out proj (+BC, dt)
                total += ssm * reps
            mult = 3 if self.mlp_style == "swiglu" else 2
            if channel == "mlp":
                total += mult * d * ff * reps
            elif channel == "moe":
                total += (mult * d * ff * self.n_experts + d * self.n_experts) * reps
        if self.family == "encdec":
            # add encoder stack (self-attn + mlp) and decoder cross-attn
            mult = 3 if self.mlp_style == "swiglu" else 2
            attn = 4 * d * self.n_heads * self.hd
            total += self.enc_layers * (attn + mult * d * ff)
            total += self.n_layers * attn  # cross attention
        return total

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        mult = 3 if self.mlp_style == "swiglu" else 2
        reps = self.n_layers // self.period
        moe_positions = sum(1 for _, c in self.layer_pattern() if c == "moe")
        dense_moe = mult * d * ff * self.n_experts * moe_positions * reps
        active_moe = mult * d * ff * self.top_k * moe_positions * reps
        return self.n_params() - dense_moe + active_moe


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cells_for(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long:
        out.append("long_500k")
    return out


# smoke (seq_len, global_batch) per cell: shrunk to CPU scale but keeping the
# cell's character (shared by the dry-run and roofline --smoke paths)
_SMOKE_SCALE: dict[str, tuple[int, int]] = {
    "train_4k": (64, 8),
    "prefill_32k": (128, 4),
    "decode_32k": (128, 8),
    "long_500k": (512, 2),
}


def smoke_cell(cell_name: str) -> ShapeCell:
    """The named cell shrunk to smoke scale (fake-fleet / CPU testing)."""
    seq, batch = _SMOKE_SCALE[cell_name]
    return dataclasses.replace(SHAPES[cell_name], seq_len=seq, global_batch=batch)
