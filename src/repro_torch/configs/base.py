"""Config system: model configs (one per assigned architecture) + input-shape cells.

Every architecture in the assigned pool is expressed as a single frozen
``ModelConfig``; family-specific fields are optional with zero-defaults.
``reduced()`` derives the small CPU-smoke-test variant of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

FULL_ATTENTION = 0  # sentinel window size meaning "no sliding window"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | audio | ssm | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention variants ---------------------------------------------
    # per-layer sliding window; FULL_ATTENTION (0) = full causal attention.
    # `window_pattern` is tiled across layers (len divides or is cycled).
    window_pattern: Tuple[int, ...] = (FULL_ATTENTION,)
    attn_logit_softcap: float = 0.0  # 0 = disabled
    final_logit_softcap: float = 0.0
    use_post_norms: bool = False  # gemma2 sandwich norms
    mlp_act: str = "silu"  # silu | gelu (gated); whisper uses its own fc stack
    qkv_bias: bool = False
    vision_dim: int = 0  # VLM: dim of precomputed patch embeddings
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True

    # --- MoE --------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) ------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid (recurrentgemma) --------------------------------------------
    # block kinds, tiled over depth: "R" = RG-LRU recurrent, "A" = local attn.
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    local_window: int = 2048

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # --- VLM (llava) ----------------------------------------------------------
    num_image_tokens: int = 0  # image patch embeds prepended (frontend stub)

    # --- numerics ---------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # ----------------------------------------------------------------------
    def layer_windows(self, seq_len: int) -> Tuple[int, ...]:
        """Per-layer effective window sizes (seq_len where full attention)."""
        pat = self.window_pattern
        out = []
        for i in range(self.num_layers):
            w = pat[i % len(pat)]
            out.append(seq_len if w == FULL_ATTENTION else min(w, seq_len))
        return tuple(out)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if context cost is bounded (windowed / recurrent) per layer.

        gemma2 counts: its global layers are full attention, but the assigned
        long-context cell is run for it anyway (see DESIGN.md §4) because the
        alternating local pattern bounds half of the KV footprint; we flag only
        *pure* full-attention stacks as non-sub-quadratic.
        """
        if self.family in ("ssm", "hybrid"):
            return True
        if self.family in ("audio",):
            return False
        return all(w != FULL_ATTENTION for w in self.window_pattern)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=max(2, min(4, self.num_layers)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(4, self.num_experts),
            experts_per_token=min(2, self.experts_per_token) if self.experts_per_token else 0,
            # drop-free capacity at smoke scale so decode == forward exactly
            capacity_factor=float(min(4, self.num_experts)) if self.num_experts else self.capacity_factor,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=8,
            ssm_chunk=16,
            lru_width=64 if self.lru_width else 0,
            local_window=16 if self.block_pattern else 2048,
            window_pattern=tuple(
                (0 if w == FULL_ATTENTION else 16) for w in self.window_pattern
            ),
            num_encoder_layers=2 if self.is_encoder_decoder else 0,
            num_image_tokens=8 if self.num_image_tokens else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs for which long_500k runs (sub-quadratic / windowed context paths);
# skips documented in DESIGN.md §4.
LONG_CONTEXT_ARCHS = frozenset(
    {"mamba2-2.7b", "recurrentgemma-2b", "h2o-danube-1.8b", "gemma2-9b"}
)


def cell_is_runnable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True
