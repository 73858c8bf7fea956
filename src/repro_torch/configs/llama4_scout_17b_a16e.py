"""llama4-scout-17b-a16e [moe] — 16-expert top-1 MoE (early-fusion backbone).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (expert) vocab=202048, MoE 16e top-1, head_dim=128.
"""
from repro_torch.configs.base import FULL_ATTENTION, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    window_pattern=(FULL_ATTENTION,),
    num_experts=16,
    experts_per_token=1,
    rope_theta=500_000.0,
    tie_embeddings=False,
)
