"""dbrx-132b [moe] — 16-expert top-4 fine-grained MoE.

[hf:databricks/dbrx-base; unverified] 40L d_model=6144 48H (GQA kv=8)
d_ff=10752 (expert) vocab=100352, MoE 16e top-4, head_dim=128.
"""
from repro_torch.configs.base import FULL_ATTENTION, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    window_pattern=(FULL_ATTENTION,),
    num_experts=16,
    experts_per_token=4,
    rope_theta=500_000.0,
    tie_embeddings=False,
)
