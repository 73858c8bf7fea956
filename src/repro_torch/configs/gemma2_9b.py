"""gemma2-9b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf] 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000,
head_dim=256, sliding window 4096 on local layers, attn softcap 50, final 30.
"""
from repro_torch.configs.base import FULL_ATTENTION, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    window_pattern=(4096, FULL_ATTENTION),  # local, global alternating
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norms=True,
    mlp_act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
