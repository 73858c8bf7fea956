"""llava-next-mistral-7b [vlm] — mistral-7b backbone + anyres image tiles (stub).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000, head_dim=128. The vision tower / anyres
tiling frontend is a STUB: ``input_specs()`` supplies precomputed, projected
patch embeddings (B, num_image_tokens, d_model) = 5 tiles x 576 patches.
"""
from repro_torch.configs.base import FULL_ATTENTION, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    window_pattern=(FULL_ATTENTION,),
    num_image_tokens=2880,
    vision_dim=1024,  # anyres: 5 tiles (1 base + 2x2 grid) x 24x24 patches
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)
