"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; unverified] 64L d_model=2560 vocab=50280, ssm_state=128,
expand=2 (d_inner=5120), headdim=64 -> 80 heads, causal conv width 4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,       # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,            # mamba2 block has no separate FFN
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv_width=4,
    tie_embeddings=True,
)
