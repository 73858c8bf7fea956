"""recurrentgemma-2b [hybrid] — RG-LRU recurrent blocks + local attention, 2:1.

[arXiv:2402.19427; hf] 26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000,
head_dim=256, lru_width=2560, local attention window 2048, pattern (R,R,A).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("R", "R", "A"),  # tiled over 26 layers
    lru_width=2560,
    local_window=2048,
    mlp_act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
