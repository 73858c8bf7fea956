"""whisper-large-v3 [audio] — encoder-decoder transformer backbone.

[arXiv:2212.04356; unverified] 32L (each side) d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866, head_dim=64. The conv/mel frontend is a STUB:
``input_specs()`` supplies precomputed frame embeddings (B, S, d_model).
"""
from repro_torch.configs.base import FULL_ATTENTION, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,           # decoder layers
    num_encoder_layers=32,   # encoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    window_pattern=(FULL_ATTENTION,),
    is_encoder_decoder=True,
    rope_theta=0.0,  # learned absolute positions, not rope
    tie_embeddings=True,
)
