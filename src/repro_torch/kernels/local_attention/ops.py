"""Entry point of the local_attention kernel: causal sliding-window GQA
attention over the model's (B,S,H,h) / (B,S,Kh,h) layout.

The counterpart of ``repro.kernels.local_attention.ops.local_attention``.
The reference wrapper flattens heads into the batch and picks tile sizes
that divide S; the CUDA kernel takes the model's layout as it is and any
S (a ragged last tile is masked) and any window (one of S or more is
fully causal), so this wrapper only checks shapes. The kernel or its plain version follows the
tensors' device (``kernel.local_attention_cuda``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.local_attention import kernel as K


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, softcap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,h), k/v (B,S,Kh,h) -> (B,S,H,h) in q's dtype: query i
    attends to keys j with 0 <= i - j < window; logits are scaled by
    h**-0.5 and, when ``softcap`` > 0, capped with softcap*tanh(s/softcap)."""
    B, S, H, h = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != h:
        raise ValueError(f"local_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"local_attention: {H} query heads over "
                         f"{k.shape[2]} KV heads")
    if window <= 0:
        raise ValueError(f"local_attention: window {window}")
    return K.local_attention_cuda(q, k, v, window=window,
                                  softcap=softcap)
