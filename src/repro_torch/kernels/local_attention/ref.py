"""Plain-PyTorch version of the local_attention kernel: the port's exact
attention (``repro_torch.models.attention.attention``) with a window and a
softcap, as the reference's oracle is its framework attention.

It differs from the kernel in rounding only: it takes the softmax over the
whole row at once, and for bfloat16 inputs rounds the probabilities to
bfloat16 before the weighted sum (the kernel keeps them in float32)."""
from __future__ import annotations

import torch

from repro_torch.models.attention import attention


def local_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int, softcap: float = 0.0
                        ) -> torch.Tensor:
    """q (B,S,H,h), k/v (B,S,Kh,h) -> (B,S,H,h): query i sees keys j with
    0 <= i - j < window."""
    B, S = q.shape[:2]
    positions = torch.arange(S, device=q.device)[None, :].expand(B, S)
    return attention(q, k, v, window=window, softcap_val=softcap,
                     positions=positions)
