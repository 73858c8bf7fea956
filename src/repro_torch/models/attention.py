"""Attention for the dense family: GQA, per-layer windows, logit softcap,
QKV bias, plain torch ops (the JAX package's attention is plain jnp too).

Layouts follow the JAX package: q (B,S,H,h), k/v (B,S,K,h); a layer's
ring cache is (B,C,K,h), slot ``i`` holding absolute position
``i + C*floor((pos-i)/C)`` (negative = not yet written).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDesc, rope, softcap

NEG_INF = -2.0e38
#: axes of a K or V cache leaf (n_layers, B, C, Kh, h)
KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")


def attn_descs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDesc]:
    L, D, H, K, h = (layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim)
    d = {
        "wq": ParamDesc((L, D, H, h), ("layers", "embed", "heads",
                                       "head_dim")),
        "wk": ParamDesc((L, D, K, h), ("layers", "embed", "kv_heads",
                                       "head_dim")),
        "wv": ParamDesc((L, D, K, h), ("layers", "embed", "kv_heads",
                                       "head_dim")),
        "wo": ParamDesc((L, H, h, D), ("layers", "heads", "head_dim",
                                       "embed")),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDesc((L, H, h), ("layers", "heads", "bias"))
        d["bk"] = ParamDesc((L, K, h), ("layers", "kv_heads", "bias"))
        d["bv"] = ParamDesc((L, K, h), ("layers", "kv_heads", "bias"))
    return d


def qkv_project(p, x, cfg: ModelConfig, positions):
    """x: (B,S,D) -> q (B,S,H,h), k/v (B,S,K,h), rope applied."""
    B, S, D = x.shape
    q = (x @ p["wq"].reshape(D, -1)).reshape(B, S, cfg.num_heads, -1)
    k = (x @ p["wk"].reshape(D, -1)).reshape(B, S, cfg.num_kv_heads, -1)
    v = (x @ p["wv"].reshape(D, -1)).reshape(B, S, cfg.num_kv_heads, -1)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def out_project(p, a: torch.Tensor) -> torch.Tensor:
    """(B,S,H,h) -> (B,S,D) through wo (H,h,D)."""
    B, S, H, h = a.shape
    return a.reshape(B, S, H * h) @ p["wo"].reshape(H * h, -1)


def sdpa_block(q, k, v, mask: Optional[torch.Tensor], scale: float,
               cap: float) -> torch.Tensor:
    """q (B,Q,H,h) grouped against k/v (B,T,K,h); mask (B,Q,T) or None.
    Logits and softmax in float32, the weighted sum in the input dtype."""
    B, Q, H, h = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Q, K, G, h)
    logits = torch.einsum("bqkgh,btkh->bkgqt", qg.float(), k.float()) * scale
    logits = softcap(logits, cap)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,btkh->bqkgh", probs, v)
    return out.reshape(B, Q, H, h)


def attention(q, k, v, *, window: int, softcap_val: float,
              positions: torch.Tensor) -> torch.Tensor:
    """Causal windowed self-attention over one sequence: key j is visible
    to query i iff 0 <= i - j < window."""
    d = positions[:, :, None] - positions[:, None, :]
    mask = (d >= 0) & (d < window)
    return sdpa_block(q, k, v, mask, q.shape[-1] ** -0.5, softcap_val)


def cache_capacity(window: int, max_seq: int) -> int:
    return min(window, max_seq) if window > 0 else max_seq


def ring_positions(capacity: int, pos: torch.Tensor) -> torch.Tensor:
    """(B,) positions -> (B, C) absolute position held by each ring slot."""
    i = torch.arange(capacity, device=pos.device)
    p = pos[:, None]
    return i + capacity * torch.div(p - i, capacity, rounding_mode="floor")


def cache_update(cache_k, cache_v, k_new, v_new, pos: torch.Tensor):
    """Write one token (B,1,K,h) at ring slot pos % C per row (B,)."""
    C = cache_k.shape[1]
    hit = ((pos % C)[:, None] == torch.arange(C, device=pos.device)
           )[:, :, None, None]
    return (torch.where(hit, k_new, cache_k),
            torch.where(hit, v_new, cache_v))


def decode_attention(q, cache_k, cache_v, pos: torch.Tensor, *, window: int,
                     softcap_val: float) -> torch.Tensor:
    C = cache_k.shape[1]
    kp = ring_positions(C, pos)
    d = pos[:, None] - kp
    mask = (kp >= 0) & (d >= 0) & (d < window)
    mask = mask[:, None, :].expand(q.shape[0], q.shape[1], C)
    return sdpa_block(q, cache_k, cache_v, mask, q.shape[-1] ** -0.5,
                      softcap_val)


def prefill_cache(k: torch.Tensor, v: torch.Tensor, capacity: int):
    """Ring cache from prefill K/V (B,S,K,h): the last ``capacity``
    positions, each at its ring slot."""
    B, S, K, h = k.shape
    if S <= capacity:
        pad = (0, 0, 0, 0, 0, capacity - S)
        return (torch.nn.functional.pad(k, pad),
                torch.nn.functional.pad(v, pad))
    shift = (S - capacity) % capacity
    return (torch.roll(k[:, S - capacity:], shifts=shift, dims=1),
            torch.roll(v[:, S - capacity:], shifts=shift, dims=1))
