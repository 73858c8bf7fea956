"""Attention: GQA, per-layer windows, logit softcap, QKV bias, causal or
full (whisper's encoder and cross-attention), plain torch ops (the JAX
package's attention is plain jnp too).

Layouts follow the JAX package: q (B,S,H,h), k/v (B,S,K,h); a layer's
ring cache is (B,C,K,h), slot ``i`` holding absolute position
``i + C*floor((pos-i)/C)`` (negative = not yet written).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ModelAxis, ParamDesc, rope, softcap

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


def qkv_project(p, x, cfg: ModelConfig, positions,
                axis: Optional[ModelAxis] = None):
    """x: (B,S,D) -> q (B,S,H,h), k/v (B,S,K,h), rope applied. Over a
    ``ModelAxis`` that cuts the heads, q holds this rank's H/M heads and
    k/v the kv heads they meet (``local_kv``); ``wk``, ``wv`` and their
    biases are whole on every rank and enter, as x does, through
    ``CopyToModel``, so their gradients arrive whole."""
    B, S, D = x.shape
    kv = {n: p[n] for n in ("wk", "wv", "bk", "bv") if n in p}
    cut = axis is not None and axis.heads
    if cut:
        x = axis.copy_in(x)
        kv = {n: axis.copy_in(w) for n, w in kv.items()}
    H, K = p["wq"].shape[-2], kv["wk"].shape[-2]
    q = (x @ p["wq"].reshape(D, -1)).reshape(B, S, H, -1)
    k = (x @ kv["wk"].reshape(D, -1)).reshape(B, S, K, -1)
    v = (x @ kv["wv"].reshape(D, -1)).reshape(B, S, K, -1)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + kv["bk"]
        v = v + kv["bv"]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cut:
        k, v = local_kv(k, v, cfg, axis.index * H, H)
    return q, k, v


def local_kv(k, v, cfg: ModelConfig, q0: int, n_q: int):
    """The kv heads (B,S,K,h) that query heads ``[q0, q0 + n_q)`` meet:
    global query head i meets kv head i // (H / K). Where each kv head
    meets an equal run of them (whole groups, or one kv head shared by
    several ranks), its contiguous kv heads (all of k and v where they
    meet every kv head); else one kv head per query head, gathered."""
    G = cfg.num_heads // cfg.num_kv_heads
    idx = [(q0 + j) // G for j in range(n_q)]
    first, n = idx[0], idx[-1] - idx[0] + 1
    if n == k.shape[2]:
        return k, v
    if n_q % n == 0 and idx == [first + j // (n_q // n)
                                for j in range(n_q)]:
        return k.narrow(2, first, n), v.narrow(2, first, n)
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def out_project(p, a: torch.Tensor, axis: Optional[ModelAxis] = None
                ) -> torch.Tensor:
    """(B,S,H,h) -> (B,S,D) through wo (H,h,D); row-parallel over a
    ``ModelAxis`` that cuts the heads."""
    B, S, H, h = a.shape
    out = a.reshape(B, S, H * h) @ p["wo"].reshape(H * h, -1)
    return axis.reduce_out(out) if axis is not None and axis.heads else out


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
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              k_positions: Optional[torch.Tensor] = None,
              q_chunk: int = 1024) -> torch.Tensor:
    """Exact attention of q (B,S,H,h) over k/v (B,T,K,h), ``q_chunk``
    query rows at a time (each row's softmax is whole, so the chunking
    bounds the live logits to (B,K,G,q_chunk,T) without changing a row).
    Causal: key j is visible to query i iff 0 <= q_pos_i - k_pos_j <
    window (``k_positions`` defaults to ``positions``). Not causal (the
    encoder, cross-attention): every key is visible and the positions
    and window are unused."""
    S = q.shape[1]
    scale = q.shape[-1] ** -0.5
    if causal and k_positions is None:
        k_positions = positions
    outs = []
    for c0 in range(0, S, q_chunk):
        mask = None
        if causal:
            d = (positions[:, c0:c0 + q_chunk, None]
                 - k_positions[:, None, :])
            mask = (d >= 0) & (d < window)
        outs.append(sdpa_block(q[:, c0:c0 + q_chunk], k, v, mask, scale,
                               softcap_val))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


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
