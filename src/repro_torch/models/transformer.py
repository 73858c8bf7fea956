"""Decoder-only transformer LM, dense family: prefill and decode_step.

The counterpart of ``repro.models.transformer``'s serving half. Layer
``l`` uses window ``window_pattern[l % P]`` and the cache leaf
``slot{l % P}`` at group index ``l // P``; cache leaves are
(n_groups, B, C, K, h) as in the JAX package. Depth is a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamDesc, embed_descs, embed_tokens,
                                       mlp_apply, mlp_descs, rms_norm,
                                       unembed)


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    plen = len(cfg.window_pattern)
    assert cfg.num_layers % plen == 0, (cfg.name, cfg.num_layers, plen)
    return cfg.num_layers // plen, plen


def descs(cfg: ModelConfig) -> Dict[str, Any]:
    L, D = cfg.num_layers, cfg.d_model
    layer: Dict[str, Any] = {
        "attn": attn.attn_descs(cfg, L),
        "ln_attn": ParamDesc((L, D), ("layers", "norm_scale")),
        "ln_mlp": ParamDesc((L, D), ("layers", "norm_scale")),
        "mlp": mlp_descs(cfg, L),
    }
    if cfg.use_post_norms:
        layer["ln_post_attn"] = ParamDesc((L, D), ("layers", "norm_scale"))
        layer["ln_post_mlp"] = ParamDesc((L, D), ("layers", "norm_scale"))
    return {"embed": embed_descs(cfg), "layers": layer,
            "final_norm": ParamDesc((D,), ("norm_scale",))}


def cache_spec(cfg: ModelConfig, max_seq: int) -> Dict[str, Tuple[int, int]]:
    """slot name -> (capacity, window)."""
    return {f"slot{s}": (attn.cache_capacity(w, max_seq),
                         w if w > 0 else max_seq)
            for s, w in enumerate(cfg.window_pattern)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
               device) -> Dict[str, Any]:
    n_g, _ = _groups(cfg)
    out = {}
    for name, (cap, _w) in cache_spec(cfg, max_seq).items():
        shape = (n_g, batch, cap, cfg.num_kv_heads, cfg.head_dim)
        out[name] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
    return out


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Axes of each leaf of ``init_cache``'s tree."""
    kv = attn.KV_AXES
    return {name: {"k": kv, "v": kv} for name in cache_spec(cfg, 8)}


def _layer_params(layers: Dict[str, Any], l: int) -> Dict[str, Any]:
    return {k: (_layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in layers.items()}


def _block(h, lp, cfg: ModelConfig, attend):
    """One pre-norm (optionally sandwich-norm) layer; ``attend(q, k, v)``
    returns (attention output, k, v to cache)."""
    eps = cfg.norm_eps
    a, k, v = attend(rms_norm(h, lp["ln_attn"], eps))
    a = attn.out_project(lp["attn"], a)
    if cfg.use_post_norms:
        a = rms_norm(a, lp["ln_post_attn"], eps)
    h = h + a
    m = mlp_apply(lp["mlp"], rms_norm(h, lp["ln_mlp"], eps), cfg.mlp_act)
    if cfg.use_post_norms:
        m = rms_norm(m, lp["ln_post_mlp"], eps)
    return h + m, k, v


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_seq: int
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt (B,S): (last-token logits (B,V) f32, ring caches)."""
    h = embed_tokens(params["embed"], tokens, cfg)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    n_g, plen = _groups(cfg)
    spec = cache_spec(cfg, max_seq)
    ks: Dict[str, list] = {name: [] for name in spec}
    vs: Dict[str, list] = {name: [] for name in spec}
    for l in range(cfg.num_layers):
        s = l % plen
        w = cfg.window_pattern[s]
        lp = _layer_params(params["layers"], l)

        def attend(x, lp=lp, w=w):
            q, k, v = attn.qkv_project(lp["attn"], x, cfg, positions)
            a = attn.attention(q, k, v, window=min(w if w > 0 else S, S),
                               softcap_val=cfg.attn_logit_softcap,
                               positions=positions)
            return a, k, v

        h, k, v = _block(h, lp, cfg, attend)
        ck, cv = attn.prefill_cache(k, v, spec[f"slot{s}"][0])
        ks[f"slot{s}"].append(ck)
        vs[f"slot{s}"].append(cv)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], h[:, -1:, :], cfg)[:, 0]
    caches = {name: {"k": torch.stack(ks[name]), "v": torch.stack(vs[name])}
              for name in spec}
    return logits, caches


def decode_step(params, token: torch.Tensor, caches: Dict[str, Any],
                pos: torch.Tensor, cfg: ModelConfig, max_seq: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token (B,) int64; pos (B,) int64 position of the
    new token. Returns (logits (B,V) f32, new caches)."""
    h = embed_tokens(params["embed"], token[:, None], cfg)
    n_g, plen = _groups(cfg)
    spec = cache_spec(cfg, max_seq)
    positions = pos[:, None]
    ks: Dict[str, list] = {name: [] for name in spec}
    vs: Dict[str, list] = {name: [] for name in spec}
    for l in range(cfg.num_layers):
        s, g = l % plen, l // plen
        name = f"slot{s}"
        _, window = spec[name]
        lp = _layer_params(params["layers"], l)

        def attend(x, lp=lp, g=g, name=name, window=window):
            q, k, v = attn.qkv_project(lp["attn"], x, cfg, positions)
            ck, cv = attn.cache_update(caches[name]["k"][g],
                                       caches[name]["v"][g], k, v, pos)
            a = attn.decode_attention(q, ck, cv, pos, window=window,
                                      softcap_val=cfg.attn_logit_softcap)
            return a, ck, cv

        h, ck, cv = _block(h, lp, cfg, attend)
        ks[name].append(ck)
        vs[name].append(cv)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg)[:, 0]
    return logits, {name: {"k": torch.stack(ks[name]),
                           "v": torch.stack(vs[name])} for name in spec}
