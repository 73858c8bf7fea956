"""Decoder-only transformer LM, dense and MoE families: the training
forward (``hidden_forward``, ``logits_fn``), prefill and decode_step.

The counterpart of ``repro.models.transformer``. With
``cfg.num_experts`` each layer's FFN is the mixture of experts
(``repro_torch.models.moe``): training sums its ``lb_loss`` over the
layers, serving discards its aux values, as the reference does;
otherwise the gated MLP. A group of ``len(window_pattern)`` layers is
one remat unit of the training forward. Layer
``l`` uses window ``window_pattern[l % P]`` and the cache leaf
``slot{l % P}`` at group index ``l // P``; cache leaves are
(n_groups, B, C, K, h) as in the JAX package. Depth is a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ModelAxis, ParamDesc, embed_descs,
                                       embed_tokens, layer_at, mlp_apply,
                                       mlp_descs, no_constrain, no_gather,
                                       remat_wrap, rms_norm, unembed, unstack)


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
    }
    if cfg.num_experts:
        layer["moe"] = moe_mod.moe_descs(cfg, L)
    else:
        layer["mlp"] = mlp_descs(cfg, L)
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


def _ffn(lp, x: torch.Tensor, cfg: ModelConfig, moe_group=None,
         axis: Optional[ModelAxis] = None):
    """(FFN output, the MoE aux or None)."""
    if cfg.num_experts:
        return moe_mod.moe_apply(lp["moe"], x, cfg, moe_group)
    return mlp_apply(lp["mlp"], x, cfg.mlp_act, axis), None


def _block(h, lp, cfg: ModelConfig, attend, constrain=no_constrain,
           moe_group=None, axis: Optional[ModelAxis] = None):
    """One pre-norm (optionally sandwich-norm) layer; ``attend(x)``
    returns (attention output, k, v to cache). Returns (h, k, v, the
    FFN's aux or None). ``axis``: the attention's output projection and
    the MLP run tensor parallel over it where its rules cut them."""
    eps = cfg.norm_eps
    a, k, v = attend(rms_norm(h, lp["ln_attn"], eps))
    a = attn.out_project(lp["attn"], a, axis)
    if cfg.use_post_norms:
        a = rms_norm(a, lp["ln_post_attn"], eps)
    h = constrain(h + a, ("batch", None, None))
    m, aux = _ffn(lp, rms_norm(h, lp["ln_mlp"], eps), cfg, moe_group, axis)
    if cfg.use_post_norms:
        m = rms_norm(m, lp["ln_post_mlp"], eps)
    return constrain(h + m, ("batch", None, None)), k, v, aux


def hidden_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                   extra_embeds: Optional[torch.Tensor] = None, remat=True,
                   constrain=no_constrain, gather=no_gather, moe_group=None,
                   model_axis: Optional[ModelAxis] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training forward over the whole sequence: (final-norm hidden
    states (B, S_total, D), {"lb_loss": the MoE load-balancing losses
    summed over the layers in float32, 0 for a dense model; with experts
    also "dropped", the assignments over capacity summed likewise}).
    ``extra_embeds`` (B,N,D) go ahead of the token embeddings.
    ``gather(name, subtree)`` makes data-sharded leaves whole: ``embed``
    and ``final_norm`` around the stack, each layer's leaves inside its
    remat unit, so the recompute gathers them again. ``moe_group`` (a
    ``moe.TokenGroup``) dispatches each MoE layer over the group's rows;
    its count all-gather sits in the remat unit too. ``model_axis`` (a
    ``layers.ModelAxis``, the dense family): the embedding, attention
    and MLP run tensor parallel over it, each layer's collectives inside
    its remat unit, so the recompute issues them again in the same
    order on every rank."""
    h = embed_tokens(gather("embed", params["embed"]), tokens, cfg,
                     model_axis)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    B, S, _ = h.shape
    h = constrain(h, ("batch", None, None))
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    n_g, plen = _groups(cfg)
    windows = [min(w if w > 0 else S, S) for w in cfg.window_pattern]
    layers = unstack(params["layers"])

    def group_body(h, lb, dropped, g: int):
        for s in range(plen):
            lp = gather("layers", layers[g * plen + s])

            def attend(x, lp=lp, w=windows[s]):
                q, k, v = attn.qkv_project(lp["attn"], x, cfg, positions,
                                           model_axis)
                q = constrain(q, ("batch", None, "heads", None))
                return attn.attention(q, k, v, window=w,
                                      softcap_val=cfg.attn_logit_softcap,
                                      positions=positions), k, v

            h, _, _, aux = _block(h, lp, cfg, attend, constrain, moe_group,
                                  model_axis)
            if aux is not None:
                lb = lb + aux["lb_loss"]
                dropped = dropped + aux["dropped"]
        return h, lb, dropped

    body = remat_wrap(group_body, remat)
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    dropped = torch.zeros((), dtype=torch.int64, device=h.device)
    for g in range(n_g):
        h, lb, dropped = body(h, lb, dropped, g)
    aux = {"lb_loss": lb}
    if cfg.num_experts:
        aux["dropped"] = dropped
    return (rms_norm(h, gather("final_norm", params["final_norm"]),
                     cfg.norm_eps), aux)


def logits_fn(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return unembed(params["embed"], h, cfg)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_seq: int,
            *, extra_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt (B,S): (last-token logits (B,V) f32, ring caches).
    ``extra_embeds`` (B,N,D) (the vlm's projected image) go ahead of the
    token embeddings; positions run over the whole sequence."""
    h = embed_tokens(params["embed"], tokens, cfg)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    n_g, plen = _groups(cfg)
    spec = cache_spec(cfg, max_seq)
    ks: Dict[str, list] = {name: [] for name in spec}
    vs: Dict[str, list] = {name: [] for name in spec}
    for l in range(cfg.num_layers):
        s = l % plen
        w = cfg.window_pattern[s]
        lp = layer_at(params["layers"], l)

        def attend(x, lp=lp, w=w):
            q, k, v = attn.qkv_project(lp["attn"], x, cfg, positions)
            a = attn.attention(q, k, v, window=min(w if w > 0 else S, S),
                               softcap_val=cfg.attn_logit_softcap,
                               positions=positions)
            return a, k, v

        h, k, v, _ = _block(h, lp, cfg, attend)
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
        lp = layer_at(params["layers"], l)

        def attend(x, lp=lp, g=g, name=name, window=window):
            q, k, v = attn.qkv_project(lp["attn"], x, cfg, positions)
            ck, cv = attn.cache_update(caches[name]["k"][g],
                                       caches[name]["v"][g], k, v, pos)
            a = attn.decode_attention(q, ck, cv, pos, window=window,
                                      softcap_val=cfg.attn_logit_softcap)
            return a, ck, cv

        h, ck, cv, _ = _block(h, lp, cfg, attend)
        ks[name].append(ck)
        vs[name].append(cv)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg)[:, 0]
    return logits, {name: {"k": torch.stack(ks[name]),
                           "v": torch.stack(vs[name])} for name in spec}
