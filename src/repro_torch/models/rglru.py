"""RecurrentGemma, hybrid family: RG-LRU recurrent blocks and local attention
in the pattern (R,R,A): the training forward, prefill and decode_step.

The counterpart of ``repro.models.rglru``. Parameters keep the reference's
per-kind stacks (``rec`` one entry per R layer, ``att`` one per A layer,
``mlp`` one per layer), so a converted tree drops in leaf for leaf; depth
is a Python loop over the layers in pattern order instead of a scan over
(R,R,A) groups. The cache is ``rec_state`` (n_rec,B,R) and ``rec_conv``
(n_rec,B,K-1,R), both float32, and the attention layers' ring ``att``
{k,v} (n_att,B,C,Kh,h) with C = min(local_window, max_seq).

Numerics that differ from the reference only in rounding order:

* the causal depthwise convolution (``conv_general_dilated`` with one
  group per channel) is an explicit sum over the K taps, in float32,
  rounded once to the compute dtype;
* the prefill recurrence h_t = a_t h_{t-1} + g_t (the reference's
  ``associative_scan``) is a Hillis-Steele scan: ceil(log2 S) steps of
  whole-sequence tensor ops, not a loop over tokens;
* the prefill attention goes through ``kernels.local_attention`` (the
  CUDA kernel on the card, its plain version on the CPU); the training
  forward's is the plain ``models.attention``, as the reference's is
  (the kernel has no backward).

The training forward runs the reference's groups: each (R,R,A) group of
three layers (two recurrent blocks and one attention block, each with
its MLP) is one remat unit, and the ``num_layers % 3`` tail layers (R
blocks) run after the groups, outside any.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
# the submodule, not the package's name: the kernel's plain version
# imports models.attention, so the two packages import each other
from repro_torch.kernels.local_attention import ops as local_ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamDesc, embed_descs, embed_tokens,
                                       layer_at, mlp_apply, mlp_descs,
                                       no_constrain, remat_wrap, rms_norm,
                                       unembed, unstack)

_C_GATE = 8.0  # RG-LRU "c" constant


def layer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(R layers, A layers) of the pattern tiled over the depth."""
    L = cfg.num_layers
    plen = len(cfg.block_pattern)
    n_rec = sum(cfg.block_pattern[i % plen] == "R" for i in range(L))
    return n_rec, L - n_rec


def rec_descs(cfg: ModelConfig, n: int) -> Dict[str, ParamDesc]:
    D, R, K = cfg.d_model, cfg.lru_width, cfg.ssm_conv_width
    return {
        "ln": ParamDesc((n, D), ("layers", "norm_scale")),
        "wy": ParamDesc((n, D, R), ("layers", "embed", "mlp")),
        "wx": ParamDesc((n, D, R), ("layers", "embed", "mlp")),
        "conv_w": ParamDesc((n, K, R), ("layers", "conv", "mlp")),
        "conv_b": ParamDesc((n, R), ("layers", "bias")),
        "wr": ParamDesc((n, R, R), ("layers", "mlp", "rnn_gate")),
        "wi": ParamDesc((n, R, R), ("layers", "mlp", "rnn_gate")),
        "lam": ParamDesc((n, R), ("layers", "norm_scale")),
        "out": ParamDesc((n, R, D), ("layers", "mlp", "embed")),
    }


def descs(cfg: ModelConfig) -> Dict[str, Any]:
    n_rec, n_att = layer_counts(cfg)
    L, D = cfg.num_layers, cfg.d_model
    att = attn.attn_descs(cfg, n_att)
    att["ln"] = ParamDesc((n_att, D), ("layers", "norm_scale"))
    return {
        "embed": embed_descs(cfg),
        "rec": rec_descs(cfg, n_rec),
        "att": att,
        "mlp": {**mlp_descs(cfg, L),
                "ln": ParamDesc((L, D), ("layers", "norm_scale"))},
        "final_norm": ParamDesc((D,), ("norm_scale",)),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
               device) -> Dict[str, Any]:
    n_rec, n_att = layer_counts(cfg)
    R, K = cfg.lru_width, cfg.ssm_conv_width
    C = min(cfg.local_window, max_seq)
    kv = (n_att, batch, C, cfg.num_kv_heads, cfg.head_dim)
    return {
        "rec_state": torch.zeros((n_rec, batch, R), dtype=torch.float32,
                                 device=device),
        "rec_conv": torch.zeros((n_rec, batch, K - 1, R),
                                dtype=torch.float32, device=device),
        "att": {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device)},
    }


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Axes of each leaf of ``init_cache``'s tree."""
    kv = attn.KV_AXES
    return {"rec_state": ("layers", "batch", "mlp"),
            "rec_conv": ("layers", "batch", None, "mlp"),
            "att": {"k": kv, "v": kv}}


def _rglru_gates(lp, u: torch.Tensor):
    r = torch.sigmoid((u @ lp["wr"]).float())
    i = torch.sigmoid((u @ lp["wi"]).float())
    log_a = -_C_GATE * F.softplus(lp["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)
                       ) * (i * u.float())
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, as a
    Hillis-Steele scan of the pairs (a, b) under
    (a1,b1),(a2,b2) -> (a2 a1, a2 b1 + b2): ceil(log2 S) steps."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rec_block(lp, h: torch.Tensor, cfg: ModelConfig, state=None,
              conv_state=None):
    """RG-LRU temporal-mix block. Prefill when ``state`` is None; decode
    takes ``state`` (B,R) f32 and ``conv_state`` (B,K-1,R). Returns
    (h, new state (B,R) f32, new conv state (B,K-1,R) f32)."""
    dtype = h.dtype
    x = rms_norm(h, lp["ln"], cfg.norm_eps)
    y = F.gelu((x @ lp["wy"]).float(), approximate="tanh").to(dtype)
    u = x @ lp["wx"]
    w = lp["conv_w"].float()
    K = w.shape[0]
    if conv_state is None:
        S = u.shape[1]
        win = F.pad(u.float(), (0, 0, K - 1, 0))
        conv = sum(win[:, k:k + S] * w[k] for k in range(K))
        new_conv = win[:, S:]
    else:
        win = torch.cat([conv_state.to(dtype).float(), u.float()], dim=1)
        conv = sum(win[:, k:k + 1] * w[k] for k in range(K))
        new_conv = win[:, 1:]
    conv = conv.to(dtype) + lp["conv_b"]
    a, gated = _rglru_gates(lp, conv)
    if state is None:
        hseq = linear_scan(a, gated)
        new_state = hseq[:, -1]
    else:
        new_state = a[:, 0] * state + gated[:, 0]
        hseq = new_state[:, None]
    out = (hseq.to(dtype) * y) @ lp["out"]
    return h + out, new_state, new_conv


def att_block(lp, h: torch.Tensor, cfg: ModelConfig, positions,
              cache=None, pos=None):
    """Local-attention block. Prefill (``cache`` None) returns the layer's
    (k, v) over the prompt; decode writes the ring and returns it."""
    x = rms_norm(h, lp["ln"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp, x, cfg, positions)
    if cache is None:
        a = local_ops.local_attention(q, k, v, window=cfg.local_window,
                                      softcap=0.0)
    else:
        k, v = attn.cache_update(cache[0], cache[1], k, v, pos)
        a = attn.decode_attention(q, k, v, pos, window=cfg.local_window,
                                  softcap_val=0.0)
    return h + attn.out_project(lp, a), k, v


def _mlp_block(lp, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return h + mlp_apply(lp, rms_norm(h, lp["ln"], cfg.norm_eps),
                         cfg.mlp_act)


def hidden_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                   remat=True, constrain=no_constrain):
    """The training forward: (final-norm hidden states (B,S,D), {})."""
    plen = len(cfg.block_pattern)
    n_g, tail = divmod(cfg.num_layers, plen)
    h = constrain(embed_tokens(params["embed"], tokens, cfg),
                  ("batch", None, None))
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    rec, att, mlp = (unstack(params[k]) for k in ("rec", "att", "mlp"))

    def att_train(lp, h):
        x = rms_norm(h, lp["ln"], cfg.norm_eps)
        q, k, v = attn.qkv_project(lp, x, cfg, positions)
        a = attn.attention(q, k, v, window=cfg.local_window,
                           softcap_val=0.0, positions=positions)
        return h + attn.out_project(lp, a)

    def group(h, g: int):
        for s in range(2):
            h = rec_block(rec[2 * g + s], h, cfg)[0]
            h = _mlp_block(mlp[3 * g + s], h, cfg)
        h = _mlp_block(mlp[3 * g + 2], att_train(att[g], h), cfg)
        return constrain(h, ("batch", None, None))

    body = remat_wrap(group, remat)
    for g in range(n_g):
        h = body(h, g)
    for t in range(tail):
        h = rec_block(rec[2 * n_g + t], h, cfg)[0]
        h = _mlp_block(mlp[3 * n_g + t], h, cfg)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), {}


def _run_serving(params, h, cfg: ModelConfig, positions, cache, pos,
                 capacity: int):
    """The layer sweep shared by prefill (``cache`` None: collect the new
    cache, the ring filled from the prompt) and decode."""
    plen = len(cfg.block_pattern)
    states, convs, ks, vs = [], [], [], []
    i_rec = i_att = 0
    for l in range(cfg.num_layers):
        if cfg.block_pattern[l % plen] == "R":
            st = cv = None
            if cache is not None:
                st = cache["rec_state"][i_rec]
                cv = cache["rec_conv"][i_rec]
            h, st, cv = rec_block(layer_at(params["rec"], i_rec), h, cfg,
                                  state=st, conv_state=cv)
            states.append(st)
            convs.append(cv)
            i_rec += 1
        else:
            ring = None
            if cache is not None:
                ring = (cache["att"]["k"][i_att], cache["att"]["v"][i_att])
            h, k, v = att_block(layer_at(params["att"], i_att), h, cfg,
                                positions, cache=ring, pos=pos)
            if cache is None:
                k, v = attn.prefill_cache(k, v, capacity)
            ks.append(k)
            vs.append(v)
            i_att += 1
        h = _mlp_block(layer_at(params["mlp"], l), h, cfg)
    new_cache = {"rec_state": torch.stack(states),
                 "rec_conv": torch.stack(convs),
                 "att": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    return h, new_cache


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_seq: int
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt (B,S): (last-token logits (B,V) f32, cache)."""
    h = embed_tokens(params["embed"], tokens, cfg)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    h, cache = _run_serving(params, h, cfg, positions, None, None,
                            min(cfg.local_window, max_seq))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], h[:, -1:, :], cfg)[:, 0], cache


def decode_step(params, token: torch.Tensor, cache: Dict[str, Any],
                pos: torch.Tensor, cfg: ModelConfig, max_seq: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token (B,) int64; pos (B,) int64 position of the
    new token. Returns (logits (B,V) f32, new cache)."""
    h = embed_tokens(params["embed"], token[:, None], cfg)
    h, new_cache = _run_serving(params, h, cfg, pos[:, None], cache, pos,
                                min(cfg.local_window, max_seq))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], h, cfg)[:, 0], new_cache
