"""Whisper-large-v3 backbone, audio family: encoder-decoder transformer:
the training forward (``encode``, ``decode_train``, ``hidden_forward``;
one layer a remat unit on each side), prefill and decode_step.

The counterpart of ``repro.models.whisper``. As in the reference the
conv/mel frontend is a stub: the batch carries precomputed frame
embeddings ``frames`` (B, S_enc, d_model). LayerNorm with the reference's
``1 + scale`` convention and a bias, non-gated tanh-GELU MLPs, sinusoidal
positions on both sides. Parameters keep the reference's nested tree
(``encoder``, ``decoder`` with ``self`` and ``cross`` attention stacks).

The cache is ``self`` {k, v} (L,B,max_seq,K,h), the decoder's ring, and
``cross`` {k, v} (L,B,T_enc,K,h), computed once at prefill from the
encoder's output and carried unchanged through decode (the reference
calls it the high-value approximate-store target). ``init_cache`` sizes
the cross cache at ``enc_len`` 1500, whisper's 30-second window, as the
reference does; a prefill's cross cache is as long as its frames.

``logits_fn`` takes the product of the compute-dtype operands in
float32 (the reference's ``preferred_element_type``): both are upcast,
so a bfloat16 model's logits are not rounded to bfloat16.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamDesc, layer_at, no_constrain,
                                       no_gather, remat_wrap, sinusoid_at,
                                       sinusoid_positions, unstack)

#: the pool's cross-cache length: whisper's 30-second window of frames
ENC_LEN = 1500


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mu).mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float()) + bias.float()).to(x.dtype)


def _fc_descs(cfg: ModelConfig, n: int) -> Dict[str, ParamDesc]:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "fc1": ParamDesc((n, D, Fd), ("layers", "embed", "mlp")),
        "fc1_b": ParamDesc((n, Fd), ("layers", "bias")),
        "fc2": ParamDesc((n, Fd, D), ("layers", "mlp", "embed")),
        "fc2_b": ParamDesc((n, D), ("layers", "bias")),
    }


def _ln_descs(cfg: ModelConfig, n: int, name: str) -> Dict[str, ParamDesc]:
    D = cfg.d_model
    return {f"{name}_s": ParamDesc((n, D), ("layers", "norm_scale")),
            f"{name}_b": ParamDesc((n, D), ("layers", "bias"))}


def descs(cfg: ModelConfig) -> Dict[str, Any]:
    Le, Ld, D = cfg.num_encoder_layers, cfg.num_layers, cfg.d_model
    enc = {"self": attn.attn_descs(cfg, Le), **_fc_descs(cfg, Le),
           **_ln_descs(cfg, Le, "ln1"), **_ln_descs(cfg, Le, "ln2")}
    dec = {"self": attn.attn_descs(cfg, Ld), "cross": attn.attn_descs(cfg, Ld),
           **_fc_descs(cfg, Ld), **_ln_descs(cfg, Ld, "ln1"),
           **_ln_descs(cfg, Ld, "ln2"), **_ln_descs(cfg, Ld, "ln3")}
    return {
        # std 1/sqrt(D): unit-scale tied logits (whisper ties embeddings)
        "embed": {"embedding": ParamDesc(
            (cfg.vocab_size, D), ("vocab", "embed"),
            scale=(cfg.vocab_size / D) ** 0.5)},
        "encoder": enc,
        "decoder": dec,
        "enc_final_s": ParamDesc((D,), ("norm_scale",)),
        "enc_final_b": ParamDesc((D,), ("bias",)),
        "dec_final_s": ParamDesc((D,), ("norm_scale",)),
        "dec_final_b": ParamDesc((D,), ("bias",)),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device,
               enc_len: int = ENC_LEN) -> Dict[str, Any]:
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def kv(n):
        shape = (L, batch, n, K, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"self": kv(max_seq), "cross": kv(enc_len)}


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    kv = attn.KV_AXES
    return {"self": {"k": kv, "v": kv}, "cross": {"k": kv, "v": kv}}


def _mlp(lp, x: torch.Tensor) -> torch.Tensor:
    h = x @ lp["fc1"] + lp["fc1_b"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ lp["fc2"] + lp["fc2_b"]


def _self_attn(lp, x, cfg: ModelConfig, positions, causal: bool):
    q, k, v = attn.qkv_project(lp, x, cfg, positions)
    a = attn.attention(q, k, v, window=x.shape[1], softcap_val=0.0,
                       positions=positions, causal=causal)
    return attn.out_project(lp, a), (k, v)


def _cross_attn(lp, x: torch.Tensor, kv, cfg: ModelConfig) -> torch.Tensor:
    k, v = kv
    B, S, D = x.shape
    q = (x @ lp["wq"].reshape(D, -1)).reshape(B, S, cfg.num_heads, -1)
    if cfg.qkv_bias:
        q = q + lp["bq"]
    a = attn.attention(q, k, v, window=k.shape[1] + 1, softcap_val=0.0,
                       causal=False)
    return attn.out_project(lp, a)


def _cross_kv(lp, enc_h: torch.Tensor, cfg: ModelConfig):
    B, T, D = enc_h.shape
    K = cfg.num_kv_heads
    k = (enc_h @ lp["wk"].reshape(D, -1)).reshape(B, T, K, -1)
    v = (enc_h @ lp["wv"].reshape(D, -1)).reshape(B, T, K, -1)
    if cfg.qkv_bias:
        k = k + lp["bk"]
        v = v + lp["bv"]
    return k, v


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *, remat=False,
           constrain=no_constrain, gather=no_gather) -> torch.Tensor:
    """(B,S_enc,D) frames -> the encoder's final hidden states; each layer
    a remat unit under ``remat`` (serving runs it without), its leaves
    gathered inside it."""
    dtype = getattr(torch, cfg.compute_dtype)
    B, S, D = frames.shape
    h = frames.to(dtype) + sinusoid_positions(
        S, D, device=frames.device).to(dtype)[None]
    h = constrain(h, ("batch", None, None))
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    eps = cfg.norm_eps

    def body(h, lp):
        lp = gather("encoder", lp)
        a, _ = _self_attn(lp["self"], layer_norm(h, lp["ln1_s"], lp["ln1_b"],
                                                 eps), cfg, positions,
                          causal=False)
        h = h + a
        h = h + _mlp(lp, layer_norm(h, lp["ln2_s"], lp["ln2_b"], eps))
        return constrain(h, ("batch", None, None))

    body = remat_wrap(body, remat)
    for lp in unstack(params["encoder"]):
        h = body(h, lp)
    return layer_norm(h, gather("enc_final_s", params["enc_final_s"]),
                      gather("enc_final_b", params["enc_final_b"]), eps)


def decode_train(params, enc_h: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig, *, remat=True, constrain=no_constrain,
                 gather=no_gather) -> torch.Tensor:
    """The decoder over whole target sequences (B,S), causal self-attention
    and cross-attention to ``enc_h``: final-norm hidden states (B,S,D);
    ``gather`` as in ``encode``."""
    B, S = tokens.shape
    h = gather("embed", params["embed"])["embedding"][tokens]
    h = h + sinusoid_positions(S, cfg.d_model, device=h.device).to(
        h.dtype)[None]
    h = constrain(h, ("batch", None, None))
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)

    def body(h, lp):
        lp = gather("decoder", lp)
        kv = _cross_kv(lp["cross"], enc_h, cfg)
        h, _ = _decoder_layer(lp, h, kv, cfg, positions)
        return constrain(h, ("batch", None, None))

    body = remat_wrap(body, remat)
    for lp in unstack(params["decoder"]):
        h = body(h, lp)
    return layer_norm(h, gather("dec_final_s", params["dec_final_s"]),
                      gather("dec_final_b", params["dec_final_b"]),
                      cfg.norm_eps)


def hidden_forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   *, remat=True, constrain=no_constrain, gather=no_gather):
    """The training forward: (frames, tokens) -> (decoder hidden states,
    {}). ``gather(name, subtree)`` makes data-sharded leaves whole: the
    embedding and the final norms around the stacks, each ``encoder``
    and ``decoder`` layer inside its remat unit."""
    enc_h = encode(params, batch["frames"], cfg, remat=remat,
                   constrain=constrain, gather=gather)
    return decode_train(params, enc_h, batch["tokens"], cfg, remat=remat,
                        constrain=constrain, gather=gather), {}


def _decoder_layer(lp, h, cross_kv, cfg: ModelConfig, positions,
                   self_cache=None, pos=None):
    eps = cfg.norm_eps
    x = layer_norm(h, lp["ln1_s"], lp["ln1_b"], eps)
    if self_cache is None:
        a, new_self = _self_attn(lp["self"], x, cfg, positions, causal=True)
    else:
        q, k, v = attn.qkv_project(lp["self"], x, cfg, positions)
        ck, cv = attn.cache_update(self_cache[0], self_cache[1], k, v, pos)
        a = attn.decode_attention(q, ck, cv, pos, window=ck.shape[1],
                                  softcap_val=0.0)
        a = attn.out_project(lp["self"], a)
        new_self = (ck, cv)
    h = h + a
    h = h + _cross_attn(lp["cross"], layer_norm(h, lp["ln2_s"], lp["ln2_b"],
                                                eps), cross_kv, cfg)
    h = h + _mlp(lp, layer_norm(h, lp["ln3_s"], lp["ln3_b"], eps))
    return h, new_self


def logits_fn(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tied logits, the product taken in float32."""
    return h.float() @ params["embed"]["embedding"].float().t()


def _final(params, h, cfg: ModelConfig) -> torch.Tensor:
    return layer_norm(h, params["dec_final_s"], params["dec_final_b"],
                      cfg.norm_eps)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_seq: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Encode ``frames``, run the decoder prompt ``tokens``: (last-token
    logits (B,V) f32, cache with a cross cache as long as the frames)."""
    enc_h = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = params["embed"]["embedding"][tokens]
    h = h + sinusoid_positions(S, cfg.d_model, device=h.device).to(
        h.dtype)[None]
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    sk, sv, xk, xv = [], [], [], []
    for l in range(cfg.num_layers):
        lp = layer_at(params["decoder"], l)
        kv = _cross_kv(lp["cross"], enc_h, cfg)
        h, (k, v) = _decoder_layer(lp, h, kv, cfg, positions)
        ck, cv = attn.prefill_cache(k, v, max_seq)
        sk.append(ck)
        sv.append(cv)
        xk.append(kv[0])
        xv.append(kv[1])
    h = _final(params, h, cfg)
    cache = {"self": {"k": torch.stack(sk), "v": torch.stack(sv)},
             "cross": {"k": torch.stack(xk), "v": torch.stack(xv)}}
    return logits_fn(params, h[:, -1:, :], cfg)[:, 0], cache


def decode_step(params, token: torch.Tensor, cache: Dict[str, Any],
                pos: torch.Tensor, cfg: ModelConfig, max_seq: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token (B,) int64; pos (B,) int64: each row's
    position encoding is its own. The cross cache is carried as it is."""
    h = params["embed"]["embedding"][token[:, None]]
    h = h + sinusoid_at(pos, cfg.d_model)[:, None, :].to(h.dtype)
    positions = pos[:, None]
    sk, sv = [], []
    for l in range(cfg.num_layers):
        lp = layer_at(params["decoder"], l)
        cross = (cache["cross"]["k"][l], cache["cross"]["v"][l])
        h, (ck, cv) = _decoder_layer(
            lp, h, cross, cfg, positions,
            self_cache=(cache["self"]["k"][l], cache["self"]["v"][l]),
            pos=pos)
        sk.append(ck)
        sv.append(cv)
    h = _final(params, h, cfg)
    return logits_fn(params, h, cfg)[:, 0], {
        "self": {"k": torch.stack(sk), "v": torch.stack(sv)},
        "cross": cache["cross"]}
