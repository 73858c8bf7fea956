"""Mamba2 (SSD, state-space duality), ssm family: the training forward
(``hidden_forward``, one block a remat unit), prefill and decode_step.

The counterpart of ``repro.models.ssm``. Parameters keep the reference's
layouts (a ``layers`` stack of per-block leaves), so a converted tree drops
in leaf for leaf. Depth is a Python loop; the prefill scan over chunks of
``ssm_chunk`` tokens is a Python loop carrying the (B,H,P,N) float32 state,
each chunk computed as dense (Q x Q) and (Q x N) products. The cache is
``state`` (L,B,H,P,N) and ``conv`` (L,B,K-1,C), both float32; the serving
policy pins both EXACT, so a mamba2 engine writes no approximate bit.

Numerics that differ from the reference only in rounding order:

* the causal depthwise convolution is ``F.conv1d`` with one group per
  channel over ``K - 1`` zeros of left padding (the reference's
  ``conv_general_dilated`` with ``feature_group_count = C``);
* the intra-chunk product ``"bqk,bqkh,bkh,bkhp->bqhp"`` multiplies the
  first three operands elementwise, then contracts with ``x``;
* ``softplus`` is ``logaddexp(x, 0)`` as ``jax.nn.softplus`` computes it,
  not ``F.softplus`` (which switches to ``x`` above 20).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamDesc, embed_descs, embed_tokens,
                                       layer_at, no_constrain, remat_wrap,
                                       rms_norm, unembed, unstack)


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads H, head width P, state N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_state


def layer_descs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDesc]:
    L, D = layers, cfg.d_model
    d_inner, H, P, N = dims(cfg)
    conv_ch = d_inner + 2 * N
    return {
        "ln": ParamDesc((L, D), ("layers", "norm_scale")),
        "in_proj_z": ParamDesc((L, D, d_inner), ("layers", "embed", "mlp")),
        "in_proj_x": ParamDesc((L, D, d_inner), ("layers", "embed", "mlp")),
        "in_proj_bc": ParamDesc((L, D, 2 * N),
                                ("layers", "embed", "ssm_state2")),
        "in_proj_dt": ParamDesc((L, D, H), ("layers", "embed", "ssm_heads")),
        "conv_w": ParamDesc((L, cfg.ssm_conv_width, conv_ch),
                            ("layers", "conv", "mlp")),
        "conv_b": ParamDesc((L, conv_ch), ("layers", "bias")),
        "A_log": ParamDesc((L, H), ("layers", "norm_scale")),
        "D_skip": ParamDesc((L, H), ("layers", "norm_scale")),
        "dt_bias": ParamDesc((L, H), ("layers", "bias")),
        "gate_ln": ParamDesc((L, d_inner), ("layers", "norm_scale")),
        "out_proj": ParamDesc((L, d_inner, D), ("layers", "mlp", "embed")),
    }


def descs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"embed": embed_descs(cfg),
            "layers": layer_descs(cfg, cfg.num_layers),
            "final_norm": ParamDesc((cfg.d_model,), ("norm_scale",))}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
               device) -> Dict[str, Any]:
    """Constant-size state: ``max_seq`` and ``dtype`` do not enter."""
    d_inner, H, P, N = dims(cfg)
    L, K = cfg.num_layers, cfg.ssm_conv_width
    f32 = torch.float32
    return {"state": torch.zeros((L, batch, H, P, N), dtype=f32,
                                 device=device),
            "conv": torch.zeros((L, batch, K - 1, d_inner + 2 * N),
                                dtype=f32, device=device)}


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    return {"state": ("layers", "batch", "ssm_heads", None, None),
            "conv": ("layers", "batch", None, "mlp")}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv + SiLU. x (B,S,C), w (K,C), b (C,)."""
    K, C = w.shape
    xt = F.pad(x.transpose(1, 2), (K - 1, 0))
    out = F.conv1d(xt, w.t()[:, None, :], groups=C).transpose(1, 2)
    return F.silu(out + b)


def ssd_chunked(x, dt, A, B_, C_, chunk: int,
                state0: Optional[torch.Tensor] = None):
    """SSD over chunks. x (B,S,H,P), dt (B,S,H), A (H,), B_/C_ (B,S,N).
    Returns y (B,S,H,P) and the final state (B,H,P,N), float32. A length
    that the chunk does not divide runs as one chunk, as in the
    reference."""
    Bb, S, H, P = x.shape
    Q = min(chunk, S)
    if S % Q:
        Q = S
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B_.float(), C_.float()
    state = (state0 if state0 is not None else
             torch.zeros((Bb, H, P, B_.shape[-1]), dtype=torch.float32,
                         device=x.device))
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for c0 in range(0, S, Q):
        xc, dtc = xf[:, c0:c0 + Q], dtf[:, c0:c0 + Q]
        Bc, Cc = Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]
        ca = torch.cumsum(dtc * A, dim=1)                      # (B,Q,H)
        y_inter = torch.einsum("bqn,bhpn->bqhp", Cc, state) * torch.exp(
            ca)[..., None]
        # mask before exp, as the reference does: a masked (i < j) entry
        # has diff > 0 and could overflow
        diff = ca[:, :, None, :] - ca[:, None, :, :]           # (B,Q,Q,H)
        M = torch.exp(diff.masked_fill(~tri[None, :, :, None], -1e30))
        G = torch.einsum("bqn,bkn->bqk", Cc, Bc)
        W = G[..., None] * M * dtc[:, None, :, :]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", W, xc)
        decay_rem = torch.exp(ca[:, -1:, :] - ca)              # (B,Q,H)
        state = state * torch.exp(ca[:, -1, :])[:, :, None, None] + \
            torch.einsum("bkh,bkn,bkhp->bhpn", dtc * decay_rem, Bc, xc)
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=1), state


def block_forward(lp, h: torch.Tensor, cfg: ModelConfig, state=None,
                  conv_state=None):
    """One mamba2 block. Prefill when ``state`` is None; decode (S == 1)
    takes ``state`` (B,H,P,N) f32 and ``conv_state`` (B,K-1,C). Returns
    (h, new state f32, new conv state)."""
    dtype = h.dtype
    d_inner, H, P, N = dims(cfg)
    B = h.shape[0]
    x_in = rms_norm(h, lp["ln"], cfg.norm_eps)
    z = x_in @ lp["in_proj_z"]
    conv_in = torch.cat([x_in @ lp["in_proj_x"], x_in @ lp["in_proj_bc"]],
                        dim=-1)                                # (B,S,C)
    dt = x_in @ lp["in_proj_dt"]
    w, b = lp["conv_w"], lp["conv_b"]
    K = w.shape[0]
    if conv_state is None:
        conv_out = _causal_conv(conv_in, w, b)
        # the last K-1 conv inputs, left-padded for a shorter prompt
        S = conv_in.shape[1]
        if S >= K - 1:
            new_conv = conv_in[:, S - (K - 1):]
        else:
            new_conv = F.pad(conv_in, (0, 0, K - 1 - S, 0))
    else:
        window = torch.cat([conv_state.to(dtype), conv_in], dim=1)  # (B,K,C)
        conv_out = (window.float() * w.float()).sum(dim=1, keepdim=True)
        conv_out = F.silu(conv_out.to(dtype) + b)
        new_conv = window[:, 1:]
    xs = conv_out[..., :d_inner].reshape(B, -1, H, P)
    B_ = conv_out[..., d_inner:d_inner + N]
    C_ = conv_out[..., d_inner + N:]
    dt = softplus(dt.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    if state is None:
        y, new_state = ssd_chunked(xs, dt, A, B_, C_, cfg.ssm_chunk)
    else:
        # the exact 1-step update: s' = exp(dt A) s + dt B x; y = C s'
        da = torch.exp(dt[:, 0] * A)                            # (B,H)
        upd = (dt[:, 0, :, None, None] * xs[:, 0].float()[..., None]
               * B_[:, 0].float()[:, None, None, :])
        new_state = state * da[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", C_[:, 0].float(),
                         new_state)[:, None]
    y = y + lp["D_skip"].float()[None, None, :, None] * xs.float()
    y = rms_norm(y.reshape(B, -1, d_inner).to(dtype), lp["gate_ln"],
                 cfg.norm_eps)
    y = y * F.silu(z.float()).to(dtype)
    return h + y @ lp["out_proj"], new_state, new_conv


def hidden_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                   remat=True, constrain=no_constrain):
    """The training forward: (final-norm hidden states (B,S,D), {})."""
    h = constrain(embed_tokens(params["embed"], tokens, cfg),
                  ("batch", None, None))

    def body(h, lp):
        return constrain(block_forward(lp, h, cfg)[0], ("batch", None, None))

    body = remat_wrap(body, remat)
    for lp in unstack(params["layers"]):
        h = body(h, lp)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), {}


def _run(params, h, cfg: ModelConfig, cache=None):
    states, convs = [], []
    for l in range(cfg.num_layers):
        st = cv = None
        if cache is not None:
            st, cv = cache["state"][l], cache["conv"][l]
        h, st, cv = block_forward(layer_at(params["layers"], l), h, cfg,
                                  state=st, conv_state=cv)
        states.append(st)
        convs.append(cv.float())
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, {"state": torch.stack(states), "conv": torch.stack(convs)}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_seq: int
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt (B,S): (last-token logits (B,V) f32, cache)."""
    h, cache = _run(params, embed_tokens(params["embed"], tokens, cfg), cfg)
    return unembed(params["embed"], h[:, -1:, :], cfg)[:, 0], cache


def decode_step(params, token: torch.Tensor, cache: Dict[str, Any],
                pos: torch.Tensor, cfg: ModelConfig, max_seq: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step (position-free recurrence: ``pos`` is unused)."""
    h, new_cache = _run(params, embed_tokens(params["embed"], token[:, None],
                                             cfg), cfg, cache)
    return unembed(params["embed"], h, cfg)[:, 0], new_cache
