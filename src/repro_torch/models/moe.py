"""Mixture-of-Experts FFN: capacity-based, sort-free dispatch.

The counterpart of ``repro.models.moe``, with its semantics:

  * the router product runs in float32 on float32 copies of both
    operands (the reference's ``preferred_element_type=f32`` einsum);
    with TF32 off, as PyTorch has it by default, a bf16 model's routing
    is not moved by a rounded product;
  * the top-k keeps ties in expert order, lower index first (as
    ``lax.top_k``): a stable descending sort over the E router
    probabilities, of which the first k are taken;
  * each assignment's slot in its expert's buffer is its exclusive prefix
    count over the (T, k) assignments, token-major and rank-minor; slots
    at or past the capacity are dropped (``aux["dropped"]`` counts them);
  * the experts run as batched products over (E, capacity, D) buffers;
  * each token's k weighted contributions are summed in rank order,
    ``((0 + y_0) + y_1) + ...``, one add at a time in the compute dtype
    (the reference's scatter-add runs its updates in that order), not by
    an atomic ``index_add_``, whose order would change from run to run.

The expert buffers are filled by ``index_add_`` into zeros, but each
kept assignment owns its row and every dropped one adds zeros to a spare
row that is cut off, so no row sums two values and the fill repeats bit
for bit too. Nothing reads the device: the capacity is a host int of the
static shapes, and dropped assignments gather a clamped index whose
value is masked (the reference's gather clamps too), so a decode step
with MoE layers stays sync-free.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDesc


def moe_descs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDesc]:
    L, D, Fd, E = layers, cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDesc((L, D, E), ("layers", "embed", "expert_logits")),
        "wi_gate": ParamDesc((L, E, D, Fd),
                             ("layers", "expert", "embed", "expert_mlp")),
        "wi_up": ParamDesc((L, E, D, Fd),
                           ("layers", "expert", "embed", "expert_mlp")),
        "wo": ParamDesc((L, E, Fd, D),
                        ("layers", "expert", "expert_mlp", "embed")),
    }


def capacity_for(cfg: ModelConfig, num_tokens: int) -> int:
    k, E = cfg.experts_per_token, cfg.num_experts
    cap = int(cfg.capacity_factor * num_tokens * k / E)
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties in
    index order (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) in the compute dtype -> (y (B, S, D), aux) with aux
    ``dropped`` (assignments over capacity) and ``lb_loss`` (the
    switch-style load-balancing loss), both device scalars."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.experts_per_token
    cap = capacity_for(cfg, T)
    dtype = x.dtype
    xf = x.reshape(T, D)

    router_logits = xf.float() @ p["router"].to(dtype).float()   # (T, E)
    probs = torch.softmax(router_logits, dim=-1)
    gates, eidx = top_k(probs, k)                                # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each assignment within its expert (exclusive prefix
    # count, token-major then rank)
    flat_e = eidx.reshape(T * k)
    onehot = (flat_e[:, None] == torch.arange(E, device=x.device)).to(
        torch.int32)                                             # (T*k, E)
    prefix = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = prefix.gather(1, flat_e[:, None])[:, 0]                # (T*k,)
    keep = pos < cap
    dropped = (~keep).sum()

    # fill the (E, cap, D) expert buffers: kept assignments own unique
    # rows; dropped ones all land on the spare last row, cut off below
    tok = torch.arange(T * k, device=x.device) // k
    dest = torch.where(keep, flat_e * cap + pos, E * cap)
    contrib = torch.where(keep[:, None], xf[tok], 0).to(dtype)
    buf = torch.zeros((E * cap + 1, D), dtype=dtype, device=x.device)
    buf.index_add_(0, dest, contrib)
    buf = buf[:E * cap].reshape(E, cap, D)

    # batched expert FFN
    gate = torch.bmm(buf, p["wi_gate"].to(dtype))
    up = torch.bmm(buf, p["wi_up"].to(dtype))
    act = F.silu(gate.float()).to(dtype) * up
    out = torch.bmm(act, p["wo"].to(dtype))                      # (E,cap,D)

    # gather back (a dropped slot reads a clamped index, then masked),
    # weighted by the renormalized gates
    slot = flat_e * cap + pos.clamp_max(cap - 1)
    y_assign = out.reshape(E * cap, D)[slot] * gates.reshape(T * k, 1).to(
        dtype)
    y_assign = torch.where(keep[:, None], y_assign, 0).reshape(T, k, D)
    y = torch.zeros((T, D), dtype=dtype, device=x.device)
    for j in range(k):
        y = y + y_assign[:, j]

    # aux: load-balancing loss ingredients (switch-style)
    me = probs.mean(dim=0)                       # mean router prob / expert
    ce = onehot.reshape(T, k, E).sum(1).float().mean(0)  # tokens / expert
    aux = {"dropped": dropped, "lb_loss": E * torch.sum(me * ce) / k}
    return y.reshape(B, S, D), aux
