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

Over the data axis of a process group (``TokenGroup``) one dispatch
serves the whole group's batch, as the reference's global program does:
the capacity comes from the group's token count, an assignment's slot
is its prefix count over the group's tokens, rank-major as the rows lie
(``data.rank_rows``: this rank's local count plus the lower ranks'
per-expert counts, one all-gather of an (E,) count vector a layer), and
``dropped`` counts the group's drops. Each rank's ``lb_loss`` is its
partial: its mean router probability times its share of the group's
tokens against the group's assignment shares, so the ranks' partials
(and their gradients) sum to the one-process loss.

The expert buffers are filled by ``index_add_`` into zeros, but each
kept assignment owns its row and every dropped one adds zeros to a spare
row that is cut off, so no row sums two values and the fill repeats bit
for bit too. Nothing reads the device: the capacity is a host int of the
static shapes, and dropped assignments gather a clamped index whose
value is masked (the reference's gather clamps too), so a decode step
with MoE layers stays sync-free.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDesc, all_gather_dim


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


@dataclasses.dataclass(frozen=True)
class TokenGroup:
    """The ``n`` ranks of a data axis whose rows one dispatch serves
    (``group``: their process subgroup; None for the whole group).
    ``every_row``: each rank holds every row of the batch (one the ranks
    do not divide, ``data.every_row``), so the dispatch is the
    one-process dispatch on each rank."""
    n: int
    every_row: bool = False
    group: Any = None

    def tokens(self, local: int) -> int:
        """The tokens the capacity is sized for."""
        return local if self.every_row else self.n * local

    def counts(self, local: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the lower ranks' per-expert assignments, the group's): both
        (E,) int32, from this rank's ``local`` counts."""
        if self.every_row:
            return torch.zeros_like(local), local
        every = all_gather_dim(local[None], 0, self.group)      # (n, E)
        r = dist.get_rank(self.group)
        return (every[:r].sum(0, dtype=torch.int32),
                every.sum(0, dtype=torch.int32))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties in
    index order (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              group: Optional[TokenGroup] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) in the compute dtype -> (y (B, S, D), aux) with aux
    ``dropped`` (assignments over capacity) and ``lb_loss`` (the
    switch-style load-balancing loss), both device scalars. With a
    ``group`` the dispatch is the group's and ``lb_loss`` this rank's
    partial."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.experts_per_token
    T_cap = group.tokens(T) if group is not None else T
    cap = capacity_for(cfg, T_cap)
    dtype = x.dtype
    xf = x.reshape(T, D)

    router_logits = xf.float() @ p["router"].to(dtype).float()   # (T, E)
    probs = torch.softmax(router_logits, dim=-1)
    gates, eidx = top_k(probs, k)                                # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each assignment within its expert (exclusive prefix
    # count, token-major then rank), after the lower ranks' assignments
    flat_e = eidx.reshape(T * k)
    onehot = (flat_e[:, None] == torch.arange(E, device=x.device)).to(
        torch.int32)                                             # (T*k, E)
    prefix = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = prefix.gather(1, flat_e[:, None])[:, 0]                # (T*k,)
    counts = onehot.sum(0, dtype=torch.int32)                    # (E,)
    if group is not None:
        below, counts = group.counts(counts)
        pos = pos + below[flat_e]
    keep = pos < cap
    # an expert's assignments past the capacity are its drops
    dropped = (counts - cap).clamp_min(0).sum()

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

    # aux: load-balancing loss ingredients (switch-style); over a group
    # each rank's mean router probability is weighted by its share of the
    # group's tokens, so the ranks' partials sum to the group's loss
    me = probs.mean(dim=0)                       # mean router prob / expert
    if group is not None:
        me = me * (1.0 / group.n)
    ce = counts.float() / T_cap                  # tokens / expert
    aux = {"dropped": dropped, "lb_loss": E * torch.sum(me * ce) / k}
    return y.reshape(B, S, D), aux
