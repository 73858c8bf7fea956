"""AdamW with float32 moments, elementwise (the counterpart of
``repro.train.optimizer``).

The state is a tree matching the parameters, so the checkpointer and the
write plan treat it like any other: ``OptState(step, m, v)``, with
``step`` a 0-d int32 tensor and ``m``/``v`` float32 trees.

``update`` runs each leaf a slice of ``UPDATE_SLICE`` elements at a
time (every op is elementwise, so the values do not depend on the
slicing), which bounds its float32 temporaries; ``donate=True`` writes
the new values into the given parameters and moments, as the reference
launcher's ``donate_argnums`` lets XLA do, so a step holds one copy of
the training state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def init(params: Any) -> OptState:
    """Zero moments in float32 beside each parameter, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = T.leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=T.tree_map(zeros, params), v=T.tree_map(zeros, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; float32."""
    step_f = step.to(torch.float32)
    warm = torch.clamp(step_f / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step_f - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in T.leaves(tree)))


#: elements of a leaf updated at once
UPDATE_SLICE = 1 << 26


def update(cfg: AdamWConfig, grads: Any, state: OptState, params: Any, *,
           donate: bool = False
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}). With
    ``donate`` the new values overwrite ``params``' and ``state``'s
    tensors (which the result then holds); the caller must not read the
    old values afterwards."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    step_f = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, step_f)
    b2c = 1.0 - torch.pow(cfg.b2, step_f)

    def upd_slice(p, g, m, v):
        g = g.to(torch.float32) * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m2 / b1c
        vh = v2 / b2c
        delta = (mh / (torch.sqrt(vh) + cfg.eps)
                 + cfg.weight_decay * p.to(torch.float32))
        p2 = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return p2, m2, v2

    def upd(p, g, m, v):
        outs = (p, m, v) if donate else tuple(
            torch.empty_like(x, memory_format=torch.contiguous_format)
            for x in (p, m, v))
        flat_in = [x.reshape(-1) for x in (p, g, m, v)]
        flat_out = [x.view(-1) for x in outs]
        for a in range(0, max(1, p.numel()), UPDATE_SLICE):
            new = upd_slice(*(x[a:a + UPDATE_SLICE] for x in flat_in))
            for dst, val in zip(flat_out, new):
                dst[a:a + UPDATE_SLICE].copy_(val)
        return outs

    flat_p, tdef = T.flatten_with_def(params)
    out = [upd(p, g, m, v) for (_, p), g, m, v in zip(
        flat_p, tdef.flatten_up_to(grads), tdef.flatten_up_to(state.m),
        tdef.flatten_up_to(state.v))]
    new_p, new_m, new_v = (tdef.unflatten([o[k] for o in out])
                           for k in range(3))
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm,
                                                 "lr": lr}
