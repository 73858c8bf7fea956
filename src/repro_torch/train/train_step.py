"""The train step: chunked cross-entropy, gradients by autograd, AdamW
(the counterpart of ``repro.train.train_step``).

The loss runs the vocabulary projection over sequence chunks, each chunk
under ``torch.utils.checkpoint``: a chunk's (B, C, V) float32 logits live
only while its loss (forward) or its gradient (backward) is computed, so
the full (B, S, V) logits never exist. Labels equal to ``IGNORE`` are
masked (the vlm's image positions, the last position of each row).

Gradients are ``torch.autograd.grad`` of the loss over the parameter
leaves, detached copies that share storage; a step returns new
parameters and optimizer state, as the reference's does, or with
``donate`` writes them into the ones it was given.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import tree as T
from repro_torch.models import ModelApi
from repro_torch.models.layers import no_constrain
from repro_torch.train import optimizer as opt

IGNORE = -1
LB_LOSS_COEF = 0.01


def chunked_ce_loss(api: ModelApi, params, h: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE over positions whose label is not IGNORE, their count),
    both float32. h: (B, S, D). A length the chunk does not divide runs
    as one chunk, as in the reference."""
    S = h.shape[1]
    C = min(chunk, S)
    if S % C:
        C = S

    def chunk_loss(h_c, y_c):
        logits = api.logits(params, h_c).float()              # (B, C, V)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, y_c.clamp(min=0)[..., None])[..., 0]
        mask = (y_c != IGNORE).float()
        return ((lse - ll) * mask).sum(), mask.sum()

    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, C):
        ls, n = ckpt.checkpoint(chunk_loss, h[:, c0:c0 + C],
                                labels[:, c0:c0 + C], use_reentrant=False,
                                preserve_rng_state=False)
        loss_sum = loss_sum + ls
        count = count + n
    return loss_sum / torch.clamp(count, min=1.0), count


def loss_fn(api: ModelApi, params, batch: Dict[str, torch.Tensor], *,
            constrain=no_constrain, loss_chunk: int = 256, remat=True):
    """(total loss, {"ce_loss", "tokens", and the forward's aux})."""
    h, aux = api.forward_hidden(params, batch, remat=remat,
                                constrain=constrain)
    loss, count = chunked_ce_loss(api, params, h, batch["labels"],
                                  loss_chunk)
    total = loss
    if "lb_loss" in aux:
        total = total + LB_LOSS_COEF * aux["lb_loss"]
    return total, {"ce_loss": loss, "tokens": count, **aux}


def value_and_grad(api: ModelApi, params, batch, *,
                   constrain=no_constrain, loss_chunk: int = 256,
                   remat=True) -> Tuple[torch.Tensor, Dict, Any]:
    """(loss, aux, gradient tree) of ``loss_fn`` at ``params``; the loss
    and aux are detached. A leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives."""
    flat, tdef = T.flatten_with_def(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    loss, aux = loss_fn(api, tdef.unflatten(leaves), batch,
                        constrain=constrain, loss_chunk=loss_chunk,
                        remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tdef.unflatten(list(grads)))


def make_train_step(api: ModelApi, opt_cfg: opt.AdamWConfig, *,
                    constrain=no_constrain, loss_chunk: int = 256,
                    grad_transform: Optional[Callable[[Any], Any]] = None,
                    remat=True, donate: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``ce_loss``, ``tokens``, ``lb_loss``
    (the dense and moe families), ``grad_norm`` and ``lr``, device
    scalars. ``grad_transform(grads) -> grads`` hooks gradient compression
    (``train.compression.compress_grads``); ``remat`` in {True,
    'selective', False} is the activation-checkpoint policy; ``donate``
    updates ``params`` and ``opt_state`` in place (``optimizer.update``),
    as the reference launcher donates them to its jitted step."""

    def train_step(params, opt_state, batch):
        loss, aux, grads = value_and_grad(api, params, batch,
                                          constrain=constrain,
                                          loss_chunk=loss_chunk, remat=remat)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params2, opt_state2, om = opt.update(opt_cfg, grads, opt_state,
                                             params, donate=donate)
        return params2, opt_state2, {"loss": loss, **aux, **om}

    return train_step
