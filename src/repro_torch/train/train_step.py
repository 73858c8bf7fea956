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

``make_train_step`` is the one-process step. ``make_sharded_train_step``
is the same step on one rank of a (data, model) process mesh: its
parameters and moments are the rank's blocks, its batch its data row's
rows.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils import checkpoint as ckpt

from repro_torch import tree as T
from repro_torch.models import ModelApi
from repro_torch.models.layers import ModelAxis, no_constrain
from repro_torch.models.moe import TokenGroup
from repro_torch.train import optimizer as opt

IGNORE = -1
LB_LOSS_COEF = 0.01


def chunked_ce_loss(api: ModelApi, params, h: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE over positions whose label is not IGNORE, their count),
    both float32. h: (B, S, D). A length the chunk does not divide runs
    as one chunk, as in the reference."""
    loss_sum, count = chunked_ce_sum(api, params, h, labels, chunk)
    return loss_sum / torch.clamp(count, min=1.0), count


def chunked_ce_sum(api: ModelApi, params, h: torch.Tensor,
                   labels: torch.Tensor, chunk: int = 256,
                   model_axis: Optional[ModelAxis] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(CE summed over the positions whose label is not IGNORE, their
    count), both float32, a chunk of the sequence at a time. Over a
    ``model_axis`` that cuts the vocabulary each rank holds its columns
    of the logits (``vocab_parallel_ce``)."""
    S = h.shape[1]
    C = min(chunk, S)
    if S % C:
        C = S
    cut = model_axis is not None and model_axis.vocab

    def chunk_loss(h_c, y_c):
        logits = api.logits(params, h_c, model_axis).float()  # (B, C, V)
        if cut:
            lse, ll = vocab_parallel_ce(logits, y_c.clamp(min=0),
                                        model_axis)
        else:
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
    return loss_sum, count


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      axis: ModelAxis) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-sum-exp over the whole vocabulary, the label's logit) from
    this rank's columns ``logits`` (B, C, V/M): ``lse = m + log sum_r
    exp(lse_r - m)`` with ``m = max_r lse_r`` (one model-axis MAX and one
    sum), the label's logit from the rank that holds it (zeros
    elsewhere, summed). On a model group of one, ``lse_0 + log(1)``: the
    plain values and gradients bit for bit."""
    lse_r = torch.logsumexp(logits, dim=-1)
    m = axis.max(lse_r)
    lse = m + torch.log(axis.reduce_out(torch.exp(lse_r - m)))
    cols, hit = axis.local(labels, logits.shape[-1])
    ll = logits.gather(-1, cols[..., None])[..., 0]
    return lse, axis.reduce_out(torch.where(hit, ll, 0.0))


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


# ---------------------------------------------------------------------------
# over a (data, model) process mesh


def sharded_value_and_grad(api: ModelApi, params, batch, shards, *,
                           every_row: bool = False, loss_chunk: int = 256,
                           remat=True) -> Tuple[torch.Tensor, Dict, Any]:
    """``value_and_grad`` of the whole mesh's loss on this rank's blocks
    of the parameters (``shards``: a ``sharding.rules.MeshShards``) and
    its data row's rows of the batch: (loss, aux, gradient tree of the
    blocks). ``every_row``: the rank holds every row of the global
    batch, one the data axis does not divide (``data.every_row``).

    The loss is the CE summed over the data axis's rows over the token
    count summed likewise, never a mean of the ranks' means: each rank
    differentiates its data row's CE sum over the axis's count, and the
    gathers' reduce-scatters (data-sharded leaves) and ``sync_grads``
    (leaves whole over ``data``) sum the data ranks' gradients. Where
    every rank holds every row, the count is D times the batch's, so the
    sum over the data ranks is the one-device gradient. Over the model
    axis (``shards.model_axis``, the dense family) the ranks of a data
    row hold the same rows and the same loss; the tensor-parallel
    blocks' collectives hand each rank its blocks' gradients and every
    other leaf's whole. A model with experts dispatches over the data
    group (``moe.TokenGroup``) and each rank differentiates its partial
    ``lb_loss``, whose sum over the ranks is the one-device loss. The
    loss and aux are detached and equal on every rank; the reported
    ``lb_loss`` is the partials' sum."""
    flat, tdef = T.flatten_with_def(params)
    leaves = [p.detach().requires_grad_(True) for _, p in flat]
    p = tdef.unflatten(leaves)
    # the embedding is made whole over data once, for the forward and
    # the logits
    p = {**p, "embed": shards.gather("embed", p["embed"])}

    def gather(name, tree):
        return tree if name == "embed" else shards.gather(name, tree)

    axis = shards.model_axis
    h, aux = api.forward_hidden(
        p, batch, remat=remat, gather=gather, model_axis=axis,
        moe_group=TokenGroup(shards.n, every_row, shards.data_group))
    loss_sum, count = chunked_ce_sum(api, p, h, batch["labels"], loss_chunk,
                                     axis)
    lb = "lb_loss" in aux
    sums = torch.stack([loss_sum.detach(), count]
                       + ([aux["lb_loss"].detach()] if lb else []))
    dist.all_reduce(sums, group=shards.data_group)
    loss = loss_sum / torch.clamp(sums[1], min=1.0)
    if lb:
        loss = loss + LB_LOSS_COEF * aux["lb_loss"]
    grads = tdef.unflatten(list(torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)))
    shards.sync_grads(grads)
    aux = {k: v.detach() for k, v in aux.items()}
    total = ce = sums[0] / torch.clamp(sums[1], min=1.0)
    if lb:
        aux["lb_loss"] = sums[2]
        total = ce + LB_LOSS_COEF * sums[2]
    return total, {"ce_loss": ce, "tokens": sums[1], **aux}, grads


def make_sharded_train_step(api: ModelApi, opt_cfg: opt.AdamWConfig, shards,
                            *, loss_chunk: int = 256, remat=True,
                            donate: bool = False):
    """``make_train_step`` over a (data, model) mesh:
    ``train_step(params, opt_state, batch, every_row=False)`` on this
    rank's blocks (``ModelApi.init(keep=shards.keep)``) and its data
    row's batch rows (``data.rank_rows``; ``every_row`` as in
    ``sharded_value_and_grad``), AdamW elementwise on the blocks under
    the whole tree's gradient norm. On one rank its values are the
    one-process step's bit for bit."""
    counted = shards.counted()

    def train_step(params, opt_state, batch, every_row: bool = False):
        loss, aux, grads = sharded_value_and_grad(
            api, params, batch, shards, every_row=every_row,
            loss_chunk=loss_chunk, remat=remat)
        params2, opt_state2, om = opt.update(opt_cfg, grads, opt_state,
                                             params, donate=donate,
                                             counted=counted)
        return params2, opt_state2, {"loss": loss, **aux, **om}

    return train_step
