"""Microbatched gradient accumulation (the counterpart of
``repro.train.accumulate``).

A step splits the global batch into N microbatches whose gradients
accumulate in float32; the step's gradient is their mean and its loss
the mean of theirs. Error-feedback int8 compression runs once per step
on the accumulated gradient, not per microbatch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import tree as T
from repro_torch.models import ModelApi
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.models.layers import no_constrain
from repro_torch.train.train_step import value_and_grad


@dataclasses.dataclass(frozen=True)
class AccumConfig:
    num_microbatches: int = 1
    compression: Optional[comp.CompressionConfig] = None


def split_batch(batch: Dict[str, torch.Tensor], n: int
                ) -> Dict[str, torch.Tensor]:
    """(B, ...) -> (n, B/n, ...)."""
    def one(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} "
                             f"microbatches")
        return x.reshape((n, B // n) + tuple(x.shape[1:]))
    return {k: one(v) for k, v in batch.items()}


def make_accum_train_step(api: ModelApi, opt_cfg: opt.AdamWConfig,
                          acc: AccumConfig, *, constrain=no_constrain,
                          remat=True, donate: bool = False):
    """``train_step(params, opt_state, ef, batch) -> (params, opt_state,
    ef, metrics)`` with metrics ``loss``, ``grad_norm`` and ``lr``;
    ``ef`` may be None when compression is off; ``donate`` as in
    ``make_train_step``."""
    n = acc.num_microbatches

    def grad_fn(params, mb):
        loss, _, grads = value_and_grad(api, params, mb, constrain=constrain,
                                        remat=remat)
        return loss, grads

    def train_step(params, opt_state, ef, batch):
        if n == 1:
            loss, grads = grad_fn(params, batch)
        else:
            mbs = split_batch(batch, n)
            grads = T.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=T.leaves(params)[0].device)
            for i in range(n):
                l_i, g = grad_fn(params, {k: v[i] for k, v in mbs.items()})
                T.tree_map(lambda a, b: a.add_(b), grads, g)
                loss = loss + l_i
                del g
            grads = T.tree_map(lambda g: g / n, grads)
            loss = loss / n
        if acc.compression is not None and acc.compression.enable:
            grads, ef = comp.compress_grads(grads, ef, acc.compression)
        params2, opt_state2, om = opt.update(opt_cfg, grads, opt_state,
                                             params, donate=donate)
        return params2, opt_state2, ef, {"loss": loss, **om}

    return train_step
