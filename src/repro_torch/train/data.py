"""Synthetic data pipeline: deterministic, resumable (the counterpart of
``repro.train.data``).

Batches are a function of (seed, step): any host regenerates any step,
so the pipeline has no state to migrate on a re-mesh and resumes
exactly from a checkpoint's step. The token stream is a Zipf unigram
draw with shift structure (with probability 1/2 a token is the previous
draw plus one), so models have a learnable signal.

``make_batch`` equals the reference's bit for bit: ``fold_in(seed,
step)``, ``split``, the Zipf draw as ``jax.random.categorical`` over
``xla_log`` of the float32 probabilities (XLA's ``log``, whose last bit
can move an argmax), ``bernoulli(0.5)``, the roll and the shifted labels.
The draw runs on the device (``rng.categorical_xla_t``: chunks of the
flat counter range, B x S x V uniforms without a (B, S, V) tensor).
Token ids are int64.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.train.train_step import IGNORE


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks ** (-cfg.zipf_a)
    return (p / p.sum()).astype(np.float32)


def make_batch(cfg: DataConfig, step: int, device=None
               ) -> Dict[str, torch.Tensor]:
    """The batch of (seed, step) on ``device`` (default: the card):
    ``tokens`` (B, S) int64 and ``labels``, the next-token shift with the
    last position IGNOREd."""
    dev = resolve_device(device)
    key = rng.fold_in(rng.PRNGKey(cfg.seed), step)
    k1, k2 = rng.split(key)
    shape = (cfg.global_batch, cfg.seq_len)
    draw = rng.categorical_xla_t(k1, rng.xla_log(_zipf_probs(cfg)), shape,
                                 dev)
    # learnable structure: with p = 0.5 the token repeats the previous
    # draw plus one
    rep = rng.bernoulli_t(k2, 0.5, shape, dev)
    tokens = torch.where(rep, torch.roll((draw + 1) % cfg.vocab_size, 1,
                                         dims=1), draw)
    labels = torch.cat([tokens[:, 1:], torch.full(
        (cfg.global_batch, 1), IGNORE, dtype=torch.int64, device=dev)],
        dim=1)
    return {"tokens": tokens, "labels": labels}


def every_row(batch_size: int, data_size: int) -> bool:
    """Whether each of ``data_size`` ranks of a data axis holds every row
    of a global batch of ``batch_size`` (``rank_rows``): where the axis
    does not divide it."""
    return batch_size % data_size != 0


def rank_rows(batch: Dict[str, torch.Tensor], data_index: int,
              data_size: int) -> Dict[str, torch.Tensor]:
    """The rows ``[d B / D, (d + 1) B / D)`` of a global batch at index
    ``d = data_index`` of a data axis of ``D = data_size`` ranks (every
    rank of a model group holds the same rows); every row where ``D``
    does not divide the batch (replicated, as ``spec_for`` replicates
    what does not divide)."""
    B = next(iter(batch.values())).shape[0]
    if data_size == 1 or every_row(B, data_size):
        return batch
    n = B // data_size
    return {k: v[data_index * n:(data_index + 1) * n]
            for k, v in batch.items()}


@dataclasses.dataclass
class DataIterator:
    """Stateful view over ``make_batch`` with a checkpointable cursor;
    over a data axis of ``data_size`` ranks each draws the global batch
    and keeps its ``rank_rows`` at its ``data_index``."""
    cfg: DataConfig
    step: int = 0
    device: Optional[torch.device] = None
    data_index: int = 0
    data_size: int = 1

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = rank_rows(make_batch(self.cfg, self.step, self.device),
                      self.data_index, self.data_size)
        self.step += 1
        return b

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, s: Dict[str, int]) -> None:
        if s["seed"] != self.cfg.seed:
            raise ValueError(f"data seed mismatch on restore: {s['seed']} "
                             f"against {self.cfg.seed}")
        self.step = int(s["step"])


def for_model(cfg: ModelConfig, shape: ShapeConfig, seed: int = 1234,
              batch_override: Optional[int] = None, device=None
              ) -> DataIterator:
    return DataIterator(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=batch_override or shape.global_batch, seed=seed),
        device=device)
