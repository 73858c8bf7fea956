"""Serving engine: batched prefill + decode with EXTENT-approximate KV writes.

The counterpart of ``repro.serve.engine`` for the greedy, extent-only
path of the ported families (dense; hybrid, whose float32 recurrent
states are EXACT leaves stored as they are). The engine diffs cache
trees: after a decode step the approximate write of (old cache, new
cache) is exactly the paper's write semantics — untouched slots are
bit-identical (zero energy under CMP) and the freshly written ring
column pays level energy and carries level WER. One ``WritePlan`` is
resolved at construction; the backend is a registry name (``cuda`` on a
CUDA device, ``lanes_ref`` on the CPU by default).

A decode *burst* of ``n`` steps is a Python loop of fused steps
(decode -> column write -> retention decay -> greedy sample -> stats)
that never reads the device: the RNG key schedule runs on the host
(``repro_torch.rng``), every carried value stays on the device, and
stats accumulate into one device-resident ``WriteStats``. On a CUDA device the burst runs under
``torch.cuda.set_sync_debug_mode("error")``, so any host sync inside it
raises — the port's form of the reference's transfer guard.

With ``retention_scale > 0`` a ``LifetimePlan`` shadows the write plan
(``repro_torch.reliability``): after each step's column write the decay
record of the re-written columns is cleared and every stored bit of the
approximate leaves dwells one step at the ambient temperature; ``scrub``
runs one corrective pass between bursts. The decay streams fold off the
step's write key, so the write and sampling schedule is the same with
retention on or off, and a 300 K run equals a retention-off run.

Lockstep contract (as in the reference): admitting a whole pool at once
and decoding it reproduces ``generate`` on the same batch bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core.energy_model import (StepEnergyMeter, add_slot_stats,
                                           zero_slot_stats)
from repro_torch.core.extent_table import QualityController
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device
from repro_torch.memory import WritePlan, WriteStats, default_backend
from repro_torch.memory.plan import BATCH_AXIS
from repro_torch.models import ModelApi, get_model
from repro_torch.reliability import LifetimePlan, scrub_tree


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 256
    max_new_tokens: int = 32
    extent_enabled: bool = True
    seed: int = 0
    #: write-path backend (a repro_torch.memory registry name); None picks
    #: the kernel ("cuda") on a CUDA device and the twin on the CPU
    backend: Optional[str] = None
    #: modelled device dwell (seconds) per decode step; 0 disables the
    #: retention model (repro_torch.reliability)
    retention_scale: float = 0.0
    #: die ambient temperature (kelvin) of the retention model
    ambient_k: float = 300.0


def _row_mask(active: torch.Tensor, ndim: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[BATCH_AXIS] = active.shape[0]
    return active.reshape(shape)


def mask_rows(new_tree: Any, old_tree: Any, active: torch.Tensor) -> Any:
    """Active rows take the new value, inactive rows keep the old — the
    burst guard that makes finished/empty slots free under CMP."""
    return T.tree_map(
        lambda n, o: torch.where(_row_mask(active, n.dim()), n, o),
        new_tree, old_tree)


class ServingEngine:
    """Batched autoregressive serving (greedy sampling) of any ported
    family: the engine only diffs cache trees."""

    def __init__(self, cfg: ModelConfig, serve_cfg: ServeConfig,
                 params: Optional[Any] = None, *, device=None,
                 api: Optional[ModelApi] = None):
        self.cfg = cfg
        self.scfg = serve_cfg
        self.device = resolve_device(device)
        self.api = api if api is not None else get_model(cfg)
        self.params = (params if params is not None
                       else self.api.init(serve_cfg.seed, self.device))
        self.meter = StepEnergyMeter()
        self.controller = QualityController()
        self.backend = serve_cfg.backend or default_backend(self.device)
        cache_like = self.api.init_cache(1, serve_cfg.max_seq, "meta")
        self.plan = WritePlan.for_tree(
            cache_like, device=self.device, backend=self.backend,
            axes=self.api.cache_axes())
        # per-(leaf, floor, ambient) decay thresholds resolved once; an
        # ambient schedule swaps them between bursts
        self.life_plan = None
        if serve_cfg.retention_scale > 0.0:
            self.life_plan = LifetimePlan.for_tree(
                cache_like, self.plan, ambient_k=serve_cfg.ambient_k,
                dwell_s=serve_cfg.retention_scale)

    def vectors_for_floor(self, floor: Priority = Priority.LOW) -> Tuple:
        return self.plan.vectors_for(floor)

    def retention_vectors_for(self, floor: Priority = Priority.LOW,
                              ambient_k: Optional[float] = None) -> Tuple:
        """Per-leaf decay thresholds for one (floor, ambient) pair. Only
        valid with retention on."""
        assert self.life_plan is not None, "retention_scale == 0"
        return self.life_plan.vectors_for(floor, ambient_k=ambient_k)

    def prompt_len(self, batch: Dict[str, torch.Tensor]) -> int:
        return self.api.prompt_len(batch)

    # ---------------------------------------------------------- fused steps
    def prefill(self, params, batch, old_rows, key: np.ndarray, vectors):
        """Fused prefill -> extent write -> first greedy token.
        ``old_rows=None`` diffs against zeros (a cold cache); otherwise
        against the pool's current rows for the admitted slots."""
        # the reference's three-way split; the third (sampling) key waits
        # for non-greedy sampling
        keys = rng.split(key, 3)
        key, k_write = keys[0], keys[1]
        logits, cache = self.api.prefill(params, batch, self.scfg.max_seq)
        acc = WriteStats.zero(self.device)
        if self.scfg.extent_enabled:
            old = (old_rows if old_rows is not None
                   else T.tree_map(torch.zeros_like, cache))
            cache, acc = self.plan.write(k_write, old, cache, vectors)
        return self._sample(logits), cache, key, acc

    def burst(self, params, tok, cache, pos, key: np.ndarray, acc,
              slot_acc, active, vectors, life=None, rvec=None, *, n: int):
        """``n`` fused decode steps. Inactive rows keep their cache bits,
        position and token. ``life``/``rvec`` (the lifetime state and the
        decay thresholds) are required with retention on and ignored
        otherwise. Returns (tok, cache, pos, key, acc, slot_acc, life,
        tokens (n, B))."""
        retention = self.life_plan is not None
        act_i = active.to(pos.dtype)
        toks = []
        with _no_host_sync(self.device):
            for _ in range(n):
                keys = rng.split(key, 3)
                key, k_write = keys[0], keys[1]
                logits, new_cache = self.api.decode_step(
                    params, tok, cache, pos, self.scfg.max_seq)
                new_cache = mask_rows(new_cache, cache, active)
                if self.scfg.extent_enabled:
                    new_cache, st = self.plan.write_columns(
                        k_write, cache, new_cache, pos, vectors)
                    acc = acc + st
                    slot_acc = add_slot_stats(slot_acc, st, active)
                if retention:
                    # the step re-wrote the active slots' ring columns:
                    # their decay record is void; then every stored bit
                    # of the approximate leaves dwells one step
                    life = self.life_plan.clear_written(life, pos, active)
                    new_cache, life = self.life_plan.advance(
                        k_write, new_cache, life, rvec)
                tok = torch.where(active, self._sample(logits), tok)
                cache, pos = new_cache, pos + act_i
                toks.append(tok)
        return tok, cache, pos, key, acc, slot_acc, life, torch.stack(toks)

    def scrub(self, key: np.ndarray, cache, life, vectors, *,
              enabled=None, cols: Optional[int] = None, cursor: int = 0):
        """One corrective scrub pass through the write path's backend
        (``reliability.scrub_tree``). Returns (cache, life, WriteStats)."""
        return scrub_tree(key, cache, life, self.life_plan, vectors,
                          enabled=enabled, cols=cols, cursor=cursor)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1)

    # ------------------------------------------------------------ generation
    def generate(self, batch: Dict[str, torch.Tensor],
                 max_new_tokens: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill ``batch`` then decode one burst. Returns (tokens
        (B, T_new), report); the stats cross to the host once, at the end."""
        mnt = max_new_tokens or self.scfg.max_new_tokens
        key = rng.PRNGKey(self.scfg.seed + 1)
        B = batch["tokens"].shape[0]
        vectors = self.vectors_for_floor(Priority.LOW)
        tok, cache, key, pre_acc = self.prefill(self.params, batch, None,
                                                key, vectors)
        pos = torch.full((B,), self.prompt_len(batch), dtype=torch.int64,
                         device=self.device)
        active = torch.ones((B,), dtype=torch.bool, device=self.device)
        acc = WriteStats.zero(self.device)
        slot_acc = zero_slot_stats(B, self.device)
        life = rvec = None
        if self.life_plan is not None:
            life = self.life_plan.init_state(cache)
            rvec = self.retention_vectors_for(Priority.LOW)
        if mnt > 1:
            _, cache, pos, key, acc, slot_acc, life, toks = self.burst(
                self.params, tok, cache, pos, key, acc, slot_acc, active,
                vectors, life, rvec, n=mnt - 1)
            tokens = torch.cat([tok[:, None], toks.t()], dim=1)
        else:
            tokens = tok[:, None]
        if self.scfg.extent_enabled:
            self.meter.add_stream("kv_prefill", pre_acc.host_dict())
            self.meter.add_stream("kv_decode", acc.host_dict())
        report = self.meter.summary()
        if life is not None:
            flips, decayed = torch.stack(
                [life.retention_flips, life.decayed_bits()]).tolist()
            report["retention"] = {
                "ambient_k": self.scfg.ambient_k,
                "dwell_s_per_step": self.scfg.retention_scale,
                "flips": int(flips), "decayed_bits": int(decayed)}
        return tokens, report


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """Any host sync inside the block raises (CUDA); restored after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
