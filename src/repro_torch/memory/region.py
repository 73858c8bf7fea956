"""MemoryRegion: a tree of device tensors living in approximate memory.

The counterpart of ``repro.memory.region``. A region owns one tree of
tensors, one resolve-once ``WritePlan``, one cumulative device-resident
``WriteStats`` and a lifetime plan and state (``repro_torch.reliability``).
It is functional:

    region = MemoryRegion.create({"kv": {"k": k0, "v": v0}},
                                 level=Priority.LOW)
    region = region.write(key, new_tree)     # diff-write, on the device
    region = region.age(key, steps=4)        # retention decay
    region = region.scrub(key)               # corrective re-write
    report = region.report()                 # the one host read

Every write diffs against the stored bits through the plan's backend
(the device's by default: the kernel on a CUDA device, the twin on the
CPU) and accumulates its stats on the device. ``retention_scale`` (the
modelled dwell seconds per ``age`` step) makes a region mortal at
``ambient_k``; 0 keeps it immortal, where ``age`` and ``scrub`` are
identities.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.priority import Priority
from repro_torch.memory.backends import default_backend
from repro_torch.memory.plan import WritePlan
from repro_torch.memory.stats import WriteStats, report_of


@dataclasses.dataclass
class MemoryRegion:
    plan: WritePlan
    data: Any
    stats: WriteStats
    life_plan: Any = None
    life: Any = None
    scrub_stats: WriteStats = None

    @classmethod
    def create(cls, data: Any, *,
               level: Priority | int | str = Priority.LOW,
               policy: Optional[Callable] = None,
               backend: Optional[str] = None,
               ambient_k: float = 300.0,
               retention_scale: float = 0.0) -> "MemoryRegion":
        """A region around ``data`` (a tree of tensors on one device).

        ``level`` tags every leaf when no ``policy(path, leaf)`` is
        given; EXACT leaves bypass the driver, every other leaf (integer
        ones included) goes through it. ``backend`` defaults to the
        device's. ``retention_scale`` turns the retention model on."""
        from repro_torch.reliability import LifetimePlan
        device = T.leaves(data)[0].device
        lvl = Priority.coerce(level)
        pol = policy if policy is not None else (lambda path, leaf: lvl)
        plan = WritePlan.for_tree(
            data, device=device, backend=backend or default_backend(device),
            policy=pol,
            approx_if=lambda leaf, tag: tag != Priority.EXACT)
        life_plan = LifetimePlan.for_tree(data, plan, ambient_k=ambient_k,
                                          dwell_s=retention_scale)
        return cls(plan=plan, data=data, stats=WriteStats.zero(device),
                   life_plan=life_plan, life=life_plan.init_state(data),
                   scrub_stats=WriteStats.zero(device))

    def write(self, key: np.ndarray, new_tree: Any,
              floor: Priority = Priority.LOW) -> "MemoryRegion":
        """Diff-write ``new_tree`` over the stored bits. A full write
        voids the decay record (every approximate bit was re-driven or
        confirmed) and books one unit of write wear per approximate leaf
        and per physical row."""
        stored, st = self.plan.write(key, self.data, new_tree,
                                     self.plan.vectors_for(floor))
        life = self.life
        if life is not None and not self.life_plan.immortal:
            approx = self.life_plan._approx
            life = dataclasses.replace(
                life,
                masks=tuple(None if m is None else torch.zeros_like(m)
                            for m in life.masks),
                write_count=life.write_count + approx,
                row_write_count=life.row_write_count + approx[:, None],
                last_write_step=torch.where(approx > 0, life.step,
                                            life.last_write_step))
        return dataclasses.replace(self, data=stored,
                                   stats=self.stats + st, life=life)

    def age(self, key: np.ndarray, steps: int = 1,
            floor: Priority = Priority.LOW) -> "MemoryRegion":
        """Let the stored bits dwell ``steps`` region steps at the plan's
        ambient: one decay draw over the whole dwell (the process is
        memoryless), no write wear. Identity on immortal regions."""
        if self.life_plan is None or self.life_plan.immortal:
            return self
        vectors = self.life_plan.vectors_for(
            floor, dwell_s=self.life_plan.dwell_s * steps)
        data, life = self.life_plan.advance(key, self.data, self.life,
                                            vectors, count_write=False,
                                            steps=steps)
        return dataclasses.replace(self, data=data, life=life)

    def scrub(self, key: np.ndarray,
              floor: Priority = Priority.LOW) -> "MemoryRegion":
        """Corrective re-write of the accumulated decay through the
        region's backend (the scrub kernel on the card), its energy in
        the separate scrub ledger. Identity on immortal regions."""
        if self.life_plan is None or self.life_plan.immortal:
            return self
        from repro_torch.reliability import scrub_tree
        data, life, st = scrub_tree(key, self.data, self.life,
                                    self.life_plan,
                                    self.plan.vectors_for(floor))
        return dataclasses.replace(self, data=data, life=life,
                                   scrub_stats=self.scrub_stats + st)

    def read(self) -> Any:
        return self.data

    def report(self) -> Dict[str, Any]:
        """Cumulative accounting in one host read: the write stats and,
        with retention on, the lifetime ledger (write + scrub energy,
        sampled decay flips, bits still decayed)."""
        mortal = self.life_plan is not None and not self.life_plan.immortal
        parts = [self.stats.packed()]
        if mortal:
            parts += [self.scrub_stats.packed(), torch.stack([
                self.life.retention_flips,
                self.life.decayed_bits()]).to(torch.float64)]
        h = torch.cat(parts).tolist()
        out = report_of(h[:7])
        out["backend"] = self.plan.backend.name
        if mortal:
            scrub = report_of(h[7:14])
            out["scrub_energy_pj"] = scrub["energy_pj"]
            out["scrub_errors"] = scrub["bit_errors"]
            out["lifetime_energy_pj"] = out["energy_pj"] + scrub["energy_pj"]
            out["retention_flips"] = int(h[14])
            out["residual_decayed_bits"] = int(h[15])
            out["ambient_k"] = self.life_plan.ambient_k
        return out
