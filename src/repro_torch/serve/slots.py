"""Slot-pool KV cache: a fixed-capacity pool of per-request cache rows.

The counterpart of ``repro.serve.slots.SlotPool`` without prefix links,
copy-on-write or wear scores. The pool owns one device cache tree whose
slot (batch) axis is the capacity, plus the per-slot decode state the
burst carries (token, position, attribution accumulators). The free list
hands out the lowest ids, so a group admitted together occupies a
contiguous prefix — admitting the whole pool reproduces the monolithic
batch layout exactly (the lockstep bit-parity contract).
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import tree as T
from repro_torch.core.energy_model import zero_slot_stats
from repro_torch.memory import WriteStats
from repro_torch.serve.engine import BATCH_AXIS


class SlotPool:
    """Fixed-capacity pool of cache rows with free-list admission."""

    def __init__(self, api, capacity: int, max_seq: int, device):
        self.capacity = capacity
        self.device = torch.device(device)
        self.cache = api.init_cache(capacity, max_seq, self.device)
        self.tok = torch.zeros((capacity,), dtype=torch.int64,
                               device=self.device)
        self.pos = torch.zeros((capacity,), dtype=torch.int64,
                               device=self.device)
        self.slot_acc = zero_slot_stats(capacity, self.device)
        self.slot_req: List[Optional[Any]] = [None] * capacity
        self._free: List[int] = list(range(capacity))
        heapq.heapify(self._free)
        self.admissions = 0
        #: admit() calls: one fused prefill (and one write per approximate
        #: leaf) each
        self.admission_groups = 0
        self.completions = 0
        self.peak_occupancy = 0

    def free_slots(self) -> int:
        return len(self._free)

    def occupied(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def busy(self) -> bool:
        return len(self._free) < self.capacity

    def alloc(self, n: int) -> List[int]:
        """Claim the ``n`` lowest free slot ids."""
        assert n <= len(self._free), (n, len(self._free))
        return [heapq.heappop(self._free) for _ in range(n)]

    def release(self, slot_ids: Sequence[int]) -> None:
        """Return slots to the free list. Their cache rows keep the stale
        bits on purpose: the next admission diffs against them."""
        for i in slot_ids:
            assert self.slot_req[i] is not None, i
            self.slot_req[i] = None
            heapq.heappush(self._free, i)
        self.completions += len(slot_ids)

    def index(self, slot_ids: Sequence[int]) -> torch.Tensor:
        """``slot_ids`` as an int64 index tensor on the pool's device."""
        return torch.tensor(list(slot_ids), dtype=torch.int64,
                            device=self.device)

    def extract_rows(self, slot_ids: Sequence[int]) -> Any:
        """Current cache rows of ``slot_ids`` (the admission write's old)."""
        idx = self.index(slot_ids)
        return T.tree_map(lambda a: a.index_select(BATCH_AXIS, idx),
                          self.cache)

    def admit(self, slot_ids: Sequence[int], requests: Sequence[Any],
              stored_rows: Any, first_tok: torch.Tensor,
              pos0: Sequence[int], acc: WriteStats,
              acc_prefill: WriteStats) -> WriteStats:
        """Install an admission group: stored rows, first token, decode
        positions, and the group's stats (each admitted slot's ledger is
        reset to its even share of the admission write). Returns the
        updated prefill accumulator."""
        idx = self.index(slot_ids)
        self.cache = T.tree_map(
            lambda a, r: a.index_copy(BATCH_AXIS, idx, r), self.cache,
            stored_rows)
        self.tok = self.tok.index_copy(0, idx, first_tok)
        self.pos = self.pos.index_copy(
            0, idx, torch.tensor(list(pos0), dtype=torch.int64,
                                 device=self.device))
        admitted = torch.zeros((self.capacity,), dtype=torch.bool,
                               device=self.device).index_fill(0, idx, True)
        m = float(len(slot_ids))
        share = {"energy_pj": acc.energy_pj / m,
                 "flips": (acc.flips01 + acc.flips10).to(torch.float32) / m,
                 "errors": acc.errors.to(torch.float32) / m}
        self.slot_acc = {k: torch.where(admitted, share[k], v)
                         for k, v in self.slot_acc.items()}
        for i, r in zip(slot_ids, requests):
            assert self.slot_req[i] is None, i
            self.slot_req[i] = r
        self.admissions += len(slot_ids)
        self.admission_groups += 1
        self.peak_occupancy = max(self.peak_occupancy,
                                  self.capacity - len(self._free))
        return acc_prefill + acc

    def active_mask(self) -> torch.Tensor:
        return torch.tensor([r is not None for r in self.slot_req],
                            dtype=torch.bool, device=self.device)

    def stats(self) -> Dict[str, Any]:
        return {"capacity": self.capacity, "admissions": self.admissions,
                "admission_groups": self.admission_groups,
                "completions": self.completions,
                "peak_occupancy": self.peak_occupancy,
                "occupancy": self.capacity - len(self._free)}
