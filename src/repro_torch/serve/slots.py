"""Slot-pool KV cache: a fixed-capacity pool of per-request cache rows.

The counterpart of ``repro.serve.slots.SlotPool``. The pool owns one device cache tree whose slot (batch) axis is the
capacity, plus the per-slot decode state the burst carries (token,
position, attribution accumulators). The free list hands out the lowest
ids, so a group admitted together occupies a contiguous prefix —
admitting the whole pool reproduces the monolithic batch layout exactly
(the lockstep bit-parity contract).

Prefix links (``serve.prefix``) add refcounted column ownership:
``links[linker] = (owner, cols)`` records that a slot's leading KV
columns mirror another slot's resident ones, ``col_refs[owner]`` counts
its linkers, and a free slot with inbound links is *blocked* from
allocation until they drop or are copy-on-write detached.
``generation[s]`` rises at every admission, so prefix-cache entries
naming overwritten columns fail their generation check. All of it is
host bookkeeping.
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
        self.col_refs: List[int] = [0] * capacity
        self.links: Dict[int, Tuple[int, int]] = {}
        self.generation: List[int] = [0] * capacity
        self.admissions = 0
        #: admit() calls: one fused prefill (and one write per approximate
        #: leaf) each
        self.admission_groups = 0
        self.completions = 0
        self.peak_occupancy = 0
        #: the die mesh of a sharded pool (None = one die)
        self.mesh = None

    def free_slots(self) -> int:
        return len(self._free)

    def occupied(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def busy(self) -> bool:
        return len(self._free) < self.capacity

    def blocked_free(self) -> List[int]:
        """Free slots pinned by inbound prefix links (ascending)."""
        return sorted(i for i in self._free if self.col_refs[i] > 0)

    def allocatable(self, exclude: Sequence[int] = ()) -> int:
        """Free slots claimable now: not link-blocked, not in
        ``exclude`` (the match owners of an admission in flight)."""
        avoid = set(exclude)
        return sum(1 for i in self._free
                   if self.col_refs[i] == 0 and i not in avoid)

    def alloc(self, n: int, scores: Optional[Sequence[float]] = None,
              exclude: Sequence[int] = ()) -> List[int]:
        """Claim ``n`` free slots that are neither link-blocked nor in
        ``exclude``: the lowest ids, or with ``scores`` ((capacity,) host
        floats, higher = worse home: the wear checkpoint's per-slot wear
        and decay) the lowest by (score, id), so a uniform score vector
        gives the default order exactly. With no links, no exclusions and
        no scores (every prefix-off, wear-off run) this is the plain
        free-list order."""
        avoid = {i for i in self._free if self.col_refs[i] > 0}
        avoid.update(exclude)
        if not avoid and scores is None:
            assert n <= len(self._free), (n, len(self._free))
            return [heapq.heappop(self._free) for _ in range(n)]
        cand = [i for i in self._free if i not in avoid]
        assert n <= len(cand), (n, len(cand), sorted(avoid))
        if scores is None:
            ids = sorted(cand)[:n]
        else:
            ids = sorted(cand, key=lambda i: (float(scores[i]), i))[:n]
        taken = set(ids)
        self._free = [i for i in self._free if i not in taken]
        heapq.heapify(self._free)
        return ids

    def link(self, linker: int, owner: int, cols: int) -> None:
        """Record that ``linker``'s leading ``cols`` KV columns mirror
        ``owner``'s; the owner's refcount blocks its eviction."""
        assert linker not in self.links, linker
        if linker == owner:
            return  # re-admission into the owner slot shares nothing new
        self.links[linker] = (owner, cols)
        self.col_refs[owner] += 1

    def unlink(self, linker: int) -> None:
        """Drop ``linker``'s outbound link (completion or CoW)."""
        owner, _ = self.links.pop(linker)
        assert self.col_refs[owner] > 0, owner
        self.col_refs[owner] -= 1

    def cow_detach(self, owner: int) -> List[Tuple[int, int]]:
        """Copy-on-write: detach every linker of ``owner`` so its columns
        may be overwritten. The linkers' rows already hold the shared
        bits; the caller books one full write of each returned
        ``(linker, cols)`` (``WritePlan.alias_saving`` pricing)."""
        out = [(lk, cols) for lk, (ow, cols) in self.links.items()
               if ow == owner]
        for lk, _ in out:
            self.unlink(lk)
        return sorted(out)

    def release(self, slot_ids: Sequence[int]) -> None:
        """Return slots to the free list. Their cache rows keep the stale
        bits on purpose: the next admission diffs against them, and the
        prefix cache may link to their resident columns until an
        admission overwrites them. A completing slot drops its own
        outbound link; inbound links survive (they pin columns, not
        occupancy)."""
        for i in slot_ids:
            assert self.slot_req[i] is not None, i
            self.slot_req[i] = None
            if i in self.links:
                self.unlink(i)
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
            assert self.col_refs[i] == 0, (i, self.col_refs[i])
            self.slot_req[i] = r
            # the slot's previous resident bits are gone: prefix-cache
            # entries naming them fail their generation check
            self.generation[i] += 1
        self.admissions += len(slot_ids)
        self.admission_groups += 1
        self.peak_occupancy = max(self.peak_occupancy,
                                  self.capacity - len(self._free))
        return acc_prefill + acc

    def active_mask(self) -> torch.Tensor:
        return torch.tensor([r is not None for r in self.slot_req],
                            dtype=torch.bool, device=self.device)

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "capacity": self.capacity, "admissions": self.admissions,
            "admission_groups": self.admission_groups,
            "completions": self.completions,
            "peak_occupancy": self.peak_occupancy,
            "occupancy": self.capacity - len(self._free)}
        if self.mesh is not None:
            out["occupancy_by_die"] = [
                sum(1 for i in range(*self.mesh.slot_slice(d).indices(
                    self.capacity)) if self.slot_req[i] is not None)
                for d in range(self.mesh.n_dies)]
        return out

    def telemetry_gauges(self) -> Dict[str, int]:
        """The pool's per-event gauge sample (``repro_torch.telemetry``):
        host free-list metadata only, no device read."""
        return {"serve_pool_occupancy": self.capacity - len(self._free)}
