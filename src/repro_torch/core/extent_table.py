"""EXTENT table + quality controller: the paper's architecture layer (Fig. 11).

The controller sits between the priority API and the write driver:

  * applications send (address/block, priority) via the API;
  * the EXTENT table caches the reported quality per memory block so
    repeated accesses to a block skip the tag handshake;
  * on a write, the controller looks the block up — hit returns the cached
    quality, miss installs the writer's default.

Here a "block" is a named tensor region (or a (tensor, block_idx) pair for
sub-tensor granularity). The table is a bounded LRU — the paper's table is
a small SRAM structure, so capacity pressure and eviction are modeled, and
hit/miss statistics are exported for the architecture benchmarks.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, Hashable, Optional, Tuple

from repro_torch.core.priority import Priority

#: the traffic scope counters land in when no ``scope(...)`` is active —
#: foreground request/write traffic.
DEFAULT_SCOPE = "serve"


@dataclasses.dataclass
class ExtentTable:
    capacity: int = 4096
    default: Priority = Priority.EXACT

    def __post_init__(self):
        self._map: "collections.OrderedDict[Hashable, Priority]" = (
            collections.OrderedDict())
        # per-scope traffic accounting: background passes (scrubbing) resolve
        # blocks through the SAME LRU — same entries, same eviction pressure —
        # but their hits/misses land in their own scope so a scrub pass never
        # inflates the serve traffic's hit rate (and vice versa).
        self._scopes: Dict[str, Dict[str, int]] = {}
        self._scope = DEFAULT_SCOPE

    def _counters(self, scope: Optional[str] = None) -> Dict[str, int]:
        return self._scopes.setdefault(
            scope or self._scope,
            {"hits": 0, "misses": 0, "evictions": 0})

    @contextlib.contextmanager
    def scope(self, name: str):
        """Route the traffic counters of the enclosed lookups/updates to
        ``name`` (e.g. ``"scrub"``). Cache *contents* are shared across
        scopes — only the accounting is separated. Reentrant."""
        prev, self._scope = self._scope, name
        try:
            yield self
        finally:
            self._scope = prev

    # -- controller operations ------------------------------------------------
    def update(self, block: Hashable, quality: Priority) -> None:
        """API `priority_level` command: install/refresh a block's quality."""
        q = Priority.coerce(quality)
        if block in self._map:
            self._map.move_to_end(block)
        elif len(self._map) >= self.capacity:
            self._map.popitem(last=False)
            self._counters()["evictions"] += 1
        self._map[block] = q

    def lookup(self, block: Hashable) -> Priority:
        """Write-path query: hit -> cached quality; miss -> writer default
        (and the default is installed, matching the paper's description)."""
        if block in self._map:
            self._counters()["hits"] += 1
            self._map.move_to_end(block)
            return self._map[block]
        self._counters()["misses"] += 1
        self.update(block, self.default)
        return self.default

    def reset_stats(self) -> None:
        """Zero the hit/miss/eviction counters of EVERY scope WITHOUT
        touching the cached block->quality entries. Called between scheduler
        arrival streams so per-run serve reports never aggregate stale table
        traffic from a previous stream on the same engine."""
        self._scopes.clear()

    # -- observability ---------------------------------------------------------
    def _sum(self, key: str) -> int:
        return sum(c[key] for c in self._scopes.values())

    @property
    def hits(self) -> int:
        return self._sum("hits")

    @property
    def misses(self) -> int:
        return self._sum("misses")

    @property
    def evictions(self) -> int:
        return self._sum("evictions")

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self, scope: Optional[str] = None) -> Dict[str, float]:
        """Aggregate counters (all scopes), plus the per-scope breakdown
        under ``"scopes"``. With ``scope=`` set, only that scope's traffic
        is reported (no breakdown)."""
        if scope is not None:
            c = dict(self._scopes.get(
                scope, {"hits": 0, "misses": 0, "evictions": 0}))
            n = c["hits"] + c["misses"]
            c["hit_rate"] = c["hits"] / n if n else 0.0
            c["occupancy"] = len(self._map)
            return c
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate,
                "occupancy": len(self._map),
                "scopes": {k: dict(v) for k, v in self._scopes.items()}}


@dataclasses.dataclass
class QualityController:
    """Fig. 11 controller: EXTENT table + per-stream default policies.

    Streams ("kv", "checkpoint", "optimizer", ...) carry their own writer
    defaults; `quality_for` resolves (stream, block) -> driver level.
    """
    table: ExtentTable = dataclasses.field(default_factory=ExtentTable)
    stream_defaults: Dict[str, Priority] = dataclasses.field(
        default_factory=lambda: {
            "kv": Priority.MID,
            "kv_v": Priority.LOW,
            # per-request serving hints: a miss imposes NO quality floor
            # (LOW == "no constraint beyond the engine's static policy"),
            # so unhinted traffic never perturbs the write plan.
            "kv_request": Priority.LOW,
            "checkpoint_weights": Priority.EXACT,
            "checkpoint_moments": Priority.LOW,
            "activation": Priority.HIGH,
        })

    def tag(self, stream: str, block: Hashable, quality) -> None:
        self.table.update((stream, block), Priority.coerce(quality))

    def quality_for(self, stream: str, block: Hashable) -> Priority:
        prev_default = self.table.default
        self.table.default = self.stream_defaults.get(stream, Priority.EXACT)
        try:
            return self.table.lookup((stream, block))
        finally:
            self.table.default = prev_default

    def resolve_request(self, block: Hashable, hint=None,
                        stream: str = "kv_request") -> Priority:
        """Admission-time handshake for one serving request.

        A request carrying an explicit quality ``hint`` first tags its block
        (the API ``priority_level`` command), then the write path resolves
        through the table — so a later request from the same application
        (same ``block``) inherits the cached quality as a table *hit* without
        re-negotiating. Unhinted blocks resolve to the stream default.
        """
        if hint is not None:
            self.tag(stream, block, hint)
        return self.quality_for(stream, block)
