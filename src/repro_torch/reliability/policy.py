"""Scrub scheduling policies — host-side, sync-free decision logic.

A copy of ``repro.reliability.policy`` (which imports no JAX): the port
keeps its own so that it imports nothing of the reference package.

A policy answers ONE question per scheduler event: "scrub now, and which
leaves?" — from host-predictable inputs only (the serving clock, slot-pool
idleness, its own pass history). It never reads device state, so asking it
costs nothing on the decode pipeline.

Policies:
  * ``periodic``       — fixed interval, with opportunistic early passes
                         when the pool has idle slots (scrubbing is
                         background work: prefer the moments serving
                         doesn't need the machine).
  * ``wear_aware``     — periodic, but each completed pass stretches the
                         next interval: scrub re-writes consume endurance
                         too, so a wear-leveling controller backs off as
                         cumulative scrub writes mount.
  * ``quality_floor``  — per-leaf intervals from the region's priority
                         levels: HIGH leaves scrub at interval/4, MID at
                         the base interval, LOW leaves at 4x (the paper's
                         minor data is *allowed to rot* — its consumers
                         tolerate the errors, so burning scrub energy on
                         it is waste).
  * ``none``           — never scrub (retention still decays; this is the
                         scrub-interval -> infinity corner).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.core.priority import Priority


@dataclasses.dataclass
class ScrubPolicy:
    """Base: never scrub. Subclasses override ``plan_pass``.

    ``cols_per_pass`` > 0 switches the scrub to column-scoped windows of
    that width (the scheduler walks a cursor over the ring), bounding the
    per-pass device work; 0 scrubs whole leaves.
    """
    interval: int = 0
    cols_per_pass: int = 0
    name: str = "none"

    def __post_init__(self):
        self.last_pass: int = 0
        self.passes: int = 0

    def reset(self) -> None:
        """Restart the pass history — called by the scheduler at the start
        of each ``run()`` (the serving clock restarts at 0 per arrival
        stream, so carrying ``last_pass``/``passes`` across runs would
        starve or over-stretch the next stream's scrub cadence)."""
        self.last_pass = 0
        self.passes = 0

    def describe(self) -> dict:
        """Static policy identity for telemetry span args / reports."""
        return {"policy": self.name, "interval": self.interval,
                "cols_per_pass": self.cols_per_pass}

    def plan_pass(self, clock: int,
                  levels: Sequence[Optional[Priority]], *,
                  idle: bool = False
                  ) -> Optional[Tuple[bool, ...]]:
        """Return the per-leaf enable mask for a pass starting now, or
        ``None`` for "not yet". Implementations must call ``record`` via
        the returned mask being non-None (the scheduler does it)."""
        return None

    def record(self, clock: int) -> None:
        """A pass just ran at ``clock``."""
        self.last_pass = clock
        self.passes += 1

    def _all_approx(self, levels) -> Tuple[bool, ...]:
        return tuple(lvl is not None for lvl in levels)


@dataclasses.dataclass
class PeriodicScrub(ScrubPolicy):
    """Scrub every ``interval`` steps; when the pool has idle slots, an
    early pass is allowed from half the interval on (idle-slot background
    work)."""
    name: str = "periodic"

    def plan_pass(self, clock, levels, *, idle=False):
        if self.interval <= 0:
            return None
        since = clock - self.last_pass
        due = since >= self.interval or (idle and since >= max(
            1, self.interval // 2))
        return self._all_approx(levels) if due else None


@dataclasses.dataclass
class WearAwareScrub(PeriodicScrub):
    """Periodic with endurance back-off: pass ``n`` waits
    ``interval * (1 + wear_backoff * n)`` steps — cumulative scrub wear
    throttles the scrub rate instead of grinding cells forever."""
    wear_backoff: float = 0.25
    name: str = "wear_aware"

    def plan_pass(self, clock, levels, *, idle=False):
        if self.interval <= 0:
            return None
        eff = int(self.interval * (1.0 + self.wear_backoff * self.passes))
        since = clock - self.last_pass
        due = since >= eff or (idle and since >= max(1, eff // 2))
        return self._all_approx(levels) if due else None


@dataclasses.dataclass
class QualityFloorScrub(ScrubPolicy):
    """Per-leaf cadence from the region's priority levels: HIGH scrubs
    aggressively (interval/4), MID at the base interval, LOW at 4x —
    quality floors set both how well a leaf is written AND how hard its
    lifetime is defended."""
    name: str = "quality_floor"

    def __post_init__(self):
        super().__post_init__()
        self._leaf_last: dict = {}  # leaf index -> last scrubbed clock

    def reset(self) -> None:
        super().reset()
        self._leaf_last.clear()

    def _leaf_interval(self, lvl: Priority) -> int:
        base = max(1, self.interval)
        if lvl >= Priority.HIGH:
            return max(1, base // 4)
        if lvl == Priority.MID:
            return base
        return base * 4  # LOW: allowed to rot

    def plan_pass(self, clock, levels, *, idle=False):
        """Per-leaf due clocks (a returned mask is always executed by the
        scheduler, so the marks advance here)."""
        if self.interval <= 0:
            return None
        mask = tuple(
            lvl is not None and
            clock - self._leaf_last.get(i, 0) >= self._leaf_interval(lvl)
            for i, lvl in enumerate(levels))
        if not any(mask):
            return None
        for i, due in enumerate(mask):
            if due:
                self._leaf_last[i] = clock
        return mask


def make_scrub_policy(name: str, interval: int = 0,
                      cols_per_pass: int = 0) -> ScrubPolicy:
    """Registry-style constructor for the launcher's ``--scrub-policy``."""
    kinds = {"none": ScrubPolicy, "periodic": PeriodicScrub,
             "wear_aware": WearAwareScrub,
             "quality_floor": QualityFloorScrub}
    if name not in kinds:
        raise KeyError(f"unknown scrub policy {name!r}; "
                       f"known: {', '.join(sorted(kinds))}")
    return kinds[name](interval=interval, cols_per_pass=cols_per_pass)
