"""Wear-leveling policies — when to rotate the physical address map.

The counterpart of ``repro.reliability.wear`` (host numpy, copied).

A wear policy answers one question at the scheduler's periodic wear
checkpoints: "has hot-row wear concentrated enough that the permutation
should rotate?" Unlike the scrub policies (host-side and sync-free), wear
decisions need the device's per-physical-row-group counters — so the
policy declares a ``check_interval`` and the scheduler syncs the small
(L, G) wear counters once per checkpoint, never per token or per burst.

Rotation is start-gap style: the permutation advances by ``rotate_step``
columns and the controller migrates one row group through its row buffer
(the corrective migration write), whose energy the caller books to the
lifetime ledger's ``remap`` component. ``RotateWearPolicy`` triggers
whenever the hottest group has accumulated ``hot_row_wear`` more units
since the last rotation — under a hot-row workload that caps the per-
group wear ramp at ~``hot_row_wear`` per rotation period and spreads the
rest over the ring.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WearPolicy:
    """Base: track nothing, never rotate.

    ``check_interval``: serving-clock steps between device wear reads
    (the one sync this subsystem costs). ``rotate_step``: columns the
    permutation advances per rotation. ``hot_row_wear``: max-group wear
    accumulated since the last rotation that arms the next one."""
    check_interval: int = 8
    rotate_step: int = 1
    hot_row_wear: int = 16
    name: str = "none"

    def __post_init__(self):
        self.reset()

    def reset(self) -> None:
        """Restart the rotation history (per scheduler ``run()``, like
        ``ScrubPolicy.reset`` — the serving clock restarts per stream)."""
        self.rotations: int = 0
        self.last_rotation: int = 0
        self._wear_mark = None  # (L, G) snapshot at the last rotation

    def plan_rotation(self, clock: int, row_wear: np.ndarray) -> bool:
        """Host-side decision from the synced (L, G) wear counters:
        rotate now? Implementations must be deterministic in (clock,
        row_wear)."""
        return False

    def record(self, clock: int, row_wear: np.ndarray) -> None:
        """A rotation just happened at ``clock``."""
        self.rotations += 1
        self.last_rotation = clock
        self._wear_mark = np.array(row_wear, copy=True)  # wear snapshot

    def rebase(self, row_wear: np.ndarray) -> None:
        """Re-anchor the gain baseline WITHOUT counting a rotation — called
        when a run resumes from a persisted wear snapshot, so historical
        wear restored from the checkpoint is not mistaken for wear gained
        since the (never-happened) last rotation of this run."""
        self._wear_mark = np.array(row_wear, copy=True)  # wear snapshot

    def _gained(self, row_wear: np.ndarray) -> float:
        """Hottest per-group wear GAIN since the last rotation (not the
        global max: a rotated-away group keeps its historical wear, which
        must not inflate the fresh hot group's trigger level)."""
        base = 0 if self._wear_mark is None else self._wear_mark
        return float(np.max(row_wear - base, initial=0.0))


@dataclasses.dataclass
class RotateWearPolicy(WearPolicy):
    """Rotate when the hottest physical row group has worn by
    ``hot_row_wear`` units since the last rotation."""
    name: str = "rotate"

    def plan_rotation(self, clock: int, row_wear: np.ndarray) -> bool:
        return self._gained(row_wear) >= self.hot_row_wear


def make_wear_policy(name: str, *, check_interval: int = 8,
                     rotate_step: int = 1,
                     hot_row_wear: int = 16) -> WearPolicy:
    """Registry-style constructor for the launcher's ``--wear-policy``."""
    kinds = {"none": WearPolicy, "rotate": RotateWearPolicy}
    if name not in kinds:
        raise KeyError(f"unknown wear policy {name!r}; "
                       f"known: {', '.join(sorted(kinds))}")
    return kinds[name](check_interval=check_interval,
                       rotate_step=rotate_step, hot_row_wear=hot_row_wear)
