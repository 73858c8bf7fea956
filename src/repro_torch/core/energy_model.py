"""Per-step energy accounting for the serving path.

The slice of ``repro.core.energy_model`` serving uses: the per-slot
attribution accumulators that ride on the device between scheduler
events, and the host-side ``StepEnergyMeter`` that folds synced
``WriteStats`` into the report's per-stream ledger. The Monte-Carlo
process-variation study is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

#: per-slot attribution layout: one float32 accumulator row per cache slot.
SLOT_STAT_KEYS = ("energy_pj", "flips", "errors")


def zero_slot_stats(n_slots: int, device) -> Dict[str, torch.Tensor]:
    """Fresh all-zero per-slot attribution accumulator ((n_slots,) f32)."""
    return {k: torch.zeros((n_slots,), dtype=torch.float32, device=device)
            for k in SLOT_STAT_KEYS}


def add_slot_stats(slot_acc: Dict[str, torch.Tensor], stats: Any,
                   active: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Attribute one write's device stats evenly across the active slots
    (the lane-packed write reduces per leaf, not per batch row)."""
    act = active.to(torch.float32)
    share = act / torch.clamp(act.sum(), min=1.0)
    flips = (stats.flips01 + stats.flips10).to(torch.float32)
    return {
        "energy_pj": slot_acc["energy_pj"] + share * stats.energy_pj,
        "flips": slot_acc["flips"] + share * flips,
        "errors": slot_acc["errors"] + share * stats.errors.to(
            torch.float32),
    }


@dataclasses.dataclass
class StepEnergyMeter:
    """Accumulates write energy per named stream (host side)."""
    streams: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def add_stream(self, stream: str, host_stats: Dict[str, Any]) -> None:
        """Fold one synced ``WriteStats.host_dict()`` into a stream."""
        s = self.streams.setdefault(stream, {
            "energy_pj": 0.0, "bits_written": 0, "bits_total": 0,
            "bit_errors": 0, "soft_strikes": 0, "latency_ns": 0.0})
        s["energy_pj"] += float(host_stats["energy_pj"])
        s["bits_written"] += int(host_stats["bits_written"])
        s["bit_errors"] += int(host_stats["bit_errors"])
        s["soft_strikes"] += int(host_stats["soft_strikes"])
        s["bits_total"] += int(host_stats["bits_total"])
        s["latency_ns"] = max(s["latency_ns"],
                              float(host_stats["latency_ns"]))

    def summary(self) -> Dict[str, Any]:
        tot = {k: sum(s.get(k, 0) for s in self.streams.values())
               for k in ("energy_pj", "bits_written", "bits_total",
                         "bit_errors", "soft_strikes")}
        tot["write_skip_rate"] = (
            1.0 - tot["bits_written"] / tot["bits_total"]
            if tot["bits_total"] else 0.0)
        tot["ber_realized"] = (
            tot["bit_errors"] / max(1, tot["bits_written"]))
        return {"streams": self.streams, "total": tot}
