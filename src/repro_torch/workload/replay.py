"""Trace replay: the trace-iterator arrival source for the scheduler.

The counterpart of ``repro.workload.replay.TraceSource`` for token-only
traces (the dense and hybrid families): it answers "when does the next
request arrive" from host metadata and materializes a request's prompt
tensor only when the scheduler pops it. Admission order is (arrival,
rid), as in the reference, which is what keeps replay bit-comparable
across packages.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.priority import Priority
from repro_torch.serve.scheduler import Request
from repro_torch.workload.trace import Trace, TraceEvent, validate_trace


def _materialize(ev: TraceEvent, cfg, device,
                 quality_override: Optional[str] = None) -> Request:
    if cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r}: only token prompts are ported")
    q = quality_override if quality_override is not None else ev.quality
    return Request(
        rid=ev.rid,
        prompt={"tokens": torch.tensor([list(ev.tokens)], dtype=torch.int64,
                                       device=device)},
        new_tokens=ev.new_tokens, arrival=ev.arrival, app_id=ev.app_id,
        quality=Priority.coerce(q) if q is not None else None,
        session=ev.session)


class TraceSource:
    """Arrival source over a validated, (arrival, rid)-sorted trace."""

    def __init__(self, trace: Trace, cfg, device,
                 quality_override: Optional[str] = None):
        self.trace = validate_trace(trace)
        self.cfg = cfg
        self.device = device
        self.quality_override = quality_override
        self._i = 0

    def __bool__(self) -> bool:
        return self._i < len(self.trace.events)

    def __len__(self) -> int:
        return len(self.trace.events) - self._i

    def next_arrival(self) -> Optional[int]:
        if not self:
            return None
        return self.trace.events[self._i].arrival

    def popleft(self) -> Request:
        ev = self.trace.events[self._i]
        self._i += 1
        return _materialize(ev, self.cfg, self.device,
                            self.quality_override)

