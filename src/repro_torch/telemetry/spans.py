"""Per-request span tracing over the serving clock.

The counterpart of ``repro.telemetry.spans``. A span is a named interval
on the decode-step clock, attributed to a *lane* (the Chrome-trace
process: ``serve`` for request work, ``background`` for scrub, rotation
and copy-on-write) and a *track* (the thread: one per request, plus
``pool``/``scrub``/``wear``/``prefix``), optionally parented to another
span — one request's queue, prefill and decode bursts form a tree under
its request span.

Span args may hold device scalars (an accumulator reference) or
``Lazy(fn, *deps)`` derivations over them (a burst's energy delta):
``finalize()`` lands the deps through ``registry.land`` — one transfer
for the whole run — and runs ``fn`` on the landed host floats, so
attribution dispatches nothing and syncs nowhere on the serving loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.telemetry import registry

#: Chrome-trace lanes (processes). Tracks (threads) are free-form.
LANE_SERVE = "serve"
LANE_BACKGROUND = "background"


class Lazy:
    """A derived span arg: ``fn(*host(deps))``, evaluated at finalize.

    ``deps`` are device scalars (accumulator references, never written
    in place, so they pin the recording-time values) or host numbers;
    ``fn`` is host float arithmetic. Recording one allocates a small
    object and nothing else."""
    __slots__ = ("fn", "deps")

    def __init__(self, fn, *deps):
        self.fn = fn
        self.deps = deps


@dataclasses.dataclass
class Span:
    sid: int
    parent: Optional[int]
    name: str
    cat: str
    lane: str
    track: str
    t0: float
    t1: Optional[float] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.t1 is not None


class SpanTracer:
    """Append-only span store with explicit parent handles.

    ``begin``/``end`` bracket long-lived spans (the per-request root);
    ``complete`` records a finished interval in one call. All timestamps
    are in decode steps.
    """

    def __init__(self):
        self.spans: List[Span] = []
        self._finalized = False

    def begin(self, name: str, t0: float, *, lane: str = LANE_SERVE,
              track: str = "main", cat: str = "serve",
              parent: Optional[int] = None, **args: Any) -> int:
        sid = len(self.spans)
        self.spans.append(Span(sid=sid, parent=parent, name=name, cat=cat,
                               lane=lane, track=track, t0=float(t0),
                               args=dict(args)))
        return sid

    def end(self, sid: int, t1: float, **args: Any) -> None:
        s = self.spans[sid]
        assert not s.closed, f"span {sid} ({s.name}) already closed"
        s.t1 = float(t1)
        s.args.update(args)

    def complete(self, name: str, t0: float, t1: float, *,
                 lane: str = LANE_SERVE, track: str = "main",
                 cat: str = "serve", parent: Optional[int] = None,
                 **args: Any) -> int:
        sid = self.begin(name, t0, lane=lane, track=track, cat=cat,
                         parent=parent, **args)
        self.end(sid, t1)
        return sid

    # ------------------------------------------------------------ finalize
    def pending(self) -> Iterable[torch.Tensor]:
        """Every device scalar the span args still hold (raw refs and
        ``Lazy`` deps); empty once finalized."""
        if self._finalized:
            return
        for s in self.spans:
            for v in s.args.values():
                if isinstance(v, Lazy):
                    yield from (d for d in v.deps
                                if isinstance(d, torch.Tensor))
                elif isinstance(v, torch.Tensor):
                    yield v

    def finalize(self, landed: Optional[Dict[int, float]] = None) -> None:
        """Resolve every device span arg: raw refs become their landed
        floats, ``Lazy`` args run ``fn`` on their deps' landed values.
        ``landed`` is a ``registry.land`` result that already holds them
        (``Telemetry.finalize`` shares one transfer with the drains);
        without it this lands them itself, in one transfer. Idempotent;
        must run before export."""
        if self._finalized:
            return
        if landed is None:
            landed = registry.land(self.pending())
        for s in self.spans:
            for k, v in s.args.items():
                if isinstance(v, Lazy):
                    s.args[k] = float(v.fn(*(
                        registry.landed_value(d, landed) for d in v.deps)))
                elif isinstance(v, torch.Tensor):
                    s.args[k] = landed[id(v)]
        self._finalized = True

    # ------------------------------------------------------------ validate
    def validate(self) -> List[str]:
        """Structural integrity: parent handles resolve, children nest
        inside their parent's interval, everything is closed. Returns
        the problems found (empty = clean)."""
        problems = []
        by_sid = {s.sid: s for s in self.spans}
        for s in self.spans:
            if not s.closed:
                problems.append(f"span {s.sid} ({s.name}) never closed")
                continue
            if s.t1 < s.t0:
                problems.append(f"span {s.sid} ({s.name}) ends before "
                                f"it starts ({s.t0}..{s.t1})")
            if s.parent is None:
                continue
            p = by_sid.get(s.parent)
            if p is None:
                problems.append(f"span {s.sid} ({s.name}) parent "
                                f"{s.parent} does not exist")
            elif p.closed and not (p.t0 <= s.t0 and s.t1 <= p.t1):
                problems.append(
                    f"span {s.sid} ({s.name}) [{s.t0},{s.t1}] escapes "
                    f"parent {p.sid} ({p.name}) [{p.t0},{p.t1}]")
        return problems

    def children(self, sid: int) -> List[Span]:
        return [s for s in self.spans if s.parent == sid]

    def roots(self) -> List[Span]:
        return [s for s in self.spans if s.parent is None]

    def snapshot(self) -> List[Dict[str, Any]]:
        """Plain-dict span list for the serve report. Requires
        ``finalize()`` when any arg is still a device value."""
        assert self._finalized or not any(
            isinstance(v, (Lazy, torch.Tensor))
            for s in self.spans for v in s.args.values()), \
            "snapshot() before finalize() with unresolved lazy args"
        return [{"sid": s.sid, "parent": s.parent, "name": s.name,
                 "cat": s.cat, "lane": s.lane, "track": s.track,
                 "t0": s.t0, "t1": s.t1, "args": dict(s.args)}
                for s in self.spans]
