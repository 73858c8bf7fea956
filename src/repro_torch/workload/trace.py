"""Versioned, replayable serving-trace format (JSONL).

A trace is the full description of one arrival stream: per request the
arrival step, the explicit prompt token ids (stored verbatim so replay is
bit-exact regardless of which generator produced them), the decode budget,
the optional quality hint / application id, a session id, and an optional
shared-prefix group. Non-token prompt modalities (VLM image embeddings,
audio frames) are not serialized — they are regenerated at replay time
from the recorded ``modal_seed`` with the same recipe the synthetic stream
used, which keeps trace files small while preserving bit-exact replay.

File layout: line 1 is the header object (format marker, version, vocab
bound, provenance metadata); every following line is one event. Events
must be sorted by (arrival, rid) — the scheduler's admission order — and
``validate_trace`` enforces that plus the per-field schema, so a loaded
trace is replayable as-is.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: bump when the event schema changes; loaders reject unknown versions.
TRACE_VERSION = 1

FORMAT_MARKER = "repro.workload.trace"

_QUALITIES = (None, "low", "mid", "high", "exact")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One request of an arrival stream. ``tokens`` are the explicit
    prompt ids; ``arrival`` is in decode steps (the serving clock);
    ``prefix_group`` marks requests sharing a common prompt head (None =
    no declared sharing); ``modal_seed`` regenerates non-token prompt
    leaves for multimodal families."""
    rid: int
    arrival: int
    tokens: Tuple[int, ...]
    new_tokens: int
    quality: Optional[str] = None
    app_id: Optional[str] = None
    session: Optional[int] = None
    prefix_group: Optional[int] = None
    modal_seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "tokens", tuple(int(t)
                                                 for t in self.tokens))

    def to_json(self) -> Dict[str, Any]:
        d = {"rid": self.rid, "arrival": self.arrival,
             "tokens": list(self.tokens), "new_tokens": self.new_tokens}
        for k in ("quality", "app_id", "session", "prefix_group",
                  "modal_seed"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TraceEvent":
        return cls(rid=int(d["rid"]), arrival=int(d["arrival"]),
                   tokens=tuple(int(t) for t in d["tokens"]),
                   new_tokens=int(d["new_tokens"]),
                   quality=d.get("quality"), app_id=d.get("app_id"),
                   session=d.get("session"),
                   prefix_group=d.get("prefix_group"),
                   modal_seed=d.get("modal_seed"))


@dataclasses.dataclass(frozen=True)
class Trace:
    """An arrival stream plus its provenance header. ``vocab_size`` bounds
    every token id (0 disables the bound check — hand-written traces);
    ``meta`` records how the trace came to be (preset name, seed,
    generator params) purely for reporting."""
    events: Tuple[TraceEvent, ...]
    vocab_size: int = 0
    family: str = "dense"
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    version: int = TRACE_VERSION

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def __len__(self) -> int:
        return len(self.events)

    def header(self) -> Dict[str, Any]:
        return {"format": FORMAT_MARKER, "version": self.version,
                "vocab_size": self.vocab_size, "family": self.family,
                "meta": self.meta}

    def max_seq(self) -> int:
        """The slot ring length this stream needs (longest prompt+decode
        span over the stream)."""
        return max(len(e.tokens) + e.new_tokens for e in self.events)

    def max_new_tokens(self) -> int:
        return max(e.new_tokens for e in self.events)


def validate_trace(trace: Trace) -> Trace:
    """Schema validation; returns the trace so callers can chain it.

    Raises ``ValueError`` on any violation: unsupported version, empty
    stream, duplicate rids, unsorted or negative arrivals (the scheduler's
    arrival queue pops in (arrival, rid) order — an unsorted trace would
    replay in a different admission order than it records), empty prompts,
    out-of-vocab tokens, non-positive decode budgets, unknown quality
    levels."""
    if trace.version != TRACE_VERSION:
        raise ValueError(f"unsupported trace version {trace.version} "
                         f"(this reader speaks {TRACE_VERSION})")
    if not trace.events:
        raise ValueError("empty trace")
    seen_rids = set()
    prev = None
    for e in trace.events:
        if e.rid in seen_rids:
            raise ValueError(f"duplicate rid {e.rid}")
        seen_rids.add(e.rid)
        if e.arrival < 0:
            raise ValueError(f"rid {e.rid}: negative arrival {e.arrival}")
        if prev is not None and (e.arrival, e.rid) < prev:
            raise ValueError(
                f"rid {e.rid}: events not sorted by (arrival, rid) — "
                "replay admission order would diverge from the recording")
        prev = (e.arrival, e.rid)
        if not e.tokens:
            raise ValueError(f"rid {e.rid}: empty prompt")
        if trace.vocab_size > 0:
            bad = [t for t in e.tokens
                   if not 0 <= t < trace.vocab_size]
            if bad:
                raise ValueError(f"rid {e.rid}: token(s) {bad[:3]} outside "
                                 f"vocab [0, {trace.vocab_size})")
        if e.new_tokens < 1:
            raise ValueError(f"rid {e.rid}: new_tokens {e.new_tokens} < 1")
        if e.quality not in _QUALITIES:
            raise ValueError(f"rid {e.rid}: unknown quality "
                             f"{e.quality!r} (one of {_QUALITIES})")
    return trace


# --------------------------------------------------------------- JSONL io
def dumps(trace: Trace) -> str:
    """The canonical serialization: header line + one event per line,
    stable key order — identical traces produce identical bytes (the
    cross-process determinism tests compare these strings directly)."""
    lines = [json.dumps(trace.header(), sort_keys=True)]
    lines.extend(json.dumps(e.to_json(), sort_keys=True)
                 for e in trace.events)
    return "\n".join(lines) + "\n"


def loads(text: str) -> Trace:
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty trace file")
    header = json.loads(lines[0])
    if header.get("format") != FORMAT_MARKER:
        raise ValueError(f"not a {FORMAT_MARKER} file "
                         f"(header: {header.get('format')!r})")
    events = [TraceEvent.from_json(json.loads(ln)) for ln in lines[1:]]
    return validate_trace(Trace(
        events=tuple(events), vocab_size=int(header.get("vocab_size", 0)),
        family=header.get("family", "dense"),
        meta=header.get("meta", {}),
        version=int(header.get("version", -1))))


def save_trace(trace: Trace, path) -> Path:
    path = Path(path)
    path.write_text(dumps(validate_trace(trace)))
    return path


def load_trace(path) -> Trace:
    return loads(Path(path).read_text())


def from_requests(requests: Sequence[Any], *, vocab_size: int = 0,
                  family: str = "dense",
                  meta: Optional[Dict[str, Any]] = None) -> Trace:
    """Build a trace from scheduler ``Request`` objects (see
    ``replay.record_requests`` for the public recorder — it handles the
    one host read per request)."""
    events: List[TraceEvent] = []
    for r, toks in requests:
        q = r.quality.name.lower() if r.quality is not None else None
        app = r.app_id if isinstance(r.app_id, (str, int)) else (
            None if r.app_id is None else str(r.app_id))
        events.append(TraceEvent(
            rid=r.rid, arrival=r.arrival, tokens=tuple(toks),
            new_tokens=r.new_tokens, quality=q, app_id=app,
            session=getattr(r, "session", None),
            modal_seed=getattr(r, "modal_seed", None)))
    events.sort(key=lambda e: (e.arrival, e.rid))
    return validate_trace(Trace(events=tuple(events),
                                vocab_size=vocab_size, family=family,
                                meta=meta or {"source": "recorded"}))
