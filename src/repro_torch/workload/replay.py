"""Trace <-> scheduler adapters: replay, recording and the report joiner.

The counterpart of ``repro.workload.replay``. ``TraceSource`` answers
"when does the next request arrive" from host metadata and materializes a
request's prompt tensors only when the scheduler pops it; a vlm or audio
prompt's non-token leaf is regenerated from the event's ``modal_seed``
with the synthetic stream's recipe (same key, shape and bits). Admission order is (arrival, rid), as in
the reference, which is what keeps replay bit-comparable across packages.

``record_requests`` is the inverse: any request stream (the synthetic
default included) becomes a trace, so any run is replayable. One host
read per request, in eager code before serving.

``flatten_report`` / ``join_reports`` merge per-mix serve reports into
one flat table of scalars, as the reference's do.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core.priority import Priority
from repro_torch.serve.scheduler import MODAL_FAMILIES, Request, modal_leaves
from repro_torch.workload.trace import (Trace, TraceEvent, from_requests,
                                        validate_trace)


def _materialize(ev: TraceEvent, cfg, device,
                 quality_override: Optional[str] = None) -> Request:
    prompt = {"tokens": torch.tensor([list(ev.tokens)], dtype=torch.int64,
                                     device=device)}
    if cfg.family in MODAL_FAMILIES:
        if ev.modal_seed is None:
            raise ValueError(
                f"rid {ev.rid}: family {cfg.family!r} needs a modal_seed "
                "to regenerate non-token prompt leaves")
        prompt.update(modal_leaves(cfg, ev.modal_seed, device))
    q = quality_override if quality_override is not None else ev.quality
    return Request(
        rid=ev.rid, prompt=prompt, new_tokens=ev.new_tokens,
        arrival=ev.arrival, app_id=ev.app_id,
        quality=Priority.coerce(q) if q is not None else None,
        session=ev.session, modal_seed=ev.modal_seed)


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


def requests_from_trace(trace: Trace, cfg, device,
                        quality_override: Optional[str] = None
                        ) -> List[Request]:
    """Fully materialized request list (small traces, tests); prefer
    ``TraceSource`` for serving."""
    return [_materialize(ev, cfg, device, quality_override)
            for ev in validate_trace(trace).events]


def record_requests(requests: Sequence[Request], cfg,
                    meta: Optional[Dict[str, Any]] = None) -> Trace:
    """Record a request stream as a replayable trace. Token ids cross to
    the host here: one small read per request, before serving (never
    inside the scheduler's event loop)."""
    pairs = []
    for r in requests:
        if cfg.family in MODAL_FAMILIES and r.modal_seed is None:
            raise ValueError(
                f"rid {r.rid}: cannot record a {cfg.family!r} request "
                "without a modal_seed (non-token leaves are regenerated, "
                "not serialized)")
        pairs.append((r, r.prompt["tokens"][0].tolist()))
    return from_requests(pairs, vocab_size=cfg.vocab_size,
                         family=cfg.family,
                         meta=meta or {"source": "recorded"})


# ------------------------------------------------------------ report joiner
def flatten_report(report: Dict[str, Any]) -> Dict[str, float]:
    """One serve report -> flat scalar metrics row: the total write
    ledger, latency/queue aggregates over the per-request entries, and
    whichever optional ledgers (lifetime, wear, prefix) the run carried."""
    reqs = list(report["requests"].values())
    lat = sorted(r["latency_steps"] for r in reqs)
    row: Dict[str, float] = {
        "requests": float(len(reqs)),
        "clock_steps": float(report["clock_steps"]),
        "decode_steps": float(report["decode_steps"]),
        "bursts": float(report["bursts"]),
        "energy_pj": report["total"]["energy_pj"],
        "energy_pj_per_step": (report["total"]["energy_pj"]
                               / max(1, report["clock_steps"])),
        "write_skip_rate": report["total"]["write_skip_rate"],
        "ber_realized": report["total"]["ber_realized"],
        "mean_latency_steps": sum(lat) / len(lat),
        "p95_latency_steps": float(lat[min(len(lat) - 1,
                                           int(0.95 * len(lat)))]),
        "mean_queue_steps": (sum(r["queue_steps"] for r in reqs)
                             / len(reqs)),
        "peak_occupancy": float(report["pool"]["peak_occupancy"]),
    }
    if "lifetime" in report:
        lt = report["lifetime"]
        row.update({
            "lifetime_energy_pj": lt["lifetime_energy_pj"],
            "scrub_energy_pj": lt["scrub_energy_pj"],
            "retention_flips": float(lt["retention_flips"]),
            "residual_decayed_bits": float(lt["residual_decayed_bits"]),
            "scrub_passes": float(lt["scrub_passes"]),
        })
    if "wear" in report:
        w = report["wear"]
        row.update({
            "max_group_wear": float(w["max_group_wear"]),
            "worn_groups": float(w["worn_groups"]),
            "rotations": float(w["rotations"]),
            "remap_energy_pj": w["remap_energy_pj"],
        })
    if "prefix" in report:
        p = report["prefix"]
        row.update({
            "prefix_hit_rate": p["hit_rate"],
            "linked_admissions": float(p["linked_admissions"]),
            "linked_cols": float(p["linked_cols"]),
            "prefix_net_saved_pj": p["net_energy_saved_pj"],
        })
    if "telemetry" in report:
        t = report["telemetry"]
        row.update({
            "telemetry_events": float(t["events"]),
            "telemetry_spans": float(t["spans"]),
            "telemetry_drains_per_event": t["drains_per_event"],
        })
    return row


def join_reports(entries: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-(mix, arm) serve reports into one frontier table.

    ``entries`` rows carry {mix, name, pressure, arm, report}; the joined
    table is {"columns": [...], "rows": [...]} with every row flattened
    to scalars — one table a human or the BENCH json can scan across the
    whole ramp × knob grid."""
    rows = []
    for e in entries:
        row = {"mix": e["mix"], "name": e["name"],
               "pressure": round(float(e["pressure"]), 4),
               "arm": e["arm"]}
        row.update(flatten_report(e["report"]))
        rows.append(row)
    columns: List[str] = []
    for r in rows:
        for k in r:
            if k not in columns:
                columns.append(k)
    return {"columns": columns, "rows": rows}
