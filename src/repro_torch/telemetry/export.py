"""Telemetry exporters: Prometheus text, JSON, Chrome trace-event JSON.

A copy of ``repro.telemetry.export`` (host code), so the port's files
are byte-for-byte the reference's for the same snapshot.

The Chrome trace output is the Perfetto-compatible "JSON Array of
trace events inside an object" form: ``{"traceEvents": [...],
"displayTimeUnit": "ms"}``. The serving clock is decode steps; one step
maps to one microsecond of trace time, so a 64-step run reads as 64 us
in the Perfetto UI — relative durations (what the timeline is for) are
exact. Lanes become processes, tracks become threads, and the
once-per-event instrument drains become ``"C"`` counter tracks so energy
and occupancy plot as stepped area charts under the span rows.

``validate_json`` is a dependency-free validator for the subset of JSON
Schema the checked-in timeline schema uses (type / required /
properties / items / enum / minItems): ``python -m
repro_torch.telemetry`` validates an emitted timeline against
``tests/fixtures/timeline.schema.json`` without a jsonschema install.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.telemetry.registry import (COUNTER, GAUGE, HISTOGRAM,
                                            MetricRegistry, REGISTRY)

#: decode steps -> trace microseconds (1:1; the clock IS the step axis)
STEP_US = 1.0


# --------------------------------------------------------------- prometheus
def prometheus_text(metrics: Dict[str, Any],
                    registry: Optional[MetricRegistry] = None) -> str:
    """Render an ``Instruments.snapshot()`` metrics dict in the
    Prometheus text exposition format (HELP/TYPE + samples; histogram
    buckets are cumulative with inclusive ``le`` edges)."""
    reg = registry if registry is not None else REGISTRY
    lines: List[str] = []

    def head(name: str, kind: str) -> None:
        s = reg.spec(name)
        lines.append(f"# HELP {name} {s.doc} [{s.unit}]")
        lines.append(f"# TYPE {name} {kind}")

    for name, v in metrics.get("counters", {}).items():
        head(name, COUNTER)
        lines.append(f"{name} {v:g}")
    for name, v in metrics.get("gauges", {}).items():
        head(name, GAUGE)
        lines.append(f"{name} {v:g}")
    for name, h in metrics.get("histograms", {}).items():
        head(name, HISTOGRAM)
        cum = 0
        for edge, c in zip(h["buckets"], h["counts"]):
            cum += c
            lines.append(f'{name}_bucket{{le="{edge:g}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{name}_sum {h['sum']:g}")
        lines.append(f"{name}_count {h['count']}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------- json
def metrics_json(snapshot: Dict[str, Any],
                 registry: Optional[MetricRegistry] = None) -> str:
    """The full telemetry snapshot as JSON, each metric annotated with
    its registry unit/doc so the file is self-describing."""
    reg = registry if registry is not None else REGISTRY
    doc = dict(snapshot)
    units = {}
    for sec in ("counters", "gauges", "histograms"):
        for name in snapshot.get("metrics", {}).get(sec, {}):
            s = reg.spec(name)
            units[name] = {"unit": s.unit, "doc": s.doc, "kind": s.kind}
    doc["metric_specs"] = units
    return json.dumps(doc, indent=1, sort_keys=True, default=float)


# ------------------------------------------------------------- chrome trace
def chrome_trace(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """Build the Perfetto-loadable trace document from a telemetry
    snapshot (``Telemetry.snapshot()``: spans + per-event series)."""
    events: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}

    def pid_of(lane: str) -> int:
        if lane not in pids:
            pids[lane] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[lane], "tid": 0,
                           "args": {"name": lane}})
        return pids[lane]

    def tid_of(lane: str, track: str) -> int:
        key = (lane, track)
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid_of(lane), "tid": tids[key],
                           "args": {"name": track}})
        return tids[key]

    spans = snapshot.get("spans_detail", snapshot.get("spans"))
    for s in (spans if isinstance(spans, list) else []):
        if s.get("t1") is None:
            continue
        events.append({
            "ph": "X", "name": s["name"], "cat": s["cat"],
            "ts": s["t0"] * STEP_US,
            "dur": max((s["t1"] - s["t0"]) * STEP_US, 0.0),
            "pid": pid_of(s["lane"]), "tid": tid_of(s["lane"], s["track"]),
            "args": {k: v for k, v in s["args"].items()},
        })
    # counter tracks from the per-event sample series
    mpid = pid_of("metrics")
    for row in snapshot.get("series", []):
        ts = row.get("serve_clock_steps", 0.0) * STEP_US
        for name, v in row.items():
            if name == "serve_clock_steps":
                continue
            events.append({"ph": "C", "name": name, "ts": ts,
                           "pid": mpid, "args": {"value": v}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_timeline(snapshot: Dict[str, Any], path) -> Path:
    path = Path(path)
    path.write_text(json.dumps(chrome_trace(snapshot), default=float))
    return path


def write_metrics(snapshot: Dict[str, Any], path,
                  registry: Optional[MetricRegistry] = None) -> Path:
    """Write metrics in the format the extension implies: ``.json`` gets
    the annotated JSON document, anything else the Prometheus text."""
    path = Path(path)
    if path.suffix == ".json":
        path.write_text(metrics_json(snapshot, registry))
    else:
        path.write_text(prometheus_text(
            snapshot.get("metrics", snapshot), registry))
    return path


# ---------------------------------------------------------------- validator
def validate_json(obj: Any, schema: Dict[str, Any],
                  path: str = "$") -> None:
    """Validate ``obj`` against the JSON-Schema subset used by
    ``tests/fixtures/timeline.schema.json`` (type, required, properties,
    items, enum, minItems). Raises ValueError naming the failing path."""
    t = schema.get("type")
    if t is not None:
        checks = {"object": dict, "array": list, "string": str,
                  "integer": int, "number": (int, float),
                  "boolean": bool}
        ok = isinstance(obj, checks[t])
        if t in ("integer", "number") and isinstance(obj, bool):
            ok = False
        if not ok:
            raise ValueError(f"{path}: expected {t}, got "
                             f"{type(obj).__name__}")
    if "enum" in schema and obj not in schema["enum"]:
        raise ValueError(f"{path}: {obj!r} not in {schema['enum']}")
    if isinstance(obj, dict):
        for req in schema.get("required", ()):
            if req not in obj:
                raise ValueError(f"{path}: missing required key {req!r}")
        for k, sub in schema.get("properties", {}).items():
            if k in obj:
                validate_json(obj[k], sub, f"{path}.{k}")
    if isinstance(obj, list):
        if len(obj) < schema.get("minItems", 0):
            raise ValueError(f"{path}: fewer than "
                             f"{schema['minItems']} items")
        items = schema.get("items")
        if items:
            for i, el in enumerate(obj):
                validate_json(el, items, f"{path}[{i}]")


def validate_timeline(doc: Dict[str, Any], schema_path) -> None:
    schema = json.loads(Path(schema_path).read_text())
    validate_json(doc, schema)
