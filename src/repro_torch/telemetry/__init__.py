"""repro_torch.telemetry — device-resident metrics, span tracing, exporters.

The counterpart of ``repro.telemetry``. ``Telemetry`` is the one object
the serving stack threads around: an ``Instruments`` surface over the
declare-once ``REGISTRY``, a ``SpanTracer`` for the per-request
timeline, and the per-event sample series the Chrome trace's counter
tracks are built from. The scheduler calls ``event()`` once per
scheduler event (one drain: references captured, nothing dispatched)
and ``finalize()`` once at the end of the run, which lands every
drained and span-held device scalar in ONE device-to-host transfer
(``registry.land``).

Telemetry is strictly additive: with ``telemetry=None`` (the default
everywhere) no instrument, span or drain exists; with it on, the tokens,
the ``WriteStats``, the ledgers, the kernel launches and the key
schedule are unchanged, and no drain, gauge or span arg reads the device
during the run.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.telemetry import registry
from repro_torch.telemetry.export import (chrome_trace, metrics_json,
                                          prometheus_text, validate_json,
                                          validate_timeline, write_metrics,
                                          write_timeline)
from repro_torch.telemetry.registry import (COUNTER, GAUGE, HISTOGRAM,
                                            Instruments, MetricRegistry,
                                            MetricSpec, REGISTRY)
from repro_torch.telemetry.report import render_report
from repro_torch.telemetry.spans import (LANE_BACKGROUND, LANE_SERVE, Lazy,
                                         Span, SpanTracer)


class Telemetry:
    """The per-run telemetry context (instruments + tracer + series)."""

    def __init__(self, registry: MetricRegistry = None):
        self.instruments = Instruments(registry)
        self.tracer = SpanTracer()
        self.series = []  # one drained sample row per scheduler event
        self.events = 0

    def event(self, clock: float, **gauges: float) -> Dict[str, float]:
        """One scheduler event: set the sampled gauges (host values),
        drain the instruments, append the sample row to the series (its
        device columns land in place at ``finalize``)."""
        self.instruments.set("serve_clock_steps", clock)
        for name, v in gauges.items():
            self.instruments.set(name, v)
        self.instruments.inc("serve_events_total")
        row = self.instruments.drain()
        self.series.append(row)
        self.events += 1
        return row

    def finalize(self) -> None:
        """Land the queued drains and the device span args together, in
        one transfer, strictly after the run. Idempotent."""
        landed = registry.land([*self.instruments.pending(),
                                *self.tracer.pending()])
        self.instruments.resolve(landed)
        self.tracer.finalize(landed)

    def snapshot(self) -> Dict[str, Any]:
        """The serve-report section: everything an exporter needs."""
        self.finalize()
        drains = self.instruments.drains
        return {
            "events": self.events,
            "spans": len(self.tracer.spans),
            "drains_per_event": drains / max(self.events, 1),
            "metrics": self.instruments.snapshot(),
            "series": self.series,
            "spans_detail": self.tracer.snapshot(),
        }


__all__ = [
    "Telemetry", "Instruments", "MetricRegistry", "MetricSpec",
    "REGISTRY", "COUNTER", "GAUGE", "HISTOGRAM",
    "SpanTracer", "Span", "Lazy", "LANE_SERVE", "LANE_BACKGROUND",
    "chrome_trace", "prometheus_text", "metrics_json",
    "write_timeline", "write_metrics", "validate_json",
    "validate_timeline", "render_report",
]
