"""Central metric registry and device-resident instruments.

The counterpart of ``repro.telemetry.registry``. Every counter, gauge and
histogram the serving stack emits is declared once, at import, with a
name, unit and doc line; a second declaration under the same name
raises, so two subsystems can never fight over a series. Naming follows
Prometheus conventions: ``snake_case``, a ``serve_`` prefix, counters
end in ``_total``, and the unit is in the name where it is not obvious.

``Instruments`` is the runtime half. Host metadata (admissions, queue
depth, the clock) are plain Python floats. Hot-path metrics (write
energy, flips, bit errors) are not accumulated here at all: the device
``WriteStats`` accumulators the scheduler already carries ARE the
instruments. ``bind()`` registers a provider returning a device scalar
of those accumulators (or a tuple of them, summed on the host), and
``drain()``, once per scheduler event, *captures* references to every
bound provider's value: no op, no transfer, no wait. The accumulators
are rebuilt, never written in place, so each capture pins its event's
value. ``resolve()`` lands every queued capture after the run through
``land``: one stacked float64 tensor, one device-to-host copy (in torch
a ``float(t)`` per scalar would be a sync each, with no cached host
value to fall back on).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

_KINDS = (COUNTER, GAUGE, HISTOGRAM)


def _tensors(v) -> Iterable[torch.Tensor]:
    """The device scalars inside a captured value (a tensor, or a tuple
    provider's parts)."""
    if isinstance(v, (tuple, list)):
        for x in v:
            yield from _tensors(x)
    elif isinstance(v, torch.Tensor):
        yield v


def land(refs: Iterable[Any]) -> Dict[int, float]:
    """Bring every distinct tensor of ``refs`` to the host in ONE
    device-to-host transfer; returns ``{id(tensor): float}``. Each
    tensor is cast to float64 (exact for float32 energies and for
    counts below 2^53), the casts are stacked per dtype and joined, and
    the result crosses with one ``.cpu()``. Non-tensor refs are skipped:
    callers read them as they are."""
    uniq: Dict[int, torch.Tensor] = {}
    for t in refs:
        if isinstance(t, torch.Tensor):
            uniq.setdefault(id(t), t)
    if not uniq:
        return {}
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for k, t in uniq.items():
        by_dtype.setdefault(t.dtype, []).append(k)
    keys = [k for ks in by_dtype.values() for k in ks]
    flat = torch.cat([torch.stack([uniq[k].reshape(()) for k in ks])
                      .to(torch.float64) for ks in by_dtype.values()])
    # repro_torch: allow(no-host-sync-in-burst): the one end-of-run landing
    return dict(zip(keys, flat.cpu().tolist()))


def landed_value(v, landed: Dict[int, float]) -> float:
    """A captured value's host float: a tensor's landed value, a tuple
    provider's parts summed on the host, or a host number as it is."""
    if isinstance(v, (tuple, list)):
        return float(sum(landed_value(x, landed) for x in v))
    if isinstance(v, torch.Tensor):
        return landed[id(v)]
    return float(v)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One declared metric: the registry row."""
    name: str
    kind: str
    unit: str
    doc: str
    buckets: Optional[Tuple[float, ...]] = None  # histogram upper edges

    def __post_init__(self):
        assert self.kind in _KINDS, self.kind
        if self.kind == HISTOGRAM:
            assert self.buckets, f"histogram {self.name} needs buckets"
            assert list(self.buckets) == sorted(set(self.buckets)), \
                f"histogram {self.name} buckets must be strictly increasing"
        else:
            assert self.buckets is None, \
                f"{self.kind} {self.name} cannot carry buckets"


class MetricRegistry:
    """Declare-once metric namespace. Collisions raise immediately: at
    import time for the module-level ``REGISTRY`` below."""

    def __init__(self):
        self._specs: Dict[str, MetricSpec] = {}

    def _declare(self, spec: MetricSpec) -> MetricSpec:
        if spec.name in self._specs:
            raise ValueError(
                f"metric {spec.name!r} already declared "
                f"({self._specs[spec.name].kind}); registry names are "
                f"declare-once")
        self._specs[spec.name] = spec
        return spec

    def counter(self, name: str, unit: str, doc: str) -> MetricSpec:
        if not name.endswith("_total"):
            raise ValueError(
                f"counter {name!r} must end in '_total' (monotone series "
                f"are named as such so dashboards can rate() them)")
        return self._declare(MetricSpec(name, COUNTER, unit, doc))

    def gauge(self, name: str, unit: str, doc: str) -> MetricSpec:
        return self._declare(MetricSpec(name, GAUGE, unit, doc))

    def histogram(self, name: str, unit: str, doc: str,
                  buckets: Sequence[float]) -> MetricSpec:
        return self._declare(MetricSpec(name, HISTOGRAM, unit, doc,
                                        tuple(float(b) for b in buckets)))

    def spec(self, name: str) -> MetricSpec:
        return self._specs[name]

    def specs(self) -> Dict[str, MetricSpec]:
        return dict(self._specs)

    def validate(self) -> None:
        """Cross-row invariants: every row has a unit and a doc."""
        for s in self._specs.values():
            assert s.name.isidentifier() or "_" in s.name, s.name
            assert s.unit, f"metric {s.name} has no unit"
            assert s.doc, f"metric {s.name} has no doc"


#: The process-wide registry: every serving metric is declared here,
#: under the reference's names, units, docs and buckets.
REGISTRY = MetricRegistry()

# --- host-side counters (scheduler control-path metadata) -------------
REGISTRY.counter("serve_events_total", "events",
                 "scheduler loop events (one instrument drain each)")
REGISTRY.counter("serve_admissions_total", "requests",
                 "requests admitted into the slot pool")
REGISTRY.counter("serve_completions_total", "requests",
                 "requests retired with their token budget spent")
REGISTRY.counter("serve_bursts_total", "bursts",
                 "compiled decode bursts dispatched")
REGISTRY.counter("serve_decode_steps_total", "steps",
                 "decode steps executed across all bursts")
REGISTRY.counter("serve_scrub_passes_total", "passes",
                 "background corrective-scrub passes run")
REGISTRY.counter("serve_wear_rotations_total", "rotations",
                 "wear-leveling remap rotations")
REGISTRY.counter("serve_cow_events_total", "events",
                 "prefix-cache copy-on-write detaches")
REGISTRY.counter("serve_prefix_linked_total", "admissions",
                 "admissions that linked a cached prompt prefix")

# --- gauges (sampled once per scheduler event) ------------------------
REGISTRY.gauge("serve_pool_occupancy", "slots",
               "occupied slots at the event boundary")
REGISTRY.gauge("serve_queue_depth", "requests",
               "requests arrived but not yet admitted")
REGISTRY.gauge("serve_clock_steps", "steps",
               "the serving clock (decode steps since run start)")
REGISTRY.gauge("serve_ambient_k", "K",
               "die ambient temperature driving the retention model")

# --- device-resident counters (bound to WriteStats accumulators) ------
REGISTRY.counter("serve_prefill_energy_pj_total", "pJ",
                 "admission prefill write energy (device accumulator)")
REGISTRY.counter("serve_decode_energy_pj_total", "pJ",
                 "decode-burst write energy (device accumulator)")
REGISTRY.counter("serve_scrub_energy_pj_total", "pJ",
                 "background scrub write energy (device accumulator)")
REGISTRY.counter("serve_remap_energy_pj_total", "pJ",
                 "wear-rotation migration write energy (device)")
REGISTRY.counter("serve_flips_total", "bits",
                 "bit transitions driven (prefill + decode, device)")
REGISTRY.counter("serve_bit_errors_total", "bits",
                 "approximation write errors realized (device)")
REGISTRY.counter("serve_retention_flips_total", "bits",
                 "stored bits lost to retention decay (device)")

# --- request-latency histograms (observed at completion) --------------
REGISTRY.histogram("serve_request_latency_steps", "steps",
                   "arrival->completion latency per request",
                   buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
REGISTRY.histogram("serve_request_queue_steps", "steps",
                   "arrival->admission queue wait per request",
                   buckets=(0, 1, 2, 4, 8, 16, 32, 64))
REGISTRY.histogram("serve_burst_steps", "steps",
                   "decode steps per compiled burst",
                   buckets=(1, 2, 4, 8, 16, 32, 64))

REGISTRY.validate()


class Instruments:
    """Runtime instrument surface over a registry.

    Host ops (``inc``/``set``/``observe``) touch plain Python numbers.
    Device metrics are *bound*, not pushed: ``bind(name, provider)``
    where ``provider()`` returns a device scalar of an existing
    accumulator; ``drain()`` captures all of them, ``resolve()`` lands
    every queued drain in one transfer. ``drains`` counts the per-event
    drains so tests can audit the one-drain-per-event contract.
    """

    def __init__(self, registry: Optional[MetricRegistry] = None):
        self.registry = registry if registry is not None else REGISTRY
        self._host: Dict[str, float] = {}
        self._hist: Dict[str, Dict[str, Any]] = {}
        self._bound: Dict[str, Callable[[], Any]] = {}
        self._bound_last: Dict[str, float] = {}
        self._queue: List[Any] = []  # (row, captured refs) per drain
        self.drains = 0

    # ------------------------------------------------------------ host ops
    def _spec(self, name: str, kind: str) -> MetricSpec:
        s = self.registry.spec(name)  # KeyError = undeclared metric
        if s.kind != kind:
            raise ValueError(f"{name} is a {s.kind}, not a {kind}")
        return s

    def inc(self, name: str, value: float = 1.0) -> None:
        self._spec(name, COUNTER)
        if value < 0:
            raise ValueError(f"counter {name} cannot decrease")
        self._host[name] = self._host.get(name, 0.0) + value

    def set(self, name: str, value: float) -> None:
        self._spec(name, GAUGE)
        self._host[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        s = self._spec(name, HISTOGRAM)
        h = self._hist.get(name)
        if h is None:
            h = self._hist[name] = {
                "counts": [0] * (len(s.buckets) + 1), "sum": 0.0,
                "count": 0}
        # bucket edges are inclusive upper bounds (Prometheus `le`)
        h["counts"][bisect.bisect_left(s.buckets, value)] += 1
        h["sum"] += float(value)
        h["count"] += 1

    # --------------------------------------------------------- device side
    def bind(self, name: str, provider: Callable[[], Any]) -> None:
        """Register a device-scalar provider for ``name``: evaluated at
        each ``drain()``, it returns a device scalar or a flat tuple of
        them whose host-side SUM is the metric value. It must return
        references to tensors that are never written in place later."""
        self.registry.spec(name)  # KeyError = undeclared metric
        self._bound[name] = provider

    def drain(self) -> Dict[str, float]:
        """One per-event drain: snapshot the host metrics into a row and
        capture references to every bound device metric. Bookkeeping
        only: no op, no transfer, no wait. ``resolve()`` completes the
        returned row in place."""
        row = dict(self._host)
        if self._bound:
            self._queue.append(
                (row, {n: fn() for n, fn in self._bound.items()}))
        self.drains += 1
        return row

    def pending(self) -> Iterable[torch.Tensor]:
        """Every tensor the queued drains captured."""
        for _, vals in self._queue:
            for v in vals.values():
                yield from _tensors(v)

    def resolve(self, landed: Optional[Dict[int, float]] = None) -> None:
        """Complete every queued drain's row with its event-time device
        values. ``landed`` is a ``land`` result that already holds them
        (``Telemetry.finalize`` shares one transfer with the spans);
        without it this lands the queue itself, in one transfer."""
        if not self._queue:
            return
        if landed is None:
            landed = land(self.pending())
        for row, vals in self._queue:
            row.update({n: landed_value(v, landed) for n, v in vals.items()})
        self._bound_last = {n: self._queue[-1][0][n] for n in self._bound}
        self._queue.clear()

    def sample(self) -> Dict[str, float]:
        """The current sample row without touching the device (the last
        resolved values for bound metrics)."""
        row = dict(self._host)
        row.update(self._bound_last)
        return row

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict summary for the serve report and the exporters."""
        counters, gauges = {}, {}
        for name, v in sorted(self.sample().items()):
            kind = self.registry.spec(name).kind
            (counters if kind == COUNTER else gauges)[name] = v
        hists = {}
        for name, h in sorted(self._hist.items()):
            s = self.registry.spec(name)
            hists[name] = {"buckets": list(s.buckets),
                           "counts": list(h["counts"]),
                           "sum": h["sum"], "count": h["count"]}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "drains": self.drains}
