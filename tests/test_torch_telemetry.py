"""The port's telemetry (``repro_torch.telemetry`` and its hooks in the
engine and the scheduler) against the JAX reference.

* The registry declares the reference's metrics under the same names,
  units, docs and buckets, and rejects collisions and badly named
  counters.
* A drain captures references and dispatches no torch op; a captured
  accumulator keeps its drained value after the scheduler rebuilds it.
  ``Telemetry.finalize`` lands every drained and span-held device value
  through ONE call of ``registry.land`` (one ``.cpu()``).
* Telemetry is additive: on and off serve the same tokens, streams and
  ledgers on ``lanes_ref``, ``oracle`` and ``exact``; drains equal
  events.
* Serving ``trace_smoke.jsonl`` (and a shared-prefix trace with
  retention, periodic scrubbing, the prefix cache and rotating wear)
  with the reference's model numerics (the ``JaxModel`` adapter of
  test_torch_serve.py): counters, gauges, histograms, the per-event
  series and every span's name, lane, track, parent, t0, t1 and
  count-valued args are exact; energies at rtol=1e-5 (float32 sums in
  another order); table-priced host values (a copy-on-write's or a
  rotation's energy) at 1e-6, as test_torch_wear.py holds them.
* The exporters write the reference's exact strings from the same
  snapshot, and the port's Chrome trace passes both validators against
  ``tests/fixtures/timeline.schema.json``.
"""
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget
from repro.reliability import make_scrub_policy as jmake_scrub_policy
from repro.reliability import make_wear_policy as jmake_wear_policy
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.telemetry import REGISTRY as JREGISTRY
from repro.telemetry import Telemetry as JTelemetry
from repro.telemetry import export as jexport
from repro.workload import TraceSource as JTraceSource
from repro.workload import load_trace as jload_trace
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.memory import WriteStats
from repro_torch.reliability import make_scrub_policy, make_wear_policy
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.telemetry import (REGISTRY, Instruments, Lazy,
                                   MetricRegistry, SpanTracer, Telemetry,
                                   chrome_trace, metrics_json,
                                   prometheus_text, validate_timeline,
                                   write_timeline)
from repro_torch.telemetry import registry as treg
from repro_torch.workload import TraceSource, load_trace
from test_torch_serve import ARCH, FIXTURE, JaxModel, _shared_prefix_trace

CPU = torch.device("cpu")
SCHEMA = "tests/fixtures/timeline.schema.json"
RTOL = 1e-5
#: host values priced from the level table (ROADMAP §C)
RTOL_TABLE = 1e-6
#: span args that are energies (everything else is a count, a name or
#: a list of ids, held exactly)
ENERGY_ARGS = ("energy_pj", "migration_energy_pj")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_is_the_references():
    """Every declaration under the reference's name, kind, unit, doc and
    buckets."""
    ours, ref = REGISTRY.specs(), JREGISTRY.specs()
    assert list(ours) == list(ref)
    for name, s in ref.items():
        o = ours[name]
        assert (o.kind, o.unit, o.doc, o.buckets) == \
            (s.kind, s.unit, s.doc, s.buckets), name


def test_registry_rejects_collisions_and_bad_names():
    reg = MetricRegistry()
    reg.counter("x_total", "n", "a counter")
    with pytest.raises(ValueError, match="already declared"):
        reg.counter("x_total", "n", "again")
    with pytest.raises(ValueError, match="already declared"):
        reg.gauge("x_total", "n", "as a gauge")
    with pytest.raises(ValueError, match="_total"):
        reg.counter("x_count", "n", "not monotone-named")
    ins = Instruments(reg)
    with pytest.raises(ValueError, match="cannot decrease"):
        ins.inc("x_total", -1)
    with pytest.raises(KeyError):
        ins.inc("undeclared_total")
    with pytest.raises(KeyError):
        ins.bind("undeclared_total", lambda: 0)
    with pytest.raises(ValueError, match="not a gauge"):
        ins.set("x_total", 1.0)


class _OpCounter(TorchDispatchMode):
    """Counts every torch op dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _stats(energy, flips):
    return WriteStats.for_bits(
        64, CPU, energy_pj=torch.tensor(energy, dtype=torch.float32),
        flips01=torch.tensor(flips), errors=torch.tensor(flips // 4))


def test_drain_dispatches_nothing_and_pins_the_event_value():
    """A drain captures references (no op); rebuilding the accumulator
    after it, as the scheduler does (``acc = acc + st``), leaves the
    drained value as it was; resolve lands each row's own values."""
    class Holder:
        acc = _stats(1.5, 8)

    h = Holder()
    ins = Instruments()
    ins.bind("serve_prefill_energy_pj_total", lambda: h.acc.energy_pj)
    ins.bind("serve_flips_total", lambda: (h.acc.flips01, h.acc.flips10))
    with _OpCounter() as c:
        first = ins.drain()
    assert c.ops == []
    h.acc = h.acc + _stats(2.25, 5)
    with _OpCounter() as c:
        second = ins.drain()
    assert c.ops == []
    ins.resolve()
    assert first["serve_prefill_energy_pj_total"] == 1.5
    assert first["serve_flips_total"] == 8.0
    assert second["serve_prefill_energy_pj_total"] == 3.75
    assert second["serve_flips_total"] == 13.0
    assert ins.sample()["serve_flips_total"] == 13.0
    assert ins.drains == 2


def test_land_is_one_stacked_transfer_of_exact_values():
    e = torch.tensor(1.1, dtype=torch.float32)
    n = torch.tensor(2 ** 40 + 3, dtype=torch.int64)
    i = torch.tensor(-7, dtype=torch.int32)
    out = treg.land([e, n, e, 5.0, i])
    assert out == {id(e): float(np.float32(1.1)), id(n): float(2 ** 40 + 3),
                   id(i): -7.0}
    assert treg.land([3.0]) == {}


def test_lazy_span_args_land_at_finalize():
    tr = SpanTracer()
    a, b = torch.tensor(5.0), torch.tensor(2.0)
    root = tr.begin("root", 0)
    tr.complete("child", 1, 3, parent=root, raw=a,
                delta=Lazy(lambda x, y: x - y, a, b), host=Lazy(
                    lambda x, k: x * k, b, 3))
    tr.end(root, 4)
    with pytest.raises(AssertionError, match="finalize"):
        tr.snapshot()
    tr.finalize()
    args = tr.snapshot()[1]["args"]
    assert args == {"raw": 5.0, "delta": 3.0, "host": 6.0}
    assert tr.validate() == []
    assert [s.name for s in tr.roots()] == ["root"]
    assert [s.name for s in tr.children(root)] == ["child"]
    tr.complete("escapee", 2, 9, parent=root)
    assert any("escapes" in p for p in tr.validate())


# ---------------------------------------------------------------------------
# the port's own stack: additivity, drains, spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    from repro.models import get_model as jmodel
    return jmodel(jget(ARCH).reduced()).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def _serve(params, telemetry, path=FIXTURE, backend="lanes_ref",
           scrub=None, wear=None, api=None, **kw):
    """The port's scheduler over the trace at ``path`` (capacity 2)."""
    cfg = get_config(ARCH).reduced()
    trace = load_trace(path)
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        backend=backend, **kw), params, device="cpu", api=api)
    sch = ContinuousScheduler(
        eng, capacity=2, telemetry=telemetry,
        scrub_policy=make_scrub_policy("periodic", *scrub)
        if scrub else None,
        wear_policy=make_wear_policy("rotate", **wear) if wear else None)
    return sch.run(TraceSource(trace, cfg, CPU))


RET = dict(retention_scale=1000.0, ambient_k=400.0, scrub=(2, 0))


@pytest.mark.parametrize("backend", ["lanes_ref", "oracle", "exact"])
def test_telemetry_on_equals_off(tparams, backend):
    """Tokens, streams, the lifetime ledger and the request reports are
    identical with telemetry on and off; one drain per event."""
    off = _serve(tparams, None, backend=backend, **RET)
    tele = Telemetry()
    on = _serve(tparams, tele, backend=backend, **RET)
    t = on.pop("telemetry")
    assert on == off
    assert t["drains_per_event"] == 1.0
    assert t["metrics"]["drains"] == t["events"] == tele.events > 0
    assert t["metrics"]["counters"]["serve_events_total"] == t["events"]
    assert len(t["series"]) == t["events"]


def test_finalize_lands_once_and_the_run_never_lands(tparams, monkeypatch):
    """During the run no landing happens (no drain, gauge or span arg
    reads the device); the report's snapshot lands everything in one
    ``registry.land`` call."""
    calls = []
    real = treg.land

    def counted(refs):
        refs = list(refs)
        calls.append(sum(isinstance(r, torch.Tensor) for r in refs))
        return real(refs)

    monkeypatch.setattr(treg, "land", counted)
    tele = Telemetry()
    rep = _serve(tparams, tele, **RET)
    assert len(calls) == 1 and calls[0] > 0
    # idempotent: a second snapshot lands nothing more
    tele.snapshot()
    assert len(calls) == 2 and calls[1] == 0
    assert rep["telemetry"]["events"] == tele.events


def test_request_span_tree_and_background_scrub(tparams):
    tele = Telemetry()
    rep = _serve(tparams, tele, **RET)
    tr = tele.tracer
    assert tr.validate() == []
    roots = [s for s in tr.roots() if s.name.startswith("req ")]
    assert len(roots) == len(rep["requests"]) == 4
    for root in roots:
        r = rep["requests"][root.args["rid"]]
        assert (root.t0, root.t1) == (r["arrival_step"],
                                      r["completed_step"])
        assert root.args["n_tokens"] == r["n_tokens"]
        kids = [c.name for c in tr.children(root.sid)]
        assert kids[:2] == ["queue", "prefill"]
        assert set(kids[2:]) <= {"decode"}
    scrubs = [s for s in tr.spans if s.name == "scrub_pass"]
    assert len(scrubs) == rep["lifetime"]["scrub_passes"] > 0
    assert all(s.lane == "background" and s.track == "scrub"
               and s.parent is None and s.args["policy"] == "periodic"
               for s in scrubs)
    bursts = [s for s in tr.spans if s.name == "burst"]
    assert len(bursts) == rep["bursts"]
    np.testing.assert_allclose(
        sum(s.args["energy_pj"] for s in bursts),
        rep["streams"]["kv_decode"]["energy_pj"], rtol=RTOL)
    h = rep["telemetry"]["metrics"]["histograms"]
    assert h["serve_request_latency_steps"]["count"] == 4
    assert h["serve_burst_steps"]["sum"] == rep["decode_steps"]


def test_generate_with_telemetry_matches_the_reference(jparams):
    """The monolithic generate: one root with prefill and decode
    children and one event, as the reference records them."""
    cfg = get_config(ARCH).reduced()
    toks = np.random.default_rng(4).integers(0, 256, (2, 8))
    kw = dict(max_seq=16, max_new_tokens=5)
    jt, jtele = JTelemetry(), Telemetry()
    jtok, _ = JEngine(jget(ARCH).reduced(), JServeConfig(**kw),
                      params=jparams).generate(
        {"tokens": jax.numpy.asarray(toks, jax.numpy.int32)}, telemetry=jt)
    ttok, _ = ServingEngine(cfg, ServeConfig(**kw), jparams, device="cpu",
                            api=JaxModel(cfg)).generate(
        {"tokens": torch.from_numpy(toks)}, telemetry=jtele)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _check_snapshot(jtele.snapshot(), jt.snapshot())
    names = [s.name for s in jtele.tracer.spans]
    assert names == ["generate[B=2]", "prefill", "decode"]


# ---------------------------------------------------------------------------
# against the reference through the adapter
# ---------------------------------------------------------------------------

def _check_row(row, ref_row, what):
    """Energy columns at RTOL, every other column exactly."""
    assert set(row) == set(ref_row), what
    for k, v in ref_row.items():
        if "energy" in k:
            np.testing.assert_allclose(row[k], v, rtol=RTOL,
                                       err_msg=f"{what} {k}")
        else:
            assert row[k] == v, (what, k, row[k], v)


def _check_snapshot(snap, ref):
    for k in ("events", "spans", "drains_per_event"):
        assert snap[k] == ref[k], k
    m, mr = snap["metrics"], ref["metrics"]
    assert m["drains"] == mr["drains"]
    _check_row(m["counters"], mr["counters"], "counters")
    _check_row(m["gauges"], mr["gauges"], "gauges")
    assert m["histograms"] == mr["histograms"]
    assert len(snap["series"]) == len(ref["series"])
    for i, (row, rr) in enumerate(zip(snap["series"], ref["series"])):
        _check_row(row, rr, f"series[{i}]")
    assert len(snap["spans_detail"]) == len(ref["spans_detail"])
    for s, r in zip(snap["spans_detail"], ref["spans_detail"]):
        for k in ("sid", "parent", "name", "cat", "lane", "track", "t0",
                  "t1"):
            assert s[k] == r[k], (r["name"], k, s[k], r[k])
        assert set(s["args"]) == set(r["args"]), r["name"]
        for k, v in r["args"].items():
            if k in ENERGY_ARGS:
                rtol = (RTOL_TABLE if r["name"] in ("cow_detach",
                                                    "remap_rotation")
                        else RTOL)
                np.testing.assert_allclose(s["args"][k], v, rtol=rtol,
                                           err_msg=f"{r['name']} {k}")
            else:
                assert s["args"][k] == v, (r["name"], k, s["args"][k], v)


def _serve_pair(jparams, path, scrub=None, wear=None, **kw):
    """(port snapshot, reference snapshot, port report, reference report)
    of the trace at ``path`` (capacity 2) through both schedulers with
    telemetry on, the port running the reference's model numerics."""
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    kw = dict(backend="lanes_ref", **kw)
    jtrace, trace = jload_trace(path), load_trace(path)
    jt, tt = JTelemetry(), Telemetry()
    jsch = JSched(
        JEngine(jcfg, JServeConfig(max_seq=jtrace.max_seq(),
                                   max_new_tokens=jtrace.max_new_tokens(),
                                   **kw), params=jparams),
        capacity=2, telemetry=jt,
        scrub_policy=jmake_scrub_policy("periodic", *scrub)
        if scrub else None,
        wear_policy=jmake_wear_policy("rotate", **wear) if wear else None)
    ref = jsch.run(JTraceSource(jtrace, jcfg))
    rep = _serve(jparams, tt, path=path, scrub=scrub, wear=wear,
                 api=JaxModel(cfg), **kw)
    return rep["telemetry"], ref["telemetry"], rep, ref


def test_trace_smoke_telemetry_is_exact(jparams):
    snap, ref, rep, _ = _serve_pair(jparams, FIXTURE)
    _check_snapshot(snap, ref)
    assert snap["events"] > 0 and snap["spans"] > 0


@pytest.mark.parametrize("trace", ["trace_smoke", "shared_prefix"])
def test_telemetry_with_every_layer_on_is_exact(jparams, tmp_path, trace):
    """Retention at 400 K with periodic 4-column scrubs, the prefix
    cache and rotating wear, on the fixture and on a shared-prefix trace
    (links and copy-on-writes): every span kind of the reference shows
    up and matches."""
    path = (FIXTURE if trace == "trace_smoke"
            else _shared_prefix_trace(tmp_path / "shared.jsonl"))
    snap, ref, rep, _ = _serve_pair(
        jparams, path, scrub=(2, 4),
        wear=dict(check_interval=2, rotate_step=4, hot_row_wear=2),
        retention_scale=1000.0, ambient_k=400.0, prefix_cache=True,
        prefix_chunk=4, wear_policy="rotate", remap_group_cols=4)
    _check_snapshot(snap, ref)
    names = {s["name"] for s in snap["spans_detail"]}
    assert {"scrub_pass", "wear_check", "remap_rotation", "burst",
            "decode", "prefill", "queue"} <= names
    c = snap["metrics"]["counters"]
    assert c["serve_wear_rotations_total"] >= 1
    if trace == "shared_prefix":
        assert "cow_detach" in names
        assert c["serve_prefix_linked_total"] >= 1
        assert c["serve_cow_events_total"] >= 1
    assert c["serve_retention_flips_total"] == \
        rep["lifetime"]["retention_flips"]


@pytest.fixture(scope="module")
def snapshots(jparams):
    snap, ref, _, _ = _serve_pair(jparams, FIXTURE, scrub=(2, 0),
                                  retention_scale=1000.0, ambient_k=400.0)
    return snap, ref


def test_exporters_write_the_references_strings(snapshots):
    """On the SAME snapshot dict (each side's own, in turn) the port's
    exporters produce the reference's exact text and JSON."""
    for snap in snapshots:
        assert prometheus_text(snap["metrics"]) == \
            jexport.prometheus_text(snap["metrics"])
        assert metrics_json(snap) == jexport.metrics_json(snap)
        assert json.dumps(chrome_trace(snap)) == \
            json.dumps(jexport.chrome_trace(snap))


def test_timeline_passes_both_validators(snapshots, tmp_path):
    path = write_timeline(snapshots[0], tmp_path / "timeline.json")
    doc = json.loads(path.read_text())
    validate_timeline(doc, SCHEMA)
    jexport.validate_timeline(doc, SCHEMA)
    kinds = {e["ph"] for e in doc["traceEvents"]}
    assert kinds == {"M", "X", "C"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry", str(path),
         "--schema", SCHEMA], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(f"OK {path}:")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry", str(bad),
         "--schema", SCHEMA], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 1 and "INVALID" in out.stderr


def test_launcher_writes_metrics_and_timeline(tmp_path, capsys):
    from repro_torch.launch import serve
    prom, js, tl = (tmp_path / n for n in ("m.prom", "m.json", "t.json"))
    serve.main(["--reduced", "--device", "cpu", "--trace", FIXTURE,
                "--capacity", "2", "--metrics-out", str(prom),
                "--trace-timeline", str(tl)])
    out = capsys.readouterr().out
    assert "telemetry: " in out and "(1.00/event)" in out
    assert "# TYPE serve_events_total counter" in prom.read_text()
    validate_timeline(json.loads(tl.read_text()), SCHEMA)
    serve.main(["--reduced", "--device", "cpu", "--monolithic",
                "--batch", "2", "--new-tokens", "3", "--prompt-len", "4",
                "--metrics-out", str(js)])
    doc = json.loads(js.read_text())
    assert doc["events"] == 1 and doc["spans"] == 3
    assert doc["metric_specs"]["serve_events_total"]["kind"] == "counter"
