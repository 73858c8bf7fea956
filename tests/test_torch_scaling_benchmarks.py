"""The port's scaling benchmarks against the reference modules on the
CPU, and the port's benchmark runner.

* ``shard_scaling``: the same stream served at 1, 2 and 4 dies through
  the reference-numerics adapter (``JaxModel``) — ledgers, tokens and
  per-die energies exact against the reference's counts (energies at
  ``RTOL`` = 1e-5, float32 sums in another order), bit-identical across
  dies in the port itself, and the burst's profile free of collectives.
* ``telemetry_overhead``: the two arms' events, spans, drains per event,
  tokens and ledgers against the reference's scheduler with its
  ``Telemetry``. Timing claims are not asserted on the CPU: ``_arms``
  serves the arms; ``run`` times and asserts on the card.
* The runner: the BENCH json's metrics are each module's
  ``bench_metrics`` keys; ``--quick`` selects the reference's quick
  profile less ``retention_sweep``.
"""
import json

import numpy as np
import pytest
import torch

from benchmarks import endurance_sweep as jes
from benchmarks import run as jrun
from benchmarks import shard_scaling as jss
from benchmarks import telemetry_overhead as jto
from repro.configs import get_config as jget
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.serve import synthetic_requests as jsynthetic_requests
from repro.telemetry import Telemetry as JTelemetry
from repro_torch.benchmarks import (endurance_sweep, run as runner,
                                    shard_scaling, telemetry_overhead)
from repro_torch.configs import get_config
from repro_torch.serve import ServeConfig, ServingEngine
from test_torch_serve import ARCH
from test_torch_serving_benchmarks import engine_factory, jparams  # noqa

CPU = torch.device("cpu")
RTOL = 1e-5
#: the reference runner's --fast shard_scaling stream
SHARD_KW = dict(n=6, prompt_len=12, new_tokens=5, capacity=4,
                arrival_every=2)
DIES = (1, 2, 4)


def _ledger_close(port: dict, ref: dict) -> None:
    for k in ("bits_written", "bit_errors", "bits_total"):
        assert port[k] == ref[k], k
    np.testing.assert_allclose(port["energy_pj"], ref["energy_pj"],
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# shard_scaling
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_reports(jparams):  # noqa
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shard_scaling, "ServingEngine",
                   engine_factory(jparams, adapter=True))
        port = shard_scaling._arms(DIES, device=CPU, **SHARD_KW)
    ref = {d: jss._serve(d, **SHARD_KW) for d in DIES}
    return port, ref


@pytest.mark.parametrize("dies", DIES)
def test_shard_ledgers_and_tokens_match_the_reference(shard_reports, dies):
    port, ref = shard_reports
    _ledger_close(shard_scaling._ledger(port[dies]),
                  jss._ledger(ref[dies]))
    assert shard_scaling._tokens(port[dies]) == jss._tokens(ref[dies])
    if dies > 1:
        p, r = port[dies]["sharding"]["dies"], ref[dies]["sharding"]["dies"]
        assert len(p) == len(r) == dies
        np.testing.assert_allclose([d["energy_pj"] for d in p],
                                   [d["energy_pj"] for d in r], rtol=RTOL)


def test_shard_reports_are_bit_identical_across_dies(shard_reports):
    port, _ = shard_reports
    base = DIES[0]
    for d in DIES:
        assert shard_scaling._ledger(port[d]) == shard_scaling._ledger(
            port[base])
        assert shard_scaling._tokens(port[d]) == shard_scaling._tokens(
            port[base])


def test_burst_is_collective_free():
    """One burst on the CPU records no process-group or collective op;
    the check itself flags one."""
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, ServeConfig(max_seq=32, max_new_tokens=8),
                        device=CPU)
    names = shard_scaling.burst_events(eng, 8, 2)
    assert any("aten::" in n for n in names)
    assert shard_scaling.collective_free(names)
    assert not shard_scaling.collective_free(
        names + ["c10d::allreduce_"])
    assert not shard_scaling.collective_free(
        ["ncclDevKernel_AllReduce_Sum_f32"])
    assert not shard_scaling.collective_free(
        ["Memcpy PtoP (Device -> Device)"])


def test_burst_timing_on_the_cpu_is_eager():
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, ServeConfig(max_seq=32, max_new_tokens=8),
                        device=CPU)
    t = shard_scaling._time_bursts(eng, [4, 2], 2, 1, captured=False)
    assert sorted(t) == [2, 4] and all(v > 0 for v in t.values())


# ---------------------------------------------------------------------------
# telemetry_overhead
# ---------------------------------------------------------------------------

def _reference_telemetry_arms(n=10, prompt_len=8, new_tokens=10,
                              capacity=2):
    """The reference run()'s two arms, once each."""
    cfg = jget(ARCH).reduced()
    eng = JEngine(cfg, JServeConfig(max_seq=32,
                                    max_new_tokens=new_tokens + 2))
    reqs = jsynthetic_requests(cfg, n, prompt_len=prompt_len,
                               new_tokens=new_tokens, arrival_every=2,
                               seed=11)
    return tuple(JSched(eng, capacity=capacity, telemetry=t).run(list(reqs))
                 for t in (None, JTelemetry()))


def test_telemetry_arms_match_the_reference(jparams, monkeypatch):  # noqa
    monkeypatch.setattr(telemetry_overhead, "ServingEngine",
                        engine_factory(jparams, adapter=True))
    arms = telemetry_overhead._arms(device=CPU)
    off, on = arms["off"], arms["on"]
    assert arms["sec_off"] == arms["sec_on"] == []
    j_off, j_on = _reference_telemetry_arms()
    for k in ("events", "spans", "drains_per_event"):
        assert on["telemetry"][k] == j_on["telemetry"][k], k
    assert on["telemetry"]["drains_per_event"] == 1.0
    assert "telemetry" not in off
    for p, r in ((off, j_off), (on, j_on)):
        assert sorted(p["requests"]) == sorted(r["requests"])
        for rid in r["requests"]:
            assert p["requests"][rid]["tokens"] == r["requests"][rid][
                "tokens"], rid
        _ledger_close(p["total"], r["total"])
    # telemetry changes nothing it observes
    assert {k: off["total"][k] for k in telemetry_overhead.TOTAL_KEYS} == {
        k: on["total"][k] for k in telemetry_overhead.TOTAL_KEYS}
    fake = {"overhead_frac": 0.0, "sec_off_best": 1.0, "sec_on_best": 1.0,
            "telemetry": on["telemetry"]}
    assert set(telemetry_overhead.bench_metrics(fake)) == set(
        jto.bench_metrics(fake))


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def test_runner_registers_the_reference_modules():
    """Fifteen modules: the reference runner's, in its order; the quick
    profile is the reference's."""
    assert list(runner.BENCHES) == list(jrun.BENCHES)
    assert len(runner.BENCHES) == 15
    assert set(runner.PAPER) | set(runner.SERVING) == set(runner.BENCHES)
    quick = runner.selected(quick=True)
    assert quick == list(jrun.QUICK_BENCHES)
    assert len(quick) == 9
    assert runner.selected(only="kernel_bench", quick=True) == [
        "kernel_bench"]
    assert runner.selected() == list(runner.BENCHES)
    assert set(runner.METRIC_FNS) == set(jrun._METRIC_FNS)
    # the modules with wall-clock claims can be measured without asserting
    assert set(runner.MEASURES) == {
        n for n in runner.SERVING if hasattr(getattr(runner, n),
                                             "TIMED_CLAIMS")} == {
        "telemetry_overhead", "shard_scaling"}


#: the reference kernel_bench hook's keys, the ones that named its TPU or
#: its CPU renamed to what the port measures
KERNEL_BENCH_METRICS = {
    "tensor_mib", "fusion_traffic_reduction_x", "projected_h100_us_fused",
    "lane_path_s", "eager_oracle_s", "lane_vs_eager_speedup_x",
    "cuda_backend_s", "level_sweep_mid_s", "level_sweep_high_s",
    "level_sweep_exact_s"}


def _endurance_metrics():
    """The reference's hook over the port's result (same schema)."""
    return set(jes.bench_metrics(endurance_sweep.run(
        steps=64, shape=(8, 32), device=CPU)))


@pytest.mark.parametrize("name", ["endurance_sweep", "kernel_bench"])
def test_runner_writes_bench_metrics(tmp_path, capsys, name):
    assert runner.main(["--only", name, "--fast", "--device", "cpu",
                        "--out-dir", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,seconds,key_results"
    assert lines[1].startswith(f"{name},")
    report = json.loads((tmp_path / "BENCH_1.json").read_text())
    assert report["device"] == "cpu" and report["fast"] is True
    assert report["quick"] is False and report["only"] == name
    assert list(report["benchmarks"]) == [name]
    expected = (_endurance_metrics() if name == "endurance_sweep"
                else KERNEL_BENCH_METRICS)
    assert set(report["benchmarks"][name]["metrics"]) == expected


def test_runner_flags_a_broken_hook(monkeypatch, capsys):
    """A hook that raises falls back to the scraped scalars, flagged."""
    def broken(out):
        raise KeyError("x")
    monkeypatch.setitem(runner.METRIC_FNS, "endurance_sweep", broken)
    m = runner.metrics_for("endurance_sweep", {"a": 1, "b": {"c": 2.0}})
    assert m == {"_metrics_fallback": True, "a": 1.0, "b.c": 2.0}
    assert "endurance_sweep.bench_metrics failed" in \
        capsys.readouterr().err
