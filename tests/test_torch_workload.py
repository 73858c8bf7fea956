"""The port's workload harness against the JAX reference: the threefry
``randint`` and ``uniform`` draws bit for bit, every generated trace byte
for byte, the pressure ramp, the synthetic stream and the launcher's
``--monolithic`` and ``--shared-prefix`` prompts token for token,
recording and replay, and the report joiner."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.serve import synthetic_requests as jsynthetic
from repro.workload import build_ramp as jbuild_ramp
from repro.workload import join_reports as jjoin_reports
from repro.workload import make_workload as jmake_workload
from repro.workload.replay import flatten_report as jflatten_report
from repro.workload.trace import dumps as jdumps
from repro_torch import rng
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.priority import Priority
from repro_torch.memory import rng_streams
from repro_torch.serve import (ContinuousScheduler, ServeConfig,
                               ServingEngine, synthetic_requests)
from repro_torch.workload import (PRESETS, TraceSource, build_ramp,
                                  join_reports, load_trace, make_workload,
                                  pressure_score, record_requests,
                                  requests_from_trace, save_trace)
from repro_torch.workload.replay import flatten_report
from repro_torch.workload.trace import dumps

CPU = torch.device("cpu")
TINY = float(np.finfo(np.float32).tiny)


# ---------------------------------------------------------------------------
# the threefry draws
# ---------------------------------------------------------------------------

_BOUNDS = ([(0, get_config(a).vocab_size) for a in ARCHS]
           + [(0, 1), (0, 2), (3, 4), (0, 2 ** 16), (0, 2 ** 16 + 1),
              (-7, 2 ** 20), (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
              (-2 ** 31, 0), (5, 5), (9, -3), (2 ** 31 - 1, -2 ** 31)])


@pytest.mark.parametrize("bounds", _BOUNDS, ids=str)
def test_randint_matches_jax(bounds):
    """Every config's vocab, spans from 1 to 2^32 - 1 (past 2^16 the
    wrapping multiplier is 0), and empty spans (minval returned)."""
    lo, hi = bounds
    for i, shape in enumerate([(1,), (7,), (3, 5), (2, 1, 33), ()]):
        key = rng.fold_in(rng.PRNGKey(lo & 0xFFFF), i * 7919 + (hi & 0xFF))
        got = rng.randint(key, shape, lo, hi)
        want = np.asarray(jax.random.randint(jnp.asarray(key), shape, lo,
                                             hi))
        assert got.dtype == want.dtype == np.int32
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_randint_bounds_outside_int32_raise_as_in_jax():
    key = rng.PRNGKey(1)
    for lo, hi in [(0, 2 ** 31), (-2 ** 31 - 1, 4)]:
        with pytest.raises(OverflowError):
            jax.random.randint(jnp.asarray(key), (3,), lo, hi)
        with pytest.raises(OverflowError):
            rng.randint(key, (3,), lo, hi)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (TINY, 1.0), (-3.5, 2.25)],
                         ids=str)
def test_uniform_matches_jax(dtype, bounds):
    """Host numpy and device-op (CPU tensor) draws, bit for bit; the
    bfloat16 draw takes 8 bits of each word."""
    lo, hi = bounds
    for i, shape in enumerate([(), (9,), (4, 301)]):
        key = rng.fold_in(rng.PRNGKey(21), i)
        want = np.asarray(jax.random.uniform(
            jnp.asarray(key), shape, getattr(jnp, dtype), minval=lo,
            maxval=hi)).astype(np.float32)
        host = rng.uniform(key, shape, dtype, minval=lo, maxval=hi)
        dev = rng.uniform_t(key, shape, CPU, getattr(torch, dtype),
                            minval=lo, maxval=hi)
        assert dev.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(host.view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(dev.float().numpy().view(np.int32),
                                      want.view(np.int32))


def test_workload_stream_is_registered():
    assert rng_streams.WORKLOAD_OFFSET == 5_000_011
    names = {s.name: s for s in rng_streams.STREAMS}
    assert names["workload-event"].offset == rng_streams.WORKLOAD_OFFSET
    rng_streams.validate()


# ---------------------------------------------------------------------------
# generated traces, the ramp and the synthetic stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_presets_are_byte_identical(preset, arch, tmp_path):
    """Every preset at three seeds on the reduced config, and once at the
    full config's vocab (151,936 and 256,000), saves the reference's
    bytes."""
    cases = [(get_config(arch).reduced(), jget(arch).reduced(), s)
             for s in (0, 7, 123)]
    cases.append((get_config(arch), jget(arch), 5))
    for cfg, jcfg, seed in cases:
        got = make_workload(preset, cfg, 8, seed=seed)
        want = jmake_workload(preset, jcfg, 8, seed=seed)
        assert dumps(got) == jdumps(want)
        p = save_trace(got, tmp_path / f"{preset}-{seed}.jsonl")
        assert p.read_text() == jdumps(want)


def test_chip_smoke_preset_digests_are_the_references():
    """chip_smoke.py holds the card's generated traces against these
    sha256 digests of the reference's (qwen2.5-3b, 16 events, seed 7)."""
    import hashlib
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    jcfg = jget("qwen2.5-3b")
    want = {name: hashlib.sha256(jdumps(jmake_workload(
        name, jcfg, cs.WORKLOAD_EVENTS, seed=cs.WORKLOAD_SEED)).encode()
    ).hexdigest() for name in PRESETS}
    assert cs.PRESET_SHA256 == want


def test_preset_parameters_reach_the_draws():
    cfg, jcfg = get_config("qwen2.5-3b").reduced(), jget(
        "qwen2.5-3b").reduced()
    kw = dict(min_len=4, max_len=40, alpha=0.7, new_tokens=3)
    assert dumps(make_workload("heavy_tail", cfg, 12, 3, **kw)) == \
        jdumps(jmake_workload("heavy_tail", jcfg, 12, 3, **kw))


def test_unknown_preset_error_is_the_references():
    with pytest.raises(ValueError) as got:
        make_workload("nope", get_config("qwen2.5-3b").reduced(), 3)
    with pytest.raises(ValueError) as want:
        jmake_workload("nope", jget("qwen2.5-3b").reduced(), 3)
    assert str(got.value) == str(want.value)


def test_build_ramp_matches():
    for seed in (0, 4):
        got = build_ramp(get_config("qwen2.5-3b").reduced(), seed=seed)
        want = jbuild_ramp(jget("qwen2.5-3b").reduced(), seed=seed)
        assert [(g["mix"], g["name"], g["pressure"]) for g in got] == \
            [(w["mix"], w["name"], w["pressure"]) for w in want]
        assert [dumps(g["trace"]) for g in got] == \
            [jdumps(w["trace"]) for w in want]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b"])
def test_synthetic_stream_matches(arch):
    """Reduced and full vocab: the same prompts, arrivals, apps and
    qualities."""
    for cfg, jcfg in [(get_config(arch).reduced(), jget(arch).reduced()),
                      (get_config(arch), jget(arch))]:
        kw = dict(prompt_len=12, new_tokens=5, arrival_every=3, seed=9,
                  app_ids=("chat", None), qualities=(None, "high"))
        got = synthetic_requests(cfg, 5, device=CPU, **kw)
        want = jsynthetic(jcfg, 5, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.prompt["tokens"].numpy(),
                                          np.asarray(w.prompt["tokens"]))
            assert (g.rid, g.arrival, g.new_tokens, g.app_id, g.quality,
                    g.session) == (w.rid, w.arrival, w.new_tokens,
                                   w.app_id, w.quality, w.session)


# ---------------------------------------------------------------------------
# recording, replay and the joiner
# ---------------------------------------------------------------------------

def _engine(cfg, max_seq, new_tokens):
    return ServingEngine(cfg, ServeConfig(max_seq=max_seq,
                                          max_new_tokens=new_tokens),
                         device="cpu")


def test_recorded_stream_replays_identically(tmp_path):
    """A synthetic stream recorded, saved, loaded and replayed serves the
    original's report; the materialized list serves it too."""
    cfg = get_config("qwen2.5-3b").reduced()
    reqs = synthetic_requests(cfg, 4, device=CPU, prompt_len=8,
                              new_tokens=4, arrival_every=2,
                              app_ids=("chat", "batch"),
                              qualities=(Priority.HIGH, None))
    trace = record_requests(reqs, cfg, meta={"source": "synthetic"})
    path = save_trace(trace, tmp_path / "rec.jsonl")
    loaded = load_trace(path)
    assert dumps(loaded) == dumps(trace)
    assert pressure_score(loaded) == pressure_score(trace)
    base = ContinuousScheduler(_engine(cfg, 12, 4), capacity=2).run(reqs)
    replay = ContinuousScheduler(_engine(cfg, loaded.max_seq(), 4),
                                 capacity=2).run(
        TraceSource(loaded, cfg, CPU))
    listed = ContinuousScheduler(_engine(cfg, loaded.max_seq(), 4),
                                 capacity=2).run(
        requests_from_trace(loaded, cfg, CPU))
    assert replay == base and listed == base


def test_flatten_and_join_match_the_reference():
    """One served report (with the lifetime ledger) through the port's
    joiner and the reference's: the same table."""
    cfg = get_config("qwen2.5-3b").reduced()
    trace = make_workload("chat_batch", cfg, 4, seed=2)
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        retention_scale=1000.0, ambient_k=400.0), device="cpu")
    rep = ContinuousScheduler(eng, capacity=2).run(
        TraceSource(trace, cfg, CPU))
    assert "lifetime" in rep
    assert flatten_report(rep) == jflatten_report(rep)
    entries = [{"mix": 1, "name": "chat_batch",
                "pressure": pressure_score(trace), "arm": arm,
                "report": rep} for arm in ("a", "b")]
    assert join_reports(entries) == jjoin_reports(entries)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _report_lines(out: str):
    """The served report: every line after the ``workload:`` one."""
    lines = out.splitlines()
    i = next(i for i, ln in enumerate(lines) if ln.startswith("workload:"))
    return lines[i], lines[i + 1:]


def test_launcher_workload_record_and_replay(tmp_path, capsys):
    from repro_torch.launch import serve
    path = tmp_path / "bursty.jsonl"
    serve.main(["--reduced", "--device", "cpu", "--workload", "bursty",
                "--requests", "6", "--workload-seed", "7", "--capacity",
                "2", "--trace-record", str(path)])
    head, gen = _report_lines(capsys.readouterr().out)
    assert head.startswith("workload: workload bursty (seed 7), 6 events, "
                           "pressure=")
    jtrace = jmake_workload("bursty", jget("qwen2.5-3b").reduced(), 6,
                            seed=7)
    assert path.read_text() == jdumps(jtrace)
    assert head.endswith(f"pressure={pressure_score(load_trace(path)):.4f}")
    serve.main(["--reduced", "--device", "cpu", "--trace", str(path),
                "--capacity", "2"])
    head2, rep = _report_lines(capsys.readouterr().out)
    assert head2 == head.replace("workload bursty (seed 7)",
                                 f"trace {path}")
    assert rep == gen and any(ln.startswith("served 6 requests")
                              for ln in rep)
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--trace", str(path),
                    "--workload", "steady"])
    assert "mutually exclusive" in capsys.readouterr().err


def test_launcher_prompts_are_the_references(monkeypatch, capsys):
    """``--monolithic`` draws its batch from ``PRNGKey(0)``, and
    ``--shared-prefix`` its common head from ``PRNGKey(1234)``, over the
    reference's synthetic stream."""
    from repro_torch.launch import serve
    seen = {}
    generate, run = ServingEngine.generate, ContinuousScheduler.run

    def spy_generate(self, batch, *a, **kw):
        seen["batch"] = batch["tokens"].clone()
        return generate(self, batch, *a, **kw)

    def spy_run(self, reqs, *a, **kw):
        seen["reqs"] = [r.prompt["tokens"].clone() for r in reqs]
        return run(self, reqs, *a, **kw)

    monkeypatch.setattr(ServingEngine, "generate", spy_generate)
    monkeypatch.setattr(ContinuousScheduler, "run", spy_run)
    jcfg = jget("qwen2.5-3b").reduced()
    serve.main(["--reduced", "--device", "cpu", "--monolithic", "--batch",
                "3", "--prompt-len", "5", "--new-tokens", "2"])
    np.testing.assert_array_equal(seen["batch"].numpy(), np.asarray(
        jax.random.randint(jax.random.PRNGKey(0), (3, 5), 0,
                           jcfg.vocab_size)))
    serve.main(["--reduced", "--device", "cpu", "--shared-prefix", "6",
                "--requests", "3", "--prompt-len", "10", "--new-tokens",
                "2", "--capacity", "2"])
    shared = jax.random.randint(jax.random.PRNGKey(1234), (1, 6), 0,
                                jcfg.vocab_size)
    want = [jnp.concatenate([shared, r.prompt["tokens"][:, 6:]], axis=1)
            for r in jsynthetic(jcfg, 3, prompt_len=10, new_tokens=2,
                                arrival_every=2)]
    assert len(seen["reqs"]) == 3
    for g, w in zip(seen["reqs"], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert "workload: synthetic, 3 events, pressure=" in \
        capsys.readouterr().out


def test_generated_trace_of_another_family_is_refused():
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              family="vlm")
    trace = make_workload("steady", get_config("qwen2.5-3b").reduced(), 2)
    # a generated trace carries no modal_seed: a vlm can neither replay
    # nor record it, as in the reference
    with pytest.raises(ValueError, match="needs a modal_seed"):
        requests_from_trace(trace, cfg, CPU)
    reqs = requests_from_trace(trace, get_config("qwen2.5-3b").reduced(),
                               CPU)
    with pytest.raises(ValueError, match="without a modal_seed"):
        record_requests(reqs, cfg)
    assert json.loads(dumps(trace).splitlines()[0])["meta"]["preset"] == \
        "steady"
