"""The port's serving stack against the JAX reference on the committed
trace fixture (capacity 2): the reference reports 4 requests in 8 steps
with 5 bursts.

Two ways to hold it:

* **Reference numerics through the port's stack.** The port's engine is
  given the JAX model's prefill/decode (an adapter moving arrays through
  numpy). Everything else — slot pool, scheduler, EXTENT table, write
  plan, threefry schedule, lane twin, stats — is the port's. Tokens,
  per-request flips and errors, table hits and the step/burst counts are
  exact; energies at rtol=1e-5 (float32 sums in another order).
* **The port's own model.** Flip counts are popcounts of stored float32
  bits, so they can only be exact when the KV values are; the port's
  model differs from XLA's in the last bits (see test_torch_models.py).
  Tokens and the step/burst/table counts stay exact; flips and energies
  are held at 1.5% per request (largest measured: 0.61% and 0.52%, the
  last request). Error counts are draws over those flips, so they are
  held to three Poisson standard deviations of the reference's count
  (largest measured: 1.2, the last request; the HIGH-quality request
  fails 16 of 62k flips)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import get_model as jmodel
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.workload import TraceSource as JTraceSource
from repro.workload import load_trace as jload_trace
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import ModelApi
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.workload import TraceSource, load_trace

FIXTURE = "tests/fixtures/trace_smoke.jsonl"
ARCH = "qwen2.5-3b"
CPU = torch.device("cpu")


def _to_torch(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return T.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


class JaxModel(ModelApi):
    """The port's ModelApi with prefill/decode computed by the JAX model
    (jitted, as the reference engine runs it)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.japi = jmodel(jget(ARCH).reduced())
        self._prefill = jax.jit(self.japi.prefill, static_argnums=2)
        self._decode = jax.jit(self.japi.decode_step, static_argnums=4)

    def prefill(self, params, batch, max_seq):
        tokens = jnp.asarray(batch["tokens"].numpy(), jnp.int32)
        logits, cache = self._prefill(params, {"tokens": tokens}, max_seq)
        return torch.from_numpy(np.array(logits)), _to_torch(cache)

    def decode_step(self, params, token, cache, pos, max_seq):
        logits, cache = self._decode(
            params, jnp.asarray(token.numpy(), jnp.int32), _to_jax(cache),
            jnp.asarray(pos.numpy(), jnp.int32), max_seq)
        return torch.from_numpy(np.array(logits)), _to_torch(cache)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget(ARCH).reduced()
    jp = jmodel(jcfg).init(jax.random.PRNGKey(0))
    trace = jload_trace(FIXTURE)
    jscfg = JServeConfig(max_seq=trace.max_seq(),
                         max_new_tokens=trace.max_new_tokens(),
                         backend="lanes_ref")
    ref = JSched(JEngine(jcfg, jscfg, params=jp), capacity=2).run(
        JTraceSource(trace, jcfg))
    return jp, ref, trace


def _serve_port(api, params, path, capacity=2, **kw):
    cfg = get_config(ARCH).reduced()
    trace = load_trace(path)
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        **kw), params, device="cpu", api=api)
    return ContinuousScheduler(eng, capacity=capacity).run(
        TraceSource(trace, cfg, CPU))


def _check_shape_of_run(rep, ref):
    assert ref["clock_steps"] == 8 and ref["bursts"] == 5
    assert len(ref["requests"]) == 4
    for k in ("clock_steps", "decode_steps", "bursts"):
        assert rep[k] == ref[k], k
    for k in ("capacity", "admissions", "completions", "peak_occupancy"):
        assert rep["pool"][k] == ref["pool"][k], k
    for k in ("hits", "misses", "evictions", "occupancy"):
        assert rep["extent_table"][k] == ref["extent_table"][k], k
    assert sorted(rep["requests"]) == sorted(ref["requests"])
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("tokens", "quality", "slot", "admitted_step",
                  "completed_step", "latency_steps", "queue_steps"):
            assert p[k] == r[k], (rid, k)


def test_scheduler_with_reference_numerics_is_exact(setup):
    jp, ref, _ = setup
    cfg = get_config(ARCH).reduced()
    rep = _serve_port(JaxModel(cfg), jp, FIXTURE, backend="lanes_ref")
    _check_shape_of_run(rep, ref)
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        assert p["flips"] == r["flips"] and p["errors"] == r["errors"], rid
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=1e-5)
    for k in ("bits_written", "bits_total", "bit_errors"):
        assert rep["total"][k] == ref["total"][k], k
    for s in ("kv_prefill", "kv_decode"):
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert rep["streams"][s][k] == ref["streams"][s][k], (s, k)
        np.testing.assert_allclose(rep["streams"][s]["energy_pj"],
                                   ref["streams"][s]["energy_pj"],
                                   rtol=1e-5)
        assert rep["streams"][s]["latency_ns"] == pytest.approx(
            ref["streams"][s]["latency_ns"], rel=1e-7)


def test_scheduler_with_port_model(setup):
    jp, ref, _ = setup
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rep = _serve_port(None, tp, FIXTURE, backend="lanes_ref")
    _check_shape_of_run(rep, ref)
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("flips", "energy_pj"):
            assert p[k] == pytest.approx(r[k], rel=1.5e-2), (rid, k)
        assert abs(p["errors"] - r["errors"]) <= 3 * r["errors"] ** 0.5

    assert rep["total"]["bits_total"] == ref["total"]["bits_total"]


def _batch(n=2, s=9):
    return np.random.default_rng(4).integers(0, 256, (n, s))


def test_generate_with_reference_numerics_is_exact(setup):
    jp, _, _ = setup
    jcfg = jget(ARCH).reduced()
    toks = _batch()
    jeng = JEngine(jcfg, JServeConfig(max_seq=16, max_new_tokens=6),
                   params=jp)
    jt, jrep = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)})
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, ServeConfig(max_seq=16, max_new_tokens=6),
                        jp, device="cpu", api=JaxModel(cfg))
    tt, trep = eng.generate({"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for s in ("kv_prefill", "kv_decode"):
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert trep["streams"][s][k] == jrep["streams"][s][k], (s, k)
        np.testing.assert_allclose(trep["streams"][s]["energy_pj"],
                                   jrep["streams"][s]["energy_pj"],
                                   rtol=1e-5)


def test_lockstep_pool_equals_generate(setup):
    """Admitting a whole pool at once and decoding it reproduces
    ``generate`` on the same batch bit for bit (port against itself)."""
    jp, _, _ = setup
    from repro_torch.serve import Request
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    cfg = get_config(ARCH).reduced()
    toks = _batch(3, 7)
    scfg = ServeConfig(max_seq=12, max_new_tokens=5)
    gt, grep = ServingEngine(cfg, scfg, tp, device="cpu").generate(
        {"tokens": torch.from_numpy(toks)})
    reqs = [Request(rid=i, prompt={"tokens": torch.from_numpy(toks[i:i + 1])},
                    new_tokens=5) for i in range(3)]
    rep = ContinuousScheduler(ServingEngine(cfg, scfg, tp, device="cpu"),
                              capacity=3).run(reqs)
    for i in range(3):
        assert rep["requests"][i]["tokens"] == gt[i].tolist()
    for s in ("kv_prefill", "kv_decode"):
        assert rep["streams"][s] == grep["streams"][s], s


def test_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.serve`` with ``--device cpu``: the
    fixture replay prints the reference's header line; the monolithic
    path generates and reports its ledger."""
    from repro_torch.launch import serve
    serve.main(["--reduced", "--device", "cpu", "--trace", FIXTURE,
                "--capacity", "2"])
    out = capsys.readouterr().out
    assert "served 4 requests in 8 steps (5 compiled decode bursts" in out
    assert "EXTENT table (serve): 4 hits / 0 misses" in out
    serve.main(["--reduced", "--device", "cpu", "--monolithic", "--batch",
                "2", "--prompt-len", "6", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "backend=lanes_ref" in out


def test_steady_burst_repeats_its_steps():
    """The decode-step setup the profiler and the chip smoke test time:
    every call decodes the same steps from the same prefilled pool."""
    from repro_torch.launch.profile import steady_burst
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, ServeConfig(max_seq=16), device="cpu")
    run = steady_burst(eng, batch=2, prompt_len=8)
    a, b = run(3), run(3)
    assert tuple(a[-1].shape) == (3, 2)
    torch.testing.assert_close(a[-1], b[-1], rtol=0, atol=0)
    assert a[4].host_dict() == b[4].host_dict()


# ---------------------------------------------------------------------------
# the oracle backend, soft errors and the prefix cache, through the adapter
# ---------------------------------------------------------------------------

def _serve_both(jp, path, capacity=2, **kw):
    """The reference's report and the port's (reference numerics through
    the adapter) for the trace at ``path`` with ServeConfig ``kw``."""
    jcfg = jget(ARCH).reduced()
    jtrace = jload_trace(path)
    jscfg = JServeConfig(max_seq=jtrace.max_seq(),
                         max_new_tokens=jtrace.max_new_tokens(), **kw)
    ref = JSched(JEngine(jcfg, jscfg, params=jp), capacity=capacity).run(
        JTraceSource(jtrace, jcfg))
    return ref, _serve_port(JaxModel(get_config(ARCH).reduced()), jp, path,
                            capacity, **kw)


def _check_exact(rep, ref, energy_rtol):
    """Tokens, flips, errors and strikes exact; energies to
    ``energy_rtol``."""
    assert sorted(rep["requests"]) == sorted(ref["requests"])
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("tokens", "slot", "flips", "errors"):
            assert p[k] == r[k], (rid, k)
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=energy_rtol)
    assert sorted(rep["streams"]) == sorted(ref["streams"])
    for s, r in ref["streams"].items():
        for k in ("bits_written", "bits_total", "bit_errors",
                  "soft_strikes"):
            assert rep["streams"][s][k] == r[k], (s, k)
        np.testing.assert_allclose(rep["streams"][s]["energy_pj"],
                                   r["energy_pj"], rtol=energy_rtol)


def test_oracle_backend_with_reference_numerics_is_exact(setup):
    """backend="oracle" on the fixture: the eager write draws jax.random's
    words, so tokens, flips and errors are exact. Energy: the reference
    adds each write's elements x bits terms in float32, the port rounds
    the float64 per-plane sum once (held exact against numpy in
    test_torch_approx_store.py); at this trace's writes the reference's
    sums stray up to 1.84e-5 relative (measured, request 3), so energies
    are held at 5e-5."""
    jp, _, _ = setup
    ref, rep = _serve_both(jp, FIXTURE, backend="oracle")
    _check_exact(rep, ref, 5e-5)
    assert rep["total"]["bit_errors"] > 0


@pytest.mark.parametrize("hardened", [True, False])
def test_soft_errors_with_reference_numerics_are_exact(setup, hardened):
    """soft_error_ber=1e-3 on the fixture: stored bits (so tokens, flips
    and errors of later writes) and strikes exact."""
    jp, _, _ = setup
    kw = dict(backend="lanes_ref", soft_error_ber=1e-3,
              soft_error_hardened=hardened)
    ref, rep = _serve_both(jp, FIXTURE, **kw)
    _check_exact(rep, ref, 1e-5)
    assert rep["total"]["soft_strikes"] == ref["total"]["soft_strikes"] > 0


def _shared_prefix_trace(path, n=6, shared=8, prompt_len=12):
    """``n`` 12-token prompts whose first 8 tokens are one shared head,
    arriving 2 steps apart, 4 new tokens each."""
    r = np.random.default_rng(5)
    head = r.integers(0, 256, shared).tolist()
    lines = [{"family": "dense", "format": "repro.workload.trace",
              "meta": {"preset": "shared_prefix"}, "version": 1,
              "vocab_size": 256}]
    for i in range(n):
        lines.append({"app_id": "chat" if i % 2 else "batch",
                      "arrival": 2 * i, "new_tokens": 4, "quality": "low",
                      "rid": i, "session": i, "tokens": head + r.integers(
                          0, 256, prompt_len - shared).tolist()})
    path.write_text("".join(json.dumps(d) + "\n" for d in lines))
    return str(path)


def test_prefix_cache_with_reference_numerics_is_exact(setup, tmp_path):
    """Prefix cache on (chunk 4, capacity 2) over a shared-head trace:
    links and copy-on-writes happen, and tokens, ledger counts, links,
    CoW events and saved bits equal the reference's."""
    jp, _, _ = setup
    path = _shared_prefix_trace(tmp_path / "shared.jsonl")
    kw = dict(backend="lanes_ref", prefix_cache=True, prefix_chunk=4)
    ref, rep = _serve_both(jp, path, **kw)
    _check_exact(rep, ref, 1e-5)
    p, q = rep["prefix"], ref["prefix"]
    assert p["linked_admissions"] >= 1 and p["cow_events"] >= 1
    for k in ("lookups", "hits", "misses", "evictions", "insertions",
              "stale_drops", "occupancy", "linked_admissions",
              "linked_cols", "saved_bits", "cow_events", "chunk",
              "table_size"):
        assert p[k] == q[k], k
    assert p["cam_energy_pj"] == q["cam_energy_pj"]
    # host sums of the level table's prices: to 1e-6, as the reference
    # may hold the table whose energies differ in the last bit
    for k in ("write_energy_saved_pj", "cow_energy_pj",
              "net_energy_saved_pj"):
        np.testing.assert_allclose(p[k], q[k], rtol=1e-6)


def test_prefix_cache_without_shared_prompts_changes_nothing(setup):
    """Cache on over the fixture (no shared heads): bit for bit the run
    with the cache off."""
    jp, _, _ = setup
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    off = _serve_port(None, tp, FIXTURE)
    on = _serve_port(None, tp, FIXTURE, prefix_cache=True, prefix_chunk=4)
    assert on["prefix"]["linked_admissions"] == 0
    assert on["requests"] == off["requests"]
    for s in ("kv_prefill", "kv_decode"):
        assert on["streams"][s] == off["streams"][s], s
    assert on["streams"]["kv_prefix_cow"]["energy_pj"] == 0.0


def test_launcher_prefix_soft_errors_and_oracle_on_cpu(capsys):
    """The launcher's new flags on the CPU: the prefix and soft-error
    lines print."""
    from repro_torch.launch import serve
    serve.main(["--reduced", "--device", "cpu", "--prefix-cache",
                "--shared-prefix", "8", "--soft-error-ber", "1e-4",
                "--backend", "oracle", "--requests", "4", "--capacity",
                "2", "--prompt-len", "12", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "(backend=oracle)" in out
    assert "soft errors: " in out and "(hardened driver)" in out
    assert "prefix cache (chunk 8, table 256): hits=3" in out
    assert "3 linked admissions (24 cols)" in out
