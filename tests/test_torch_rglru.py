"""The port's hybrid family (recurrentgemma-2b: RG-LRU recurrent blocks and
local attention) against the JAX reference, on the reduced config
(4 layers R,R,A,R; window 16; float32), parameters from the reference's
``init(PRNGKey(0))`` carried across by ``convert.params_from_jax``.

Tolerances, as fractions of the largest reference value, are about three
times the largest error measured with XLA's and torch's default and
single-threaded CPU runs (ROADMAP §C):

  prefill (24-token prompts, longer than the window)
    logits 6.4e-7; att k/v 8.0e-7 / 8.6e-7; rec_conv 2.9e-6;
    rec_state 3.3e-6; the first R layer's conv/state 2.4e-7 / 3.5e-7
  one decode step from the reference's cache
    logits 3.9e-7; att k/v 6.5e-7 / 7.9e-7; rec_conv 3.3e-7;
    rec_state 2.3e-7
  six decode steps, each package from its own prefill
    logits 3.4e-5; att k/v 7.3e-7 / 8.6e-7; rec_conv 3.0e-5;
    rec_state 8.7e-6

The prefill recurrence is a log-step (Hillis-Steele) scan in the port and
``associative_scan`` in the reference; on the same float32 inputs the two
differ by 1.6e-7 (S 24) to 2.2e-7 (S 3072) of the largest value, each
1.2-1.6e-7 from a float64 sequential loop.

Serving holds the port's stack exactly when it runs the reference's model
numerics (an adapter), and the port's own model to 1.5% per request, as
``test_torch_serve.py`` does for the dense family."""
import dataclasses

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
from repro_torch.models import ModelApi, get_model
from repro_torch.models.rglru import linear_scan
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.workload import (Trace, TraceEvent, TraceSource, load_trace,
                                  save_trace)

ARCH = "recurrentgemma-2b"
MAX_SEQ = 32
CPU = torch.device("cpu")
TOL = {
    "logits": 2e-6, "k": 2.5e-6, "v": 2.5e-6, "rec_conv": 9e-6,
    "rec_state": 1e-5, "layer0": 1e-6,
    "dlogits": 1.2e-6, "dk": 2e-6, "dv": 2.5e-6, "drec_conv": 1e-6,
    "drec_state": 7e-7,
    "clogits": 1e-4, "ck": 2.5e-6, "cv": 2.5e-6, "crec_conv": 9e-5,
    "crec_state": 2.7e-5,
}


def _close(port, ref, frac, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=frac * float(np.abs(ref).max()),
                               err_msg=what)


def _leaf(path):
    return path[-1]


@pytest.fixture(scope="module")
def models():
    japi = jmodel(jget(ARCH).reduced())
    api = get_model(get_config(ARCH).reduced())
    jp = japi.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return japi, api, jp, tp


def test_reduced_config_shape():
    cfg = get_config(ARCH).reduced()
    assert cfg.family == "hybrid" and cfg.num_layers == 4
    assert cfg.local_window == 16 and cfg.block_pattern == ("R", "R", "A")


def test_params_convert_exactly(models):
    _, _, jp, tp = models
    assert [p for p, _ in T.flatten(tp)] == [
        tuple(k.key for k in p) for p, _ in
        jax.tree_util.tree_flatten_with_path(jp)[0]]
    for (path, t), j in zip(T.flatten(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), str(path))


def test_params_convert_bf16_bit_patterns():
    """The hybrid's nested tree in bfloat16 crosses leaf for leaf with
    every 16-bit pattern intact."""
    jcfg = dataclasses.replace(jget(ARCH).reduced(), param_dtype="bfloat16")
    jp = jmodel(jcfg).init(jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    flat = T.flatten(tp)
    assert len(flat) == len(jax.tree.leaves(jp)) == 20
    for (path, t), j in zip(flat, jax.tree.leaves(jp)):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), np.asarray(j).view(np.int16),
            str(path))


def test_linear_scan_matches_associative_scan():
    """The log-step scan against the reference's associative_scan on the
    same float32 inputs, and against a sequential float64 loop."""
    for S in (1, 2, 5, 24, 3072):
        rng = np.random.default_rng(S)
        a = rng.uniform(0.5, 1.0, (2, S, 64)).astype(np.float32)
        b = rng.standard_normal((2, S, 64)).astype(np.float32)
        _, jh = jax.lax.associative_scan(
            lambda c1, c2: (c2[0] * c1[0], c2[0] * c1[1] + c2[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=1)
        th = linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        h, seq = np.zeros((2, 64)), []
        for t in range(S):
            h = a[:, t].astype(np.float64) * h + b[:, t]
            seq.append(h)
        scale = np.abs(np.stack(seq, 1)).max()
        assert np.abs(th - np.asarray(jh)).max() <= 1e-6 * scale, S
        assert np.abs(th - np.stack(seq, 1)).max() <= 1e-6 * scale, S


def test_prefill_logits_and_caches(models):
    japi, api, jp, tp = models
    toks = np.random.default_rng(0).integers(0, 256, (2, 24))
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          MAX_SEQ)
    tl, tc = api.prefill(tp, {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    _close(tl, jl, TOL["logits"], "prefill logits")
    assert [p for p, _ in T.flatten(tc)] == [
        tuple(k.key for k in p) for p, _ in
        jax.tree_util.tree_flatten_with_path(jc)[0]]
    for (path, t), j in zip(T.flatten(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        _close(t, j, TOL[_leaf(path)], f"prefill cache {path}")
        _close(t[0], np.asarray(j)[0], TOL["layer0"],
               f"prefill cache {path}, first layer")


@pytest.mark.parametrize("pos", [[24, 30], [16, 33]])
def test_decode_step_same_cache(models, pos):
    """One decode step from the reference's own cache: logits and every
    leaf close; ring entries the step does not write stay bit-identical."""
    japi, api, jp, tp = models
    toks = np.random.default_rng(1).integers(0, 256, (2, 24))
    _, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         MAX_SEQ)
    tc = T.tree_map(lambda a: torch.from_numpy(np.array(a)), jc)
    tok, pos = np.array([3, 7]), np.array(pos)
    jl, jc2 = japi.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                               jnp.asarray(pos, jnp.int32), MAX_SEQ)
    tl, tc2 = api.decode_step(tp, torch.from_numpy(tok), tc,
                              torch.from_numpy(pos), MAX_SEQ)
    _close(tl, jl, TOL["dlogits"], "decode logits")
    for (path, t), j, t0 in zip(T.flatten(tc2), jax.tree.leaves(jc2),
                                T.leaves(tc)):
        j, t = np.asarray(j), t.numpy()
        if path[0] == "att":
            col = np.zeros(j.shape, bool)
            for b, p in enumerate(pos):
                col[:, b, p % j.shape[2]] = True
            np.testing.assert_array_equal(t[~col], j[~col], str(path))
            np.testing.assert_array_equal(t[~col], t0.numpy()[~col])
            t, j = t[col], j[col]
        np.testing.assert_allclose(
            t, j, rtol=0, atol=TOL["d" + _leaf(path)] * np.abs(j).max(),
            err_msg=str(path))


def test_decode_chain(models):
    """Six greedy decode steps, each package from its own prefill, the
    reference's tokens fed to both."""
    japi, api, jp, tp = models
    toks = np.random.default_rng(0).integers(0, 256, (2, 24))
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          MAX_SEQ)
    _, tc = api.prefill(tp, {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    tok = np.asarray(jnp.argmax(jl, -1))
    for s in range(6):
        pos = np.full((2,), 24 + s)
        jl, jc = japi.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                                  jnp.asarray(pos, jnp.int32), MAX_SEQ)
        tl, tc = api.decode_step(tp, torch.from_numpy(tok.copy()), tc,
                                 torch.from_numpy(pos), MAX_SEQ)
        _close(tl, jl, TOL["clogits"], f"decode logits, step {s}")
        tok = np.asarray(jnp.argmax(jl, -1))
    for (path, t), j in zip(T.flatten(tc), jax.tree.leaves(jc)):
        _close(t, j, TOL["c" + _leaf(path)], f"cache after 6 steps {path}")


# ------------------------------------------------------------------ serving

def _trace(path):
    """Four 24-token requests (longer than the window) over capacity 2:
    staggered arrivals, LOW and HIGH quality blocks."""
    rng = np.random.default_rng(13)
    events = [TraceEvent(rid=i, arrival=a, tokens=rng.integers(0, 256, 24),
                         new_tokens=n, quality=q, app_id=app, session=i)
              for i, (a, n, q, app) in enumerate([
                  (0, 5, "low", "batch"), (1, 4, "high", "chat"),
                  (3, 6, "low", "batch"), (4, 3, "high", "chat")])]
    return save_trace(Trace(events=events, vocab_size=256,
                            family="hybrid"), path)


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
def served(tmp_path_factory):
    path = _trace(tmp_path_factory.mktemp("hybrid") / "trace.jsonl")
    jcfg = jget(ARCH).reduced()
    jp = jmodel(jcfg).init(jax.random.PRNGKey(0))
    trace = jload_trace(path)
    ref = JSched(JEngine(jcfg, JServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        backend="lanes_ref"), params=jp), capacity=2).run(
        JTraceSource(trace, jcfg))
    return path, jp, ref


def _port_report(path, api, params):
    cfg = get_config(ARCH).reduced()
    trace = load_trace(path)
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        backend="lanes_ref"), params, device="cpu", api=api)
    return ContinuousScheduler(eng, capacity=2).run(
        TraceSource(trace, cfg, CPU))


def _check_shape_of_run(rep, ref):
    assert len(ref["requests"]) == 4 and ref["bursts"] > 1
    for k in ("clock_steps", "decode_steps", "bursts"):
        assert rep[k] == ref[k], k
    for k in ("capacity", "admissions", "completions", "peak_occupancy"):
        assert rep["pool"][k] == ref["pool"][k], k
    for k in ("hits", "misses", "evictions", "occupancy"):
        assert rep["extent_table"][k] == ref["extent_table"][k], k
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("tokens", "quality", "slot", "admitted_step",
                  "completed_step", "latency_steps", "queue_steps"):
            assert p[k] == r[k], (rid, k)


def test_scheduler_with_reference_numerics_is_exact(served):
    path, jp, ref = served
    rep = _port_report(path, JaxModel(get_config(ARCH).reduced()), jp)
    _check_shape_of_run(rep, ref)
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        assert p["flips"] == r["flips"] and p["errors"] == r["errors"], rid
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=1e-5)
    for s in ("kv_prefill", "kv_decode"):
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert rep["streams"][s][k] == ref["streams"][s][k], (s, k)
        np.testing.assert_allclose(rep["streams"][s]["energy_pj"],
                                   ref["streams"][s]["energy_pj"],
                                   rtol=1e-5)


def test_scheduler_with_port_model(served):
    path, jp, ref = served
    rep = _port_report(path, None, params_from_jax(
        jax.tree.map(np.asarray, jp)))
    _check_shape_of_run(rep, ref)
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("flips", "energy_pj"):
            assert p[k] == pytest.approx(r[k], rel=1.5e-2), (rid, k)
        assert abs(p["errors"] - r["errors"]) <= 3 * r["errors"] ** 0.5 + 1
    assert rep["total"]["bits_total"] == ref["total"]["bits_total"]


def test_recurrent_leaves_add_no_bits_or_energy():
    """rec_state and rec_conv are EXACT: the write plan stores them as
    they are, with no statistics, and the lifetime plan never decays
    them; only the att ring carries the column-scoped decode write."""
    from repro_torch.reliability import LifetimePlan
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, ServeConfig(max_seq=20), device="cpu")
    plan = eng.plan
    assert plan.paths == (("att", "k"), ("att", "v"), ("rec_conv",),
                          ("rec_state",))
    assert plan.leaf_levels[2:] == (None, None)
    assert plan.leaf_seq_axis == (2, 2, None, None)
    old = eng.api.init_cache(2, 20, CPU)
    new = T.tree_map(torch.clone, old)
    new["rec_state"].normal_()
    new["rec_conv"].normal_()
    stored, st = plan.write(np.array([1, 2], np.uint32), old, new,
                            eng.vectors_for_floor())
    assert stored["rec_state"] is new["rec_state"]
    h = st.host_dict()
    assert h["energy_pj"] == 0.0 and h["bits_written"] == 0
    assert h["bit_errors"] == 0
    # the unchanged att leaves are counted, and only they
    assert h["bits_total"] == 32 * (old["att"]["k"].numel()
                                    + old["att"]["v"].numel())
    life = LifetimePlan.for_tree(old, plan, ambient_k=400.0, dwell_s=1000.0)
    assert life.init_state(old).masks[2:] == (None, None)


def test_launcher_on_cpu(served, capsys):
    """``python -m repro_torch.launch.serve --arch recurrentgemma-2b
    --reduced --device cpu`` serves the hybrid trace; without
    ``--device cpu`` on a host without CUDA it raises."""
    from repro_torch.launch import serve
    path, _, ref = served
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--trace",
                str(path), "--capacity", "2"])
    out = capsys.readouterr().out
    assert (f"served 4 requests in {ref['clock_steps']} steps "
            f"({ref['bursts']} compiled decode bursts") in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", ARCH, "--reduced", "--requests", "1"])
