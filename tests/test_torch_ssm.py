"""The port's ssm family (mamba2-2.7b) against the JAX reference, float32
on the CPU.

* ``softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``), also above
  20 where ``F.softplus`` switches to ``x``; the causal conv and the
  chunked scan (state carried over chunks, a length the chunk does not
  divide) at a few float32 ulps.
* ``prefill`` / ``decode_step`` on the reduced config at about three
  times the measured error, as ``test_torch_models.py`` holds the dense
  family. Largest measured over prompts of 2, 12, 20 and 48 tokens
  (shorter than the conv, one chunk, a ragged single chunk, three
  chunks) from seeds 0-3, as a fraction of the reference's largest
  value: prefill logits 8.8e-6, cache 5.9e-6, its first layer 3.2e-6,
  decode logits 1.6e-6, decode cache 1.7e-6.
* Serving ``trace_smoke.jsonl`` through the port's scheduler with the
  reference's model numerics: tokens exact, 0 bits written (the state
  and conv leaves are pinned EXACT), and at 400 K with periodic
  scrubbing the reference's scrub-pass count (5, which ``chip_smoke.py``
  holds the card to) with 0 scrub energy, 0 retention flips and 0
  decayed bits.
* The cache's priority tags and ``num_params()`` (full config, from the
  descriptors alone) equal the reference's.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import get_model as jmodel
from repro.models import ssm as jssm
from repro.reliability import make_scrub_policy as jmake_scrub_policy
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.workload import TraceSource as JTraceSource
from repro.workload import load_trace as jload_trace
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import get_model
from repro_torch.models import ssm as tssm
from repro_torch.reliability import make_scrub_policy
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.workload import TraceSource, load_trace
from test_torch_sampling import JaxAdapter
from test_torch_vlm import check_cache_tags

ARCH = "mamba2-2.7b"
FIXTURE = "tests/fixtures/trace_smoke.jsonl"
CPU = torch.device("cpu")
#: fractions of the reference's largest value, ~3x the measured errors
TOL = dict(logits=2.7e-5, cache=1.8e-5, layer0=1e-5, dlogits=5e-6,
           dcache=5e-6)
#: building blocks with the same inputs: a few float32 ulps
ULPS = 2e-6
MAX_SEQ = 64


def _chip_smoke():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(port, ref, frac, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=frac * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def models():
    japi = jmodel(jget(ARCH).reduced())
    api = get_model(get_config(ARCH).reduced())
    jp = japi.init(jax.random.PRNGKey(0))
    return japi, api, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_softplus_is_logaddexp():
    x = np.concatenate([np.linspace(-60, 60, 2001),
                        [19.9, 20.0, 20.1, 25.0, 88.0]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tssm.softplus(torch.from_numpy(x)).numpy()
    # one unit in the last place (largest measured: 1.4e-7 relative)
    np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=0)


def test_causal_conv_matches():
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 11, 24)).astype(np.float32)
    w = r.normal(size=(4, 24)).astype(np.float32)
    b = r.normal(size=(24,)).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tssm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    _close(got, want, ULPS, "causal conv")


@pytest.mark.parametrize("S,chunk", [(48, 16), (20, 16), (7, 16), (16, 16)])
def test_ssd_chunked_matches(S, chunk):
    """Three chunks carry the state; 20 tokens over a chunk of 16 run as
    one chunk (the reference's fallback); a state comes in."""
    r = np.random.default_rng(S)
    B, H, P, N = 2, 4, 8, 16
    x = r.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.exp(r.normal(size=(H,))).astype(np.float32)
    B_ = r.normal(size=(B, S, N)).astype(np.float32)
    C_ = r.normal(size=(B, S, N)).astype(np.float32)
    s0 = r.normal(size=(B, H, P, N)).astype(np.float32)
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C_)), chunk,
                              state0=jnp.asarray(s0))
    ty, ts = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B_, C_)),
                              chunk, state0=torch.from_numpy(s0))
    _close(ty, jy, 3 * ULPS, "y")
    _close(ts, js, 3 * ULPS, "state")


def test_params_convert_leaf_for_leaf(models):
    japi, api, jp, tp = models
    jpaths = [tuple(k.key for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in T.flatten(tp)] == jpaths
    assert [p for p, _ in T.flatten(api.descs())] == jpaths
    for (path, t), j in zip(T.flatten(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), str(path))


def test_num_params_full_config():
    """From the descriptors alone (nothing is allocated)."""
    n = get_model(get_config(ARCH)).num_params()
    assert n == jmodel(jget(ARCH)).num_params()
    assert abs(n - 2.70e9) < 0.01e9


def test_cache_priority_tags_match():
    check_cache_tags(ARCH)


@pytest.mark.parametrize("S", [2, 12, 20, 48])
def test_prefill_and_decode_match(models, S):
    japi, api, jp, tp = models
    toks = np.random.default_rng(S).integers(0, 256, (2, S))
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          MAX_SEQ)
    tl, tc = api.prefill(tp, {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    _close(tl, jl, TOL["logits"], "prefill logits")
    for (path, t), j in zip(T.flatten(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        _close(t, j, TOL["cache"], f"prefill cache {path}")
        _close(t[0], np.asarray(j)[0], TOL["layer0"], f"layer 0 {path}")
    # decode from the reference's own cache; pos is unused by the
    # recurrence, so rows at different positions decode alike
    tc = T.tree_map(lambda a: torch.from_numpy(np.array(a)), jc)
    tok, pos = np.array([3, 7]), np.array([S, S + 5])
    jl, jc2 = japi.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                               jnp.asarray(pos, jnp.int32), MAX_SEQ)
    tl, tc2 = api.decode_step(tp, torch.from_numpy(tok), tc,
                              torch.from_numpy(pos), MAX_SEQ)
    _close(tl, jl, TOL["dlogits"], "decode logits")
    for (path, t), j in zip(T.flatten(tc2), jax.tree.leaves(jc2)):
        _close(t, j, TOL["dcache"], f"decode cache {path}")


def test_prefill_conv_handoff_pads_a_short_prompt(models):
    """Two tokens under a conv of width 4: the handoff is the two inputs
    behind one zero row, as in the reference."""
    _, api, _, tp = models
    toks = torch.tensor([[5, 9]])
    _, cache = api.prefill(tp, {"tokens": toks}, MAX_SEQ)
    assert cache["conv"].shape[2] == api.cfg.ssm_conv_width - 1
    assert torch.all(cache["conv"][:, :, 0] == 0)
    assert torch.all(cache["conv"][:, :, 1:].abs().sum(-1) > 0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

_SKW = dict(backend="lanes_ref")
#: the retention case: 1000 s of dwell a step at 400 K, a periodic
#: scrub pass every 2 steps
RETENTION = dict(retention_scale=1000.0, ambient_k=400.0)


def _run(make_eng, make_sched, source, retention):
    trace = load_trace(FIXTURE)
    kw = dict(max_seq=trace.max_seq(),
              max_new_tokens=trace.max_new_tokens(), **_SKW,
              **(RETENTION if retention else {}))
    return make_sched(make_eng(kw), retention).run(source)


@pytest.fixture(scope="module")
def references(models):
    _, _, jp, _ = models
    jcfg = jget(ARCH).reduced()
    return {ret: _run(
        lambda kw: JEngine(jcfg, JServeConfig(**kw), params=jp),
        lambda eng, ret: JSched(eng, capacity=2, scrub_policy=(
            jmake_scrub_policy("periodic", interval=2) if ret else None)),
        JTraceSource(jload_trace(FIXTURE), jcfg), ret)
        for ret in (False, True)}


def _serve_port(params, api, retention):
    cfg = get_config(ARCH).reduced()
    return _run(
        lambda kw: ServingEngine(cfg, ServeConfig(**kw), params,
                                 device="cpu", api=api),
        lambda eng, ret: ContinuousScheduler(eng, capacity=2, scrub_policy=(
            make_scrub_policy("periodic", interval=2) if ret else None)),
        TraceSource(load_trace(FIXTURE), cfg, CPU), retention)


@pytest.mark.parametrize("retention", [False, True])
def test_serving_writes_no_bit_and_matches_the_reference(models, references,
                                                        retention):
    _, _, jp, _ = models
    ref = references[retention]
    cfg = get_config(ARCH).reduced()
    rep = _serve_port(jp, JaxAdapter(cfg, ARCH), retention)
    for k in ("clock_steps", "decode_steps", "bursts"):
        assert rep[k] == ref[k], k
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("tokens", "slot", "flips", "errors"):
            assert p[k] == r[k], (rid, k)
        assert p["flips"] == 0 and p["energy_pj"] == 0.0
    for s, r in ref["streams"].items():
        assert rep["streams"][s]["bits_written"] == r["bits_written"] == 0
        assert rep["streams"][s]["energy_pj"] == 0.0
    if retention:
        lt, lr = rep["lifetime"], ref["lifetime"]
        assert lt["scrub_passes"] == lr["scrub_passes"] == \
            _chip_smoke().MAMBA2_SCRUB_PASSES
        for k in ("retention_flips", "residual_decayed_bits"):
            assert lt[k] == lr[k] == 0, k
        assert lt["scrub_energy_pj"] == lr["scrub_energy_pj"] == 0.0


def test_port_model_serves_the_same_tokens(models, references):
    """The port's own model (not the adapter): the reference's tokens on
    the fixture, still 0 bits written."""
    _, _, _, tp = models
    ref = references[False]
    rep = _serve_port(tp, None, False)
    for rid, r in ref["requests"].items():
        assert rep["requests"][rid]["tokens"] == r["tokens"], rid
    assert rep["total"]["energy_pj"] == 0.0


def test_reduced_config_is_the_references():
    a, b = get_config(ARCH).reduced(), jget(ARCH).reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
