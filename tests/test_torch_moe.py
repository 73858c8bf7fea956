"""The port's MoE family (dbrx-132b, llama4-scout) against the JAX
reference, float32 on the CPU.

* ``moe_apply`` on the reduced configs (dbrx top-2, llama4-scout top-1
  over 4 experts), drop-free and at capacity factor 0.25 (dbrx drops 32
  of 64 assignments): ``dropped`` exact, the output within 1.5e-6 and
  ``lb_loss`` within 4e-7 of the reference's largest value (largest
  measured over five seeds: 4.9e-7 and 1.2e-7; the expert products sum
  in another order).
* Ties in the router: ``top_k`` orders equal probabilities by expert
  index, lower first, as ``lax.top_k`` does, so tied tokens route and
  drop as in the reference.
* Dropped assignments gather past the capacity; the port clamps that
  index (torch would raise on it) and masks the value, as the reference
  does.
* ``prefill`` / ``decode_step`` at about three times the measured error,
  as ``test_torch_models.py`` holds the dense family.
* Serving ``trace_smoke.jsonl`` on reduced dbrx-132b: through the
  reference's model numerics tokens, flips and errors are exact; with the
  port's own model tokens are exact and flips and energy within 1.5% per
  request (largest measured: 0.45% and 0.39%).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import get_model as jmodel
from repro.models import moe as jmoe
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.workload import TraceSource as JTraceSource
from repro.workload import load_trace as jload_trace
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.workload import TraceSource, load_trace
from test_torch_sampling import JaxAdapter

FIXTURE = "tests/fixtures/trace_smoke.jsonl"
CPU = torch.device("cpu")
ARCHS = ["dbrx-132b", "llama4-scout-17b-a16e"]
#: moe_apply: output and lb_loss, as fractions of the reference's largest
Y_TOL, LB_TOL = 1.5e-6, 4e-7
#: per architecture, as in test_torch_models.py: prefill logits, prefill
#: cache, its first layer, decode logits, decode column. Largest measured
#: over prompts drawn from seeds 0-3 (one thread or the default):
#:   dbrx-132b              1.2e-5  1.3e-5  3.3e-7  2.9e-6  1.7e-6
#:   llama4-scout-17b-a16e  7.1e-5  2.5e-5  3.3e-7  2.2e-5  7.7e-6
TOL = {
    "dbrx-132b": dict(logits=3.5e-5, cache=4e-5, layer0=1e-6,
                      dlogits=9e-6, column=5e-6),
    "llama4-scout-17b-a16e": dict(logits=2.2e-4, cache=7.5e-5, layer0=1e-6,
                                  dlogits=6.5e-5, column=2.3e-5),
}
MAX_SEQ = 20


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jget(arch).reduced(), **kw))


def _moe_params(cfg, seed):
    r = np.random.default_rng(seed)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {"router": r.normal(size=(D, E)).astype(np.float32) * 0.3,
            "wi_gate": r.normal(size=(E, D, F)).astype(np.float32) * 0.1,
            "wi_up": r.normal(size=(E, D, F)).astype(np.float32) * 0.1,
            "wo": r.normal(size=(E, F, D)).astype(np.float32) * 0.1}


def _both(p, x, cfg, jcfg):
    ty, ta = tmoe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfg)
    jy, ja = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jcfg, jnp.float32)
    return ty, ta, np.asarray(jy), ja


def _check(ty, ta, jy, ja):
    assert int(ta["dropped"]) == int(ja["dropped"])
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=Y_TOL * np.abs(jy).max())
    lb = float(ja["lb_loss"])
    assert abs(float(ta["lb_loss"]) - lb) <= LB_TOL * abs(lb)


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches(arch, capacity_factor):
    kw = {} if capacity_factor is None else dict(
        capacity_factor=capacity_factor)
    cfg, jcfg = _cfgs(arch, **kw)
    drops = []
    for seed in range(3):
        p = _moe_params(cfg, seed)
        x = np.random.default_rng(100 + seed).normal(
            size=(2, 16, cfg.d_model)).astype(np.float32)
        ty, ta, jy, ja = _both(p, x, cfg, jcfg)
        _check(ty, ta, jy, ja)
        drops.append(int(ta["dropped"]))
    assert (max(drops) > 0) == (capacity_factor is not None), drops


def test_capacity_is_the_references():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget(arch)
        for t in (1, 4, 7, 256, 1000):
            assert tmoe.capacity_for(cfg, t) == jmoe.capacity_for(jcfg, t)
    # dbrx-132b at full width: 80 slots an expert for one 256-token
    # prompt, the floor of 8 for a decode step of 4 slots
    assert tmoe.capacity_for(get_config("dbrx-132b"), 256) == 80
    assert tmoe.capacity_for(get_config("dbrx-132b"), 4) == 8


def test_top_k_breaks_ties_by_expert_index():
    """Probabilities with many exact ties (multiples of 1/8) against
    ``lax.top_k``: the same indices, lower index first."""
    probs = np.random.default_rng(3).integers(0, 4, (64, 6)).astype(
        np.float32) / 8
    for k in (1, 2, 4, 6):
        tv, ti = tmoe.top_k(torch.from_numpy(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_router_tie_routes_and_drops_as_the_reference(arch,
                                                      capacity_factor):
    """Two experts share a router column, so every token ties them for
    its last (k-th) pick: the lower one takes it in both packages, and
    the capacity drops the same assignments. The earlier picks go to
    experts boosted above the tie."""
    kw = {} if capacity_factor is None else dict(
        capacity_factor=capacity_factor)
    cfg, jcfg = _cfgs(arch, **kw)
    k = cfg.experts_per_token
    t1, t2 = k - 1, k                   # the tied pair
    p = _moe_params(cfg, 7)
    p["router"][:, :t1] += 1.0
    p["router"][:, t2] = p["router"][:, t1]
    p["router"][:, t1:t2 + 1] += 0.5
    x = (np.random.default_rng(8).normal(size=(2, 16, cfg.d_model))
         + 1.0).astype(np.float32)
    ty, ta, jy, ja = _both(p, x, cfg, jcfg)
    _check(ty, ta, jy, ja)
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, cfg.d_model))
                          @ torch.from_numpy(p["router"]), dim=-1)
    assert torch.equal(probs[:, t1], probs[:, t2])
    _, idx = tmoe.top_k(probs, k)
    assert (idx[:, k - 1] == t1).sum() >= 24
    assert not (idx == t2).any()


def test_dropped_assignments_gather_a_clamped_index():
    """One expert takes every token's first choice: its positions run to
    T - 1, far past the capacity of 8. The port clamps the gather (an
    unclamped index raises in torch) and matches the reference."""
    cfg, jcfg = _cfgs("dbrx-132b", capacity_factor=0.25)
    p = _moe_params(cfg, 9)
    p["router"][:, 0] += 3.0
    x = np.random.default_rng(10).normal(
        size=(1, 32, cfg.d_model)).astype(np.float32)
    ty, ta, jy, ja = _both(p, x, cfg, jcfg)
    _check(ty, ta, jy, ja)
    assert int(ta["dropped"]) >= 32 - tmoe.capacity_for(cfg, 32)
    with pytest.raises(IndexError):
        torch.zeros(4, 2)[torch.tensor([4])]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _close(port, ref, frac, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=frac * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    japi = jmodel(jget(arch).reduced())
    api = get_model(get_config(arch).reduced())
    jp = japi.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return japi, api, jp, tp, TOL[arch]


def test_params_convert_leaf_for_leaf(models):
    """The MoE leaves (router (L,D,E), wi_gate/wi_up (L,E,D,F), wo
    (L,E,F,D)) cross with their paths, shapes and bits; the descriptor
    trees and counts agree."""
    japi, api, jp, tp, _ = models
    jpaths = [tuple(k.key for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in T.flatten(tp)] == jpaths
    assert ("layers", "moe", "router") in jpaths
    assert not any("mlp" in p for p in jpaths)
    for (path, t), j in zip(T.flatten(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), str(path))
    cfg = api.cfg
    L, D, E, F = cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.d_ff
    moe = tp["layers"]["moe"]
    assert tuple(moe["router"].shape) == (L, D, E)
    assert tuple(moe["wi_gate"].shape) == tuple(moe["wi_up"].shape) == (
        L, E, D, F)
    assert tuple(moe["wo"].shape) == (L, E, F, D)
    assert api.num_params() == japi.num_params()
    assert api.active_params_per_token() == japi.active_params_per_token()
    full = get_model(get_config("dbrx-132b"))
    assert full.active_params_per_token() == jmodel(
        jget("dbrx-132b")).active_params_per_token()


def test_prefill_logits_and_caches(models):
    japi, api, jp, tp, tol = models
    toks = np.random.default_rng(0).integers(0, 256, (2, 12))
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          MAX_SEQ)
    tl, tc = api.prefill(tp, {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    _close(tl, jl, tol["logits"], "prefill logits")
    for (path, t), j in zip(T.flatten(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape
        _close(t, j, tol["cache"], f"prefill cache {path}")
        _close(t[0], np.asarray(j)[0], tol["layer0"],
               f"prefill cache {path}, first layer")


@pytest.mark.parametrize("pos", [[12, 12], [12, 19], [20, 25]])
def test_decode_step_same_cache(models, pos):
    japi, api, jp, tp, tol = models
    toks = np.random.default_rng(1).integers(0, 256, (2, 12))
    _, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         MAX_SEQ)
    tc = T.tree_map(lambda a: torch.from_numpy(np.array(a)), jc)
    tok, pos = np.array([3, 7]), np.array(pos)
    jl, jc2 = japi.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                               jnp.asarray(pos, jnp.int32), MAX_SEQ)
    tl, tc2 = api.decode_step(tp, torch.from_numpy(tok), tc,
                              torch.from_numpy(pos), MAX_SEQ)
    _close(tl, jl, tol["dlogits"], "decode logits")
    for (path, t), j in zip(T.flatten(tc2), jax.tree.leaves(jc2)):
        j, t = np.asarray(j), t.numpy()
        col = np.zeros(j.shape, bool)
        for b, p in enumerate(pos):
            col[:, b, p % j.shape[2]] = True
        np.testing.assert_array_equal(t[~col], j[~col], str(path))
        np.testing.assert_allclose(t[col], j[col], rtol=0,
                                   atol=tol["column"] * np.abs(j).max())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    arch = "dbrx-132b"
    jcfg = jget(arch).reduced()
    jp = jmodel(jcfg).init(jax.random.PRNGKey(0))
    jtrace = jload_trace(FIXTURE)
    ref = JSched(JEngine(jcfg, JServeConfig(
        max_seq=jtrace.max_seq(), max_new_tokens=jtrace.max_new_tokens(),
        backend="lanes_ref"), params=jp), capacity=2).run(
        JTraceSource(jtrace, jcfg))
    return arch, jp, ref


def _serve_port(arch, params, api=None):
    cfg = get_config(arch).reduced()
    trace = load_trace(FIXTURE)
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        backend="lanes_ref"), params, device="cpu", api=api)
    return ContinuousScheduler(eng, capacity=2).run(
        TraceSource(trace, cfg, CPU))


def _same_shape_of_run(rep, ref):
    for k in ("clock_steps", "decode_steps", "bursts"):
        assert rep[k] == ref[k], k
    assert sorted(rep["requests"]) == sorted(ref["requests"])
    for rid, r in ref["requests"].items():
        for k in ("tokens", "slot", "admitted_step", "completed_step"):
            assert rep["requests"][rid][k] == r[k], (rid, k)


def test_serving_with_reference_numerics_is_exact(served):
    arch, jp, ref = served
    rep = _serve_port(arch, jp, JaxAdapter(get_config(arch).reduced(),
                                           arch))
    _same_shape_of_run(rep, ref)
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        assert p["flips"] == r["flips"] and p["errors"] == r["errors"], rid
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=1e-5)
    for s, r in ref["streams"].items():
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert rep["streams"][s][k] == r[k], (s, k)


def test_serving_with_the_port_model(served):
    """Tokens exact; flips and energy within 1.5% per request (largest
    measured: 0.45% and 0.39%, the last request); errors within three
    Poisson deviations of the reference's count."""
    arch, jp, ref = served
    rep = _serve_port(arch, params_from_jax(jax.tree.map(np.asarray, jp)))
    _same_shape_of_run(rep, ref)
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        assert abs(p["flips"] - r["flips"]) <= 0.015 * r["flips"], rid
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=0.015)
        assert abs(p["errors"] - r["errors"]) <= 3 * np.sqrt(
            max(r["errors"], 1)), rid
