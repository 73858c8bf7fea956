"""The port's vlm family (llava-next-mistral-7b) and its multimodal
prompts against the JAX reference, float32 on the CPU.

* The projector (tanh GELU in float32) at a few float32 ulps;
  ``prefill`` / ``decode_step`` on the reduced config at about three
  times the measured error (largest over seeds 0-3, as a fraction of the
  reference's largest value: prefill logits 3.3e-4, cache 1.6e-4, its
  first layer 5.8e-7, decode logits 2.6e-5, the decoded column 2.1e-5;
  the random reduced stack amplifies the last-bit differences of its
  float32 products).
* The synthetic stream's image embeddings are ``rng.normal`` draws off
  ``modal_seed = seed + 17 i + 1``, bit for bit the reference's
  ``jax.random.normal`` ones.
* Serving a synthetic stream through the port's scheduler with the
  reference's model numerics, at 400 K with 1000 s of dwell a step and
  periodic scrubbing: tokens, flips, errors, scrub passes, retention
  flips and decayed bits exact, energies at rtol 1e-5.
* The stream recorded by the port is the reference's trace byte for
  byte, and replaying it (the embeddings regenerated from each event's
  ``modal_seed``) gives the same report. Both packages refuse to record
  or replay a vlm request without a ``modal_seed``, with one message.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.priority import kv_cache_policy as jkv_policy
from repro.models import get_model as jmodel
from repro.models import vlm as jvlm
from repro.reliability import make_scrub_policy as jmake_scrub_policy
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.serve.scheduler import synthetic_requests as jsynthetic
from repro.workload import TraceSource as JTraceSource
from repro.workload import record_requests as jrecord
from repro.workload import save_trace as jsave_trace
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.priority import kv_cache_policy
from repro_torch.models import get_model
from repro_torch.models import vlm as tvlm
from repro_torch.reliability import make_scrub_policy
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.serve import synthetic_requests
from repro_torch.workload import (TraceSource, load_trace, record_requests,
                                  save_trace)
from test_torch_sampling import JaxAdapter

ARCH = "llava-next-mistral-7b"
CPU = torch.device("cpu")
TOL = dict(logits=1e-3, cache=5e-4, layer0=2e-6, dlogits=8e-5,
           column=6.5e-5)
ULPS = 2e-6
RTOL = 1e-5
#: the synthetic stream: 3 requests of 12 tokens one step apart, 4 new
#: tokens each, into 2 slots
N_REQ, PROMPT, NEW, CAPACITY = 3, 12, 4, 2


class ModalAdapter(JaxAdapter):
    """The reference's model numerics behind the port's ModelApi, every
    prompt leaf (tokens and the multimodal one) crossing as numpy."""

    def prefill(self, params, batch, max_seq):
        jb = {k: jnp.asarray(v.numpy(), jnp.int32 if k == "tokens"
                             else jnp.float32) for k, v in batch.items()}
        logits, cache = self._prefill(params, jb, max_seq)
        return (torch.from_numpy(np.array(logits)),
                T.tree_map(lambda a: torch.from_numpy(np.array(a)), cache))


def _close(port, ref, frac, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=frac * float(np.abs(ref).max()),
                               err_msg=what)


def check_cache_tags(arch):
    """The port's cache tree (shapes, dtypes, priority tags, axes) is
    the reference's."""
    api = get_model(get_config(arch).reduced())
    japi = jmodel(jget(arch).reduced())
    tcache = api.init_cache(2, 16, "meta")
    jflat = jax.tree_util.tree_flatten_with_path(japi.init_cache(2, 16))[0]
    assert len(jflat) == len(T.flatten(tcache))
    for (path, t), (jpath, j) in zip(T.flatten(tcache), jflat):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).endswith(str(j.dtype)), path
        assert int(kv_cache_policy(path, t)) == int(jkv_policy(jpath, j))
    assert api.cache_axes() == japi.cache_axes()


def check_params(arch, jp, tp, api):
    jpaths = [tuple(k.key for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in T.flatten(tp)] == jpaths
    assert [p for p, _ in T.flatten(api.descs())] == jpaths
    for (path, t), j in zip(T.flatten(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), str(path))
    assert get_model(get_config(arch)).num_params() == jmodel(
        jget(arch)).num_params()


@pytest.fixture(scope="module")
def models():
    japi = jmodel(jget(ARCH).reduced())
    api = get_model(get_config(ARCH).reduced())
    jp = japi.init(jax.random.PRNGKey(0))
    return japi, api, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_params_and_cache_tags(models):
    japi, api, jp, tp = models
    check_params(ARCH, jp, tp, api)
    assert "projector" in tp
    n = get_model(get_config(ARCH)).num_params()
    assert abs(n - 7.26e9) < 0.01e9
    check_cache_tags(ARCH)


def test_project_matches(models):
    japi, api, jp, tp = models
    e = np.random.default_rng(0).normal(size=(2, 8, 1024)).astype(np.float32)
    _close(tvlm.project(tp, torch.from_numpy(e), torch.float32),
           jvlm.project(jp, jnp.asarray(e), jnp.float32), ULPS, "project")


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_match(models, seed):
    japi, api, jp, tp = models
    cfg = api.cfg
    r = np.random.default_rng(seed)
    toks = r.integers(0, 256, (2, PROMPT))
    img = r.normal(size=(2, cfg.num_image_tokens, cfg.vision_dim)).astype(
        np.float32)
    ms = PROMPT + NEW + cfg.num_image_tokens
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                               "image_embeds": jnp.asarray(img)}, ms)
    batch = {"tokens": torch.from_numpy(toks),
             "image_embeds": torch.from_numpy(img)}
    tl, tc = api.prefill(tp, batch, ms)
    assert api.prompt_len(batch) == PROMPT + cfg.num_image_tokens
    _close(tl, jl, TOL["logits"], "prefill logits")
    for (path, t), j in zip(T.flatten(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape
        _close(t, j, TOL["cache"], f"prefill cache {path}")
        _close(t[0], np.asarray(j)[0], TOL["layer0"], f"layer 0 {path}")
    tc = T.tree_map(lambda a: torch.from_numpy(np.array(a)), jc)
    p0 = api.prompt_len(batch)
    tok, pos = np.array([3, 7]), np.array([p0, p0 + 2])
    jl, jc2 = japi.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                               jnp.asarray(pos, jnp.int32), ms)
    tl, tc2 = api.decode_step(tp, torch.from_numpy(tok), tc,
                              torch.from_numpy(pos), ms)
    _close(tl, jl, TOL["dlogits"], "decode logits")
    for (path, t), j in zip(T.flatten(tc2), jax.tree.leaves(jc2)):
        j, t = np.asarray(j), t.numpy()
        col = np.zeros(j.shape, bool)
        for b, p in enumerate(pos):
            col[:, b, p % j.shape[2]] = True
        np.testing.assert_array_equal(t[~col], j[~col], str(path))
        _close(t[col], j[col], TOL["column"], f"decode column {path}")


def test_synthetic_embeddings_are_the_references():
    cfg, jcfg = get_config(ARCH).reduced(), jget(ARCH).reduced()
    reqs = synthetic_requests(cfg, N_REQ, device=CPU, prompt_len=PROMPT,
                              seed=5)
    jreqs = jsynthetic(jcfg, N_REQ, prompt_len=PROMPT, seed=5)
    for r, j in zip(reqs, jreqs):
        assert r.modal_seed == j.modal_seed == 5 + 17 * r.rid + 1
        assert r.prompt["image_embeds"].dtype == torch.float32
        np.testing.assert_array_equal(
            r.prompt["image_embeds"].numpy().view(np.uint32),
            np.asarray(j.prompt["image_embeds"]).view(np.uint32))
        np.testing.assert_array_equal(r.prompt["tokens"].numpy(),
                                      np.asarray(j.prompt["tokens"]))


def _kw(cfg):
    return dict(max_seq=PROMPT + NEW + cfg.num_image_tokens,
                max_new_tokens=NEW, backend="lanes_ref",
                retention_scale=1000.0, ambient_k=400.0)


@pytest.fixture(scope="module")
def reference(models):
    _, _, jp, _ = models
    jcfg = jget(ARCH).reduced()
    eng = JEngine(jcfg, JServeConfig(**_kw(jcfg)), params=jp)
    reqs = jsynthetic(jcfg, N_REQ, prompt_len=PROMPT, new_tokens=NEW,
                      arrival_every=1)
    return JSched(eng, capacity=CAPACITY, scrub_policy=jmake_scrub_policy(
        "periodic", interval=2)).run(reqs)


def _serve(jp, source):
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, ServeConfig(**_kw(cfg)), jp, device="cpu",
                        api=ModalAdapter(cfg, ARCH))
    return ContinuousScheduler(eng, capacity=CAPACITY,
                               scrub_policy=make_scrub_policy(
                                   "periodic", interval=2)).run(source)


def check_same_report(rep, ref):
    for k in ("clock_steps", "decode_steps", "bursts"):
        assert rep[k] == ref[k], k
    assert sorted(rep["requests"]) == sorted(ref["requests"])
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("tokens", "slot", "flips", "errors", "admitted_step",
                  "completed_step"):
            assert p[k] == r[k], (rid, k)
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=RTOL)
    for s, r in ref["streams"].items():
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert rep["streams"][s][k] == r[k], (s, k)
        np.testing.assert_allclose(rep["streams"][s]["energy_pj"],
                                   r["energy_pj"], rtol=RTOL)
    if "lifetime" in ref:
        lt, lr = rep["lifetime"], ref["lifetime"]
        for k in ("retention_flips", "residual_decayed_bits",
                  "scrub_passes"):
            assert lt[k] == lr[k], k
        np.testing.assert_allclose(lt["scrub_energy_pj"],
                                   lr["scrub_energy_pj"], rtol=RTOL)


def test_serving_with_retention_is_exact(models, reference):
    _, _, jp, _ = models
    cfg = get_config(ARCH).reduced()
    rep = _serve(jp, synthetic_requests(
        cfg, N_REQ, device=CPU, prompt_len=PROMPT, new_tokens=NEW,
        arrival_every=1))
    check_same_report(rep, reference)
    assert rep["total"]["bits_written"] > 0
    lt = rep["lifetime"]
    assert lt["scrub_passes"] > 0 and lt["retention_flips"] > 0


def test_recorded_trace_replays_from_modal_seeds(models, reference,
                                                 tmp_path):
    _, _, jp, _ = models
    cfg, jcfg = get_config(ARCH).reduced(), jget(ARCH).reduced()
    reqs = synthetic_requests(cfg, N_REQ, device=CPU, prompt_len=PROMPT,
                              new_tokens=NEW, arrival_every=1)
    path, jpath = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    save_trace(record_requests(reqs, cfg), path)
    jsave_trace(jrecord(jsynthetic(jcfg, N_REQ, prompt_len=PROMPT,
                                   new_tokens=NEW, arrival_every=1), jcfg),
                jpath)
    assert path.read_bytes() == jpath.read_bytes()
    trace = load_trace(path)
    assert [e.modal_seed for e in trace.events] == [1, 18, 35]
    check_same_report(_serve(jp, TraceSource(trace, cfg, CPU)), reference)


def test_modal_seed_is_required_in_both_packages():
    cfg, jcfg = get_config(ARCH).reduced(), jget(ARCH).reduced()
    reqs = synthetic_requests(cfg, 1, device=CPU, prompt_len=PROMPT)
    jreqs = jsynthetic(jcfg, 1, prompt_len=PROMPT)
    reqs[0].modal_seed = jreqs[0].modal_seed = None
    msgs = []
    for fn, rs, c in ((record_requests, reqs, cfg), (jrecord, jreqs, jcfg)):
        with pytest.raises(ValueError, match="without a modal_seed") as e:
            fn(rs, c)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # an event without one cannot be replayed
    trace = record_requests(synthetic_requests(cfg, 1, device=CPU,
                                               prompt_len=PROMPT), cfg)
    trace = dataclasses.replace(trace, events=[dataclasses.replace(
        trace.events[0], modal_seed=None)])
    msgs = []
    for src in (TraceSource(trace, cfg, CPU), JTraceSource(trace, jcfg)):
        with pytest.raises(ValueError, match="needs a modal_seed") as e:
            src.popleft()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
