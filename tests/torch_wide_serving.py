"""Serving parity of the port against the JAX reference for the dense
windowed and wide configurations (gemma2-9b, mistral-nemo-12b,
h2o-danube-1.8b, llama4-scout-17b-a16e), reduced, float32, on the CPU.

The trace is built here: four requests arriving at once into two slots,
prompts of ``PROMPT_LEN`` = 37 tokens (past the reduced window of 16, so
every windowed leaf's ring wraps at the prefill, 5 slots off its start)
and ``NEW_TOKENS`` = 13 tokens each, so the decode writes (positions
37-48) wrap the ring once more. One prompt length and one burst length
keep the JAX compiles to one prefill and one burst a package. The reference serves it with its own engine; the
port serves it with the reference's numerics through the adapter
(``test_torch_sampling.JaxAdapter``), everything else the port's: slot
pool, scheduler, write plan, lane twin (``lanes_ref``). Tokens, flips,
errors and the step counts are exact; energies at ``RTOL`` = 1e-5
(float32 sums in another order). Both take the port's seeded
parameters. Each configuration has a test file of its own, so that
each runs on its own worker.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.workload import TraceSource as JTraceSource
from repro.workload import load_trace as jload_trace
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.workload import TraceSource, load_trace
from test_torch_sampling import JaxAdapter

CPU = torch.device("cpu")
PROMPT_LEN, NEW_TOKENS = 37, 13
RTOL = 1e-5
#: the port's own model, float32: the decode logits after the ring
#: wrapped against a prefill over the same tokens, and the caches, each as
#: a fraction of the prefill's largest value, about three times the
#: largest measured over prompts from seeds 31-34 (one thread or eight):
#:   gemma2-9b              1.9e-5  7.8e-6
#:   mistral-nemo-12b       2.6e-5  4.2e-5
#:   h2o-danube-1.8b        1.7e-5  9.2e-5
#:   llama4-scout-17b-a16e  1.5e-4  1.3e-4
WRAP_TOL = {"gemma2-9b": (6e-5, 2.5e-5), "mistral-nemo-12b": (8e-5, 1.3e-4),
            "h2o-danube-1.8b": (5.5e-5, 2.8e-4),
            "llama4-scout-17b-a16e": (4.5e-4, 4e-4)}


def write_trace(path, arch: str):
    """The trace above as a workload JSONL file at ``path``."""
    cfg = get_config(arch).reduced()
    rs = np.random.default_rng(29)
    lines = [{"family": cfg.family, "format": "repro.workload.trace",
              "meta": {"built_by": "tests/torch_wide_serving.py"},
              "version": 1, "vocab_size": cfg.vocab_size}]
    for i in range(4):
        lines.append({"app_id": "chat" if i % 2 else "batch",
                      "arrival": 0, "new_tokens": NEW_TOKENS,
                      "quality": "high" if i == 2 else "low", "rid": i,
                      "session": i, "tokens": rs.integers(
                          0, cfg.vocab_size, PROMPT_LEN).tolist()})
    path.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return path


def serve_both(arch: str, path):
    """(the reference's report, the port's report through the adapter)
    for the trace at ``path``, capacity 2, backend ``lanes_ref``."""
    jcfg = jget(arch).reduced()
    # the port's seeded parameters as JAX arrays: the JAX package's own
    # init compiles a draw per leaf, seconds on the CPU
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                      get_model(get_config(arch).reduced()).init(0, CPU))
    jtrace = jload_trace(path)
    ref = JSched(JEngine(jcfg, JServeConfig(
        max_seq=jtrace.max_seq(), max_new_tokens=jtrace.max_new_tokens(),
        backend="lanes_ref"), params=jp), capacity=2).run(
        JTraceSource(jtrace, jcfg))
    cfg = get_config(arch).reduced()
    trace = load_trace(path)
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        backend="lanes_ref"), jp, device="cpu", api=JaxAdapter(cfg, arch))
    rep = ContinuousScheduler(eng, capacity=2).run(
        TraceSource(trace, cfg, CPU))
    return ref, rep


def check_exact(ref, rep):
    for k in ("clock_steps", "decode_steps", "bursts"):
        assert rep[k] == ref[k], k
    for k in ("capacity", "admissions", "completions", "peak_occupancy"):
        assert rep["pool"][k] == ref["pool"][k], k
    assert sorted(rep["requests"]) == sorted(ref["requests"])
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        assert len(r["tokens"]) == NEW_TOKENS
        for k in ("tokens", "flips", "errors", "slot", "admitted_step",
                  "completed_step"):
            assert p[k] == r[k], (rid, k)
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=RTOL)
    for s, r in ref["streams"].items():
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert rep["streams"][s][k] == r[k], (s, k)
        np.testing.assert_allclose(rep["streams"][s]["energy_pj"],
                                   r["energy_pj"], rtol=RTOL)


def check_decode_after_wrap(arch: str, seed: int = 31):
    """The port's own model: a prompt of 24 tokens, then 16 decode steps
    (positions 24-39, the ring of 16 wrapped past slot 0), against a
    prefill over all 40 tokens: the last logits and every cache leaf
    (the columns both hold) within ``WRAP_TOL``."""
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    params = api.init(0, CPU)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, 40)))
    max_seq = 48
    logits, cache = api.prefill(params, {"tokens": toks[:, :24]}, max_seq)
    for i in range(24, 40):
        logits, cache = api.decode_step(params, toks[:, i], cache,
                                        torch.tensor([i]), max_seq)
    ref_logits, ref_cache = api.prefill(params, {"tokens": toks}, max_seq)
    err = float((logits - ref_logits).abs().max()
                / ref_logits.abs().max())
    cache_err = max(
        float((cache[name][kv][:, :, :40] - ref_leaf[:, :, :40]).abs().max()
              / ref_leaf.abs().max())
        for name, leaves in ref_cache.items()
        for kv, ref_leaf in leaves.items())
    tol, cache_tol = WRAP_TOL[arch]
    assert err < tol and cache_err < cache_tol, (err, cache_err)
    return err, cache_err
