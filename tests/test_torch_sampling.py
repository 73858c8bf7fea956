"""Non-greedy sampling of the port against the JAX reference.

* ``rng.gumbel`` / ``rng.categorical`` (host numpy) and ``gumbel_t`` /
  ``categorical_t`` (torch ops, here on CPU tensors) against
  ``jax.random.gumbel`` / ``categorical``, mode "low", over 200 keys. The
  uniforms under them are bit-exact (``test_torch_workload.py``). In
  bfloat16 every Gumbel value is bit-exact too. In float32 XLA's ``log``
  differs from numpy's and torch's in the last bit of about a third of
  the values (largest difference measured: 9.5e-7, one unit in the last
  place at 8 to 16), so a sample could move only where two candidates tie
  within that; measured moves over the 2 x 3 x 200 draws: 0, and 0 is
  asserted.
* Serving ``trace_smoke.jsonl`` through the port's scheduler with the
  reference's model numerics (an adapter moving arrays through numpy),
  dense and hybrid, sampled at temperatures 1.0 and 0.5: tokens, flips,
  errors and the run's shape equal the reference scheduler's (energies
  at rtol 1e-5). A greedy run ignores the temperature; greedy serving
  through the adapter stays held exactly against the reference by
  ``test_torch_serve.py`` and ``test_torch_rglru.py``, unchanged: the
  key schedule did not change.
* The port's own sampled engine repeats itself under one seed and moves
  under another.
"""
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
from repro_torch import rng
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import ModelApi
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.workload import TraceSource, load_trace

FIXTURE = "tests/fixtures/trace_smoke.jsonl"
CPU = torch.device("cpu")
KEYS = 200
#: float32 Gumbel values: one unit in the last place at 16 (the largest
#: mode-"low" value is -log(-log(1 - 2^-24)) = 16.6)
GUMBEL_ATOL = 2.0 ** -19


class JaxAdapter(ModelApi):
    """The port's ModelApi of ``cfg`` with prefill/decode computed by the
    JAX model of ``arch`` (jitted, as the reference engine runs it)."""

    def __init__(self, cfg, arch: str):
        super().__init__(cfg)
        self.japi = jmodel(jget(arch).reduced())
        self._prefill = jax.jit(self.japi.prefill, static_argnums=2)
        self._decode = jax.jit(self.japi.decode_step, static_argnums=4)

    def prefill(self, params, batch, max_seq):
        tokens = jnp.asarray(batch["tokens"].numpy(), jnp.int32)
        logits, cache = self._prefill(params, {"tokens": tokens}, max_seq)
        return torch.from_numpy(np.array(logits)), _to_torch(cache)

    def decode_step(self, params, token, cache, pos, max_seq):
        logits, cache = self._decode(
            params, jnp.asarray(token.numpy(), jnp.int32),
            T.tree_map(lambda t: jnp.asarray(t.numpy()), cache),
            jnp.asarray(pos.numpy(), jnp.int32), max_seq)
        return torch.from_numpy(np.array(logits)), _to_torch(cache)


def _to_torch(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_draws():
    cat = jax.jit(jax.random.categorical)
    gum = jax.jit(jax.random.gumbel, static_argnums=(1, 2))
    return cat, gum


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gumbel_and_categorical_match_jax(jax_draws, dtype):
    cat, gum = jax_draws
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    logits = np.asarray(jnp.asarray(
        np.random.default_rng(5).normal(size=(3, 1000)) * 2.0, jdt))
    logits32 = logits.astype(np.float32)
    moves = 0
    for i in range(KEYS):
        key = rng.fold_in(rng.PRNGKey(77), i)
        jk = jnp.asarray(key)
        want = np.asarray(cat(jk, jnp.asarray(logits)))
        host = rng.categorical(key, logits32, dtype)
        dev = rng.categorical_t(key, torch.from_numpy(logits32).to(tdt))
        moves += int((host != want).sum() + (dev.numpy() != want).sum())
        jg = np.asarray(gum(jk, logits.shape, jdt)).astype(np.float32)
        hg = rng.gumbel(key, logits.shape, dtype)
        dg = rng.gumbel_t(key, logits.shape, CPU, tdt)
        assert dg.dtype == tdt
        dg = dg.float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(hg, jg)
            np.testing.assert_array_equal(dg, jg)
        else:
            np.testing.assert_allclose(hg, jg, rtol=0, atol=GUMBEL_ATOL)
            np.testing.assert_allclose(dg, jg, rtol=0, atol=GUMBEL_ATOL)
    assert moves == 0


def test_temperature_scales_the_logits():
    """categorical_t of logits / t is what the engine samples: a low
    temperature concentrates the draws on the argmax."""
    logits = torch.from_numpy(np.random.default_rng(1).normal(
        size=(64, 50)).astype(np.float32))
    key = rng.PRNGKey(3)
    cold = rng.categorical_t(key, logits / 1e-3)
    assert torch.equal(cold, torch.argmax(logits, dim=-1))
    assert not torch.equal(rng.categorical_t(key, logits),
                           torch.argmax(logits, dim=-1))


# ---------------------------------------------------------------------------
# serving through the reference's numerics
# ---------------------------------------------------------------------------

SAMPLED = {"t1.0": dict(greedy=False),
           "t0.5": dict(greedy=False, temperature=0.5)}


@pytest.fixture(scope="module", params=["qwen2.5-3b", "recurrentgemma-2b"])
def served(request):
    """Per family: the reference's sampled runs, and the port's (one
    adapter, so its jitted model compiles once) sampled, greedy and
    greedy at another temperature."""
    arch = request.param
    jcfg = jget(arch).reduced()
    jp = jmodel(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    api = JaxAdapter(cfg, arch)
    jtrace, trace = jload_trace(FIXTURE), load_trace(FIXTURE)
    ref, port = {}, {}
    for name, kw in SAMPLED.items():
        ref[name] = JSched(JEngine(jcfg, JServeConfig(
            max_seq=jtrace.max_seq(), max_new_tokens=jtrace.max_new_tokens(),
            backend="lanes_ref", **kw), params=jp), capacity=2).run(
            JTraceSource(jtrace, jcfg))
    for name, kw in {**SAMPLED, "greedy": dict(greedy=True),
                     "greedy_t0.25": dict(temperature=0.25)}.items():
        eng = ServingEngine(cfg, ServeConfig(
            max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
            backend="lanes_ref", **kw), jp, device="cpu", api=api)
        port[name] = ContinuousScheduler(eng, capacity=2).run(
            TraceSource(trace, cfg, CPU))
    return ref, port


@pytest.mark.parametrize("sampling", list(SAMPLED))
def test_served_tokens_flips_errors_match(served, sampling):
    ref, rep = served[0][sampling], served[1][sampling]
    for k in ("clock_steps", "decode_steps", "bursts"):
        assert rep[k] == ref[k], k
    assert sorted(rep["requests"]) == sorted(ref["requests"])
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("tokens", "slot", "flips", "errors", "latency_steps"):
            assert p[k] == r[k], (rid, k)
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=1e-5)
    for s, r in ref["streams"].items():
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert rep["streams"][s][k] == r[k], (s, k)


def test_sampling_changes_the_served_tokens(served):
    """The sampled runs are not the greedy one (the sampling key reaches
    the draws), and a greedy run ignores the temperature."""
    port = served[1]
    toks = {name: [rep["requests"][r]["tokens"]
                   for r in sorted(rep["requests"])]
            for name, rep in port.items()}
    assert port["greedy_t0.25"] == port["greedy"]
    assert toks["t1.0"] != toks["greedy"] != toks["t0.5"]


# ---------------------------------------------------------------------------
# the port's own model
# ---------------------------------------------------------------------------

def test_port_sampling_repeats_and_moves_with_the_seed():
    arch = "qwen2.5-3b"
    cfg = get_config(arch).reduced()
    params = params_from_jax(jax.tree.map(
        np.asarray, jmodel(jget(arch).reduced()).init(
            jax.random.PRNGKey(0))))
    batch = {"tokens": torch.from_numpy(
        rng.randint(rng.PRNGKey(4), (3, 8), 0, cfg.vocab_size)
        .astype(np.int64))}

    def run(**kw):
        eng = ServingEngine(cfg, ServeConfig(max_seq=16, max_new_tokens=8,
                                             greedy=False, **kw),
                            params, device="cpu")
        return eng.generate(batch)

    (a, ra), (b, rb), (c, _) = run(), run(), run(seed=1)
    assert torch.equal(a, b) and ra == rb
    assert not torch.equal(a, c)
    assert tuple(a.shape) == (3, 8)
