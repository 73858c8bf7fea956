"""The port's serving-energy benchmark pieces against the reference's:
``serve/engine.py``'s ``_tag_cache`` and ``eager_extent_cache_write``,
``launch/hw.py``, ``kernel_bench`` and ``serving_energy``, on the CPU at
the reference runner's ``--fast`` sizes.

Tolerances (each beside its assertion):
  * the eager oracle's energy: ``ORACLE_ENERGY_RTOL`` = 5e-5, the
    reference oracle's float32 sum against the port's float64 per-plane
    sum rounded once (ROADMAP §C.1; stored bits and counts are exact);
  * a serve report's energies through the reference-numerics adapter
    (``JaxModel``): ``RTOL`` = 1e-5, as ``test_torch_serve._check_exact``;
  * the fused against the eager write in ``compare_fused_vs_eager``: a
    bound derived from float32 summation (``_fused_eager_bound``);
  * the port's own model: energy, skip rate and token agreement within
    ``OWN_MODEL_RTOL`` = 1.5%, the realized errors within three Poisson
    standard deviations (both as ``test_torch_serve``);
  * ``kv_quant_rel_err``: ``KV_QUANT_RTOL`` = 1e-6 (float32 means summed
    in another order; the payload and scales are bit-exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import kernel_bench as jkb
from benchmarks import serving_energy as jse
from repro.configs import get_config as jget
from repro.launch import hw as jhw
from repro.models import get_model as jmodel
from repro.serve.engine import _tag_cache as j_tag_cache
from repro.serve.engine import \
    eager_extent_cache_write as j_eager_extent_cache_write
from repro_torch import rng
from repro_torch import tree as T
from repro_torch.benchmarks import kernel_bench, serving_energy
from repro_torch.convert import params_from_jax
from repro_torch.core.write_driver import TABLE1, WORD_BITS
from repro_torch.launch import hw
from repro_torch.serve import ServingEngine
from repro_torch.serve.engine import _tag_cache, eager_extent_cache_write
from test_torch_serve import ARCH, JaxModel

CPU = torch.device("cpu")
ORACLE_ENERGY_RTOL = 5e-5
RTOL = 1e-5
OWN_MODEL_RTOL = 1.5e-2
KV_QUANT_RTOL = 1e-6
NEW_TOKENS = 4  # the reference runner's --fast size


def engine_factory(params, adapter: bool):
    """A stand-in for a benchmark module's ``ServingEngine``: every engine
    it builds holds ``params``, and with ``adapter`` computes with the
    reference's model (``JaxModel``)."""
    def make(cfg, scfg, *_, device=None, **__):
        return ServingEngine(cfg, scfg, params, device=device,
                             api=JaxModel(cfg) if adapter else None)
    return make


@pytest.fixture(scope="module")
def jparams():
    return jmodel(jget(ARCH).reduced()).init(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# the engine's eager oracle
# ---------------------------------------------------------------------------

def _cache_pair(seed: int):
    """(old, new) cache trees with K, V, an f32 recurrent state (EXACT)
    and an int leaf, numpy-seeded."""
    r = np.random.default_rng(seed)

    def tree():
        return {"att": {"k": r.normal(size=(2, 2, 6, 1, 8)).astype(
                    np.float32),
                        "v": r.normal(size=(2, 2, 6, 1, 8)).astype(
                    np.float32)},
                "rec_state": r.normal(size=(2, 2, 16)).astype(np.float32),
                "steps": r.integers(0, 9, size=(2,)).astype(np.int32)}
    old, new = tree(), tree()
    # a quarter of the elements unchanged, so CMP skips run too
    for p in ("k", "v"):
        keep = r.random(old["att"][p].shape) < 0.25
        new["att"][p] = np.where(keep, old["att"][p], new["att"][p])
    return old, new


def _tt(tree):
    return T.tree_map(torch.from_numpy, tree)


def test_tag_cache_matches_the_reference():
    old, _ = _cache_pair(0)
    port = T.flatten(_tag_cache(_tt(old)))
    ref = jax.tree_util.tree_leaves_with_path(
        j_tag_cache(jax.tree.map(jnp.asarray, old)))
    assert [int(t) for _, t in port] == [int(t) for _, t in ref]


@pytest.mark.parametrize("seed", [0, 1])
def test_eager_extent_cache_write_matches_the_reference(seed):
    """Stored bits and the counts exact; energy to ORACLE_ENERGY_RTOL."""
    old, new = _cache_pair(seed)
    key = rng.PRNGKey(seed + 3)
    stored, agg = eager_extent_cache_write(
        key, _tt(old), _tt(new), _tag_cache(_tt(old)))
    jo, jn = jax.tree.map(jnp.asarray, old), jax.tree.map(jnp.asarray, new)
    jstored, jagg = j_eager_extent_cache_write(
        jax.random.PRNGKey(seed + 3), jo, jn, j_tag_cache(jo))
    for (_, a), b in zip(T.flatten(stored), jax.tree.leaves(jstored)):
        np.testing.assert_array_equal(
            a.numpy().view(np.uint8), np.asarray(b).view(np.uint8))
    for k in ("bits_written", "bit_errors", "bits_total"):
        assert agg[k] == jagg[k], k
    assert agg["bit_errors"] > 0
    np.testing.assert_allclose(agg["energy_pj"], jagg["energy_pj"],
                               rtol=ORACLE_ENERGY_RTOL)


# ---------------------------------------------------------------------------
# launch/hw.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,value", [
    ("PEAK_FLOPS_BF16", 989e12), ("PEAK_FLOPS_F32", 67e12),
    ("HBM_BW", 3.35e12), ("NVLINK_BW_PER_LINK", 50e9),
    ("GPUS_PER_NODE", 8)])
def test_hw_constants(name, value):
    assert getattr(hw, name) == value


def test_hw_keeps_the_reference_names_and_renames_the_tpu_ones():
    for name in ("PEAK_FLOPS_BF16", "HBM_BW"):
        assert hasattr(jhw, name) and hasattr(hw, name)
    for name in ("ICI_BW_PER_LINK", "CHIPS_PER_POD"):
        assert hasattr(jhw, name) and not hasattr(hw, name)


def test_chip_smoke_bounds_read_hw():
    from test_torch_kv_quant import _chip_smoke
    cs = _chip_smoke()
    assert cs.hw() is hw
    for name in ("HBM_BYTES_PER_S", "F32_FLOPS", "BF16_FLOPS"):
        assert not hasattr(cs, name), name


# ---------------------------------------------------------------------------
# kernel_bench
# ---------------------------------------------------------------------------

class _NoPallasMemory:
    """The reference's ``repro.memory`` for its kernel_bench with the
    interpreted Pallas backend served by ``lanes_ref``, which the
    reference's own parity tests hold equal to it bit for bit."""

    def __init__(self, mem):
        self._mem = mem

    def write(self, *a, backend=None, **k):
        return self._mem.write(
            *a, backend="lanes_ref" if backend == "pallas" else backend, **k)


def test_kernel_bench_matches_the_reference(monkeypatch):
    """At n_mib=2: both byte counts, the reduction factor and the errors
    of the device's backend (the twin here) equal the reference's — the
    inputs are the same draws. The reference's timers are stood in for
    (they only time), so its eager oracle does not run."""
    monkeypatch.setattr(jkb, "memory", _NoPallasMemory(jkb.memory))
    monkeypatch.setattr(jkb, "_timed", lambda fn, reps=3: 0.0)
    port, ref = kernel_bench.run(n_mib=2, device=CPU), jkb.run(n_mib=2)
    for k in ("tensor_mib", "bytes_fused", "bytes_unfused_jnp",
              "fusion_traffic_reduction_x", "errors"):
        assert port[k] == ref[k], k
    assert port["errors"] > 0 and port["backend"] == "lanes_ref"
    assert port["projected_h100_us_fused"] == round(
        port["bytes_fused"] / 3.35e12 * 1e6, 2)
    assert set(port["level_sweep_s"]) == {"MID", "HIGH", "EXACT"}
    assert set(kernel_bench.bench_metrics(port)) >= {
        "cuda_backend_s", "lane_path_s", "eager_oracle_s",
        "level_sweep_mid_s"}


def test_kernel_bench_inputs_are_the_reference_draws():
    n = 4096
    old, new, key = kernel_bench.inputs(n, CPU)
    jold = jax.random.normal(jax.random.PRNGKey(0), (n,)).astype(
        jnp.bfloat16)
    jnew = jax.random.normal(jax.random.PRNGKey(1), (n,)).astype(
        jnp.bfloat16)
    np.testing.assert_array_equal(old.view(torch.int16).numpy(),
                                  np.asarray(jold).view(np.int16))
    np.testing.assert_array_equal(new.view(torch.int16).numpy(),
                                  np.asarray(jnew).view(np.int16))
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(2)))


# ---------------------------------------------------------------------------
# serving_energy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_serving():
    """The reference's ``run(archs=(ARCH,), new_tokens=4)``, its parts
    computed first so that ``continuous_vs_sequential`` takes no timed
    repetition (``reps=0``: the counts come from its warm-up run)."""
    parts = {"compare_fused_vs_eager": jse.compare_fused_vs_eager(
                 new_tokens=NEW_TOKENS),
             "continuous_vs_sequential": jse.continuous_vs_sequential(
                 reps=0),
             "lockstep_parity": jse.lockstep_parity()}
    with pytest.MonkeyPatch.context() as mp:
        for name, out in parts.items():
            mp.setattr(jse, name, lambda *a, _out=out, **k: _out)
        return jse.run(archs=(ARCH,), new_tokens=NEW_TOKENS)


@pytest.fixture(scope="module")
def adapter_serving(jparams):
    """The port's serving_energy pieces with every engine on the
    reference's model numerics."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving_energy, "ServingEngine",
                   engine_factory(jparams, adapter=True))
        return {
            "fused_vs_eager": serving_energy.compare_fused_vs_eager(
                new_tokens=NEW_TOKENS, device=CPU),
            # the counts come from the warm-up run; no timed repetition
            "continuous_vs_sequential":
                serving_energy.continuous_vs_sequential(reps=0,
                                                        device=CPU),
            "lockstep_parity": serving_energy.lockstep_parity(device=CPU),
        }


def test_lockstep_parity_matches_the_reference(adapter_serving,
                                               ref_serving):
    port = adapter_serving["lockstep_parity"]
    ref = ref_serving["lockstep_parity"]
    assert port["bit_exact"] and ref["bit_exact"]
    for side in ("monolithic", "continuous"):
        for k in ("bits_written", "bit_errors"):
            assert port[side][k] == ref[side][k], (side, k)
        np.testing.assert_allclose(port[side]["energy_pj"],
                                   ref[side]["energy_pj"], rtol=RTOL)
    assert port["extent_table_in_report"] == ref["extent_table_in_report"]


def test_continuous_vs_sequential_matches_the_reference(adapter_serving,
                                                        ref_serving):
    port = adapter_serving["continuous_vs_sequential"]
    ref = ref_serving["continuous_vs_sequential"]
    for k in ("requests", "capacity", "arrival_every_steps", "total_tokens",
              "bursts", "mean_latency_steps", "extent_table"):
        assert port[k] == ref[k], k


def _fused_eager_bound() -> float:
    """Both sides price the same integer flips per bit plane: the fused
    twin rounds each leaf's float64 sum once and adds the leaves in
    float32, the eager oracle rounds each leaf once and adds in float64 —
    one rounding per leaf and one for the sum of each side."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    leaves = T.leaves(get_model(get_config(ARCH).reduced()).init_cache(
        2, 32, "meta"))
    return 2 * (len(leaves) + 1) * 2.0 ** -24


def test_fused_vs_eager_matches_the_reference(adapter_serving, ref_serving):
    """The same (old, new) pairs as the reference's: flips equal on both
    sides, the fused write's errors (the lane hash) and the eager
    oracle's (threefry uniforms) equal the reference's, and the two
    sides' energies agree within the float32 summation bound."""
    port = adapter_serving["fused_vs_eager"]
    ref = ref_serving["fused_vs_eager"]
    assert port["flips_fused"] == port["flips_eager"] > 0
    for k in ("ber_fused", "ber_eager", "errors_rel_err"):
        assert port[k] == ref[k], k
    assert port["energy_rel_err"] <= _fused_eager_bound()
    assert port["decode_wallclock_fused_s"] > 0


def test_arch_energy_with_the_port_model(jparams, ref_serving, monkeypatch):
    """The port's own model on the reference's parameters: energy, skip
    rate and token agreement within OWN_MODEL_RTOL; the realized BER is
    errors drawn over the flips, so its error count is held to three
    Poisson standard deviations of the reference's, as
    ``test_torch_serve`` holds per-request errors."""
    tp = params_from_jax(jax.tree.map(np.asarray, jparams))
    monkeypatch.setattr(serving_energy, "ServingEngine",
                        engine_factory(tp, adapter=False))
    port = serving_energy.arch_energy(ARCH, NEW_TOKENS, device=CPU)
    ref = ref_serving[ARCH]
    assert list(port) == list(ref)
    for k in ("extent_energy_pj", "saving_vs_basic", "write_skip_rate",
              "token_agreement_vs_exact"):
        assert port[k] == pytest.approx(ref[k], rel=OWN_MODEL_RTOL), k
    assert port["basic_energy_pj"] == ref["basic_energy_pj"]
    bits_total = ref["basic_energy_pj"] / TABLE1["basic"]["energy_pj"] \
        * WORD_BITS
    flips = (1 - ref["write_skip_rate"]) * bits_total
    errors = ref["ber_realized"] * flips
    assert abs(port["ber_realized"] - ref["ber_realized"]) * flips \
        <= 3 * errors ** 0.5


def test_kv_quant_rel_err_matches_the_reference(ref_serving):
    assert serving_energy.kv_quant_rel_err(device=CPU) == pytest.approx(
        ref_serving["kv_quant_rel_err"], rel=KV_QUANT_RTOL)


def test_bench_metrics_keys_match_the_reference(adapter_serving,
                                                ref_serving):
    out = {ARCH: dict(ref_serving[ARCH]),
           "kv_quant_rel_err": 0.0, **adapter_serving}
    assert set(serving_energy.bench_metrics(out)) == set(
        jse.bench_metrics(ref_serving))
