"""The port's cache simulator, ECC model, variation Monte Carlo and
priority tagging against the JAX reference; twins of
``tests/test_substrate.py``'s ``TestCacheSim`` and ``TestEnergyModelMC``.

Tolerances:
  * transition mixes, ECC and Fig. 14 values priced with the driver table:
    ``TABLE_RTOL`` = 1e-6. The reference calibrates its table once per
    process, inside or outside ``jax.ensure_compile_time_eval``
    (whichever comes first), and the two variants differ in the last bit
    of some energies and latencies; WERs and transition counts are equal
    in both and are held exactly;
  * the variation Monte Carlo's per-corner samples are bit-equal; its
    summaries ``SUMMARY_RTOL`` = 1e-6: the port sums the mean and std in
    float64 where the reference sums float32 in XLA's order (measured
    3.8e-7 at most over n = 64-1000);
  * an oracle write's energy: ``ORACLE_ENERGY_RTOL`` = 1e-5. The port sums
    the per-plane energies in float64 and rounds once; the reference's
    oracle sums (elements x bits) in one float32 reduction (1.9e-6 apart
    here). Flip and error counts are exact.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache_sim as jcs
from repro.core import ecc as jecc
from repro.core import energy_model as jem
from repro.core import priority as jprio
from repro.core.approx_store import approx_write_with_stats as japprox
from repro_torch import rng
from repro_torch import tree as tree_mod
from repro_torch.core import cache_sim, ecc, energy_model, priority
from repro_torch.core.approx_store import approx_write_with_stats
from repro_torch.core.priority import Priority

CPU = "cpu"
TABLE_RTOL = 1e-6
SUMMARY_RTOL = 1e-6
ORACLE_ENERGY_RTOL = 1e-5


def _close(a, b, rtol):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k], rtol)
    elif isinstance(a, bool) or isinstance(b, bool):
        assert a == b
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# twins of test_substrate.py::TestCacheSim and ::TestEnergyModelMC
# ---------------------------------------------------------------------------

class TestCacheSim:
    def test_fig13_mixes_are_distributions(self):
        for w, m in cache_sim.FIG13_WORKLOADS.items():
            assert abs(sum(m.values()) - 1.0) < 1e-6, w

    def test_expensive_share_near_80pct(self):
        shares = [cache_sim.mix_from_fig13(w).expensive_share
                  for w in cache_sim.FIG13_WORKLOADS]
        assert 0.7 < float(np.mean(shares)) < 0.9

    def test_fig14_scheme_ordering(self):
        for row in cache_sim.fig14_normalized_energy().values():
            assert row["extent"] < row["cast"] < row["quark"] < row["basic"]
            assert row["basic"] == 1.0

    def test_trace_mix_measures_real_writes(self):
        old = torch.zeros((64,), dtype=torch.int32)
        new = torch.full((64,), 0xFF, dtype=torch.int32)
        m = cache_sim.trace_transition_mix(old, new)
        np.testing.assert_allclose(m.t01, 8 / 32, rtol=1e-6)
        np.testing.assert_allclose(m.t00, 24 / 32, rtol=1e-6)

    def test_wer_for_mix_positive(self):
        assert 0 < cache_sim.wer_for_mix(cache_sim.mix_from_fig13("jpeg")) < 0.1


class TestEnergyModelMC:
    def test_monte_carlo_runs_and_is_sane(self):
        out = energy_model.monte_carlo_variation(rng.PRNGKey(0), n=200,
                                                 device=CPU)
        assert out["energy_full_pj"]["std"] > 0
        assert out["energy_approx_pj"]["mean"] < out["energy_full_pj"]["mean"]

    def test_fig15_approx_variation_smaller(self):
        out = energy_model.monte_carlo_variation(rng.PRNGKey(1), n=300,
                                                 device=CPU)
        assert out["energy_approx_pj"]["p95"] < out["energy_full_pj"]["p95"]

    def test_fig16_voltage_sensitivity(self):
        sweep = energy_model.voltage_sweep(rng.PRNGKey(2), sigmas=(0.0, 0.05),
                                           n=100, device=CPU)
        assert (sweep[0.05]["energy_full_pj"]["std"]
                > sweep[0.0]["energy_full_pj"]["std"])

    def test_meter_summary(self):
        m = energy_model.StepEnergyMeter()
        _, st = approx_write_with_stats(
            rng.PRNGKey(0), torch.zeros((8,), dtype=torch.float32),
            torch.ones((8,), dtype=torch.float32), Priority.EXACT)
        m.add("kv", st)
        s = m.summary()
        assert s["total"]["energy_pj"] > 0
        assert 0 <= s["total"]["write_skip_rate"] <= 1


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def test_fig13_workloads_equal():
    assert cache_sim.FIG13_WORKLOADS == jcs.FIG13_WORKLOADS
    for w in jcs.FIG13_WORKLOADS:
        a, b = cache_sim.mix_from_fig13(w), jcs.mix_from_fig13(w)
        assert (a.flip_fraction, a.expensive_share) == (
            b.flip_fraction, b.expensive_share)


DTYPES = [(torch.float32, jnp.float32, np.float32),
          (torch.bfloat16, jnp.bfloat16, np.float32),
          (torch.int8, jnp.int8, np.int8),
          (torch.int32, jnp.int32, np.int32)]


@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: str(d[0]))
@pytest.mark.parametrize("seed", [0, 1])
def test_trace_transition_mix_equal(dtypes, seed):
    dt_t, dt_j, dt_np = dtypes
    rs = np.random.default_rng(seed)
    shape = (3, 7, 11)
    if dt_np is np.float32:
        a = rs.standard_normal(shape).astype(np.float32)
        b = np.where(rs.random(shape) < 0.3, a,
                     rs.standard_normal(shape).astype(np.float32))
    else:
        info = np.iinfo(dt_np)
        a = rs.integers(info.min, info.max, shape, dtype=dt_np)
        b = rs.integers(info.min, info.max, shape, dtype=dt_np)
    ta, tb = (torch.from_numpy(x).to(dt_t) for x in (a, b))
    ja, jb = (jnp.asarray(x).astype(dt_j) for x in (a, b))
    port = cache_sim.trace_transition_mix(ta, tb)
    ref = jcs.trace_transition_mix(ja, jb)
    assert (port.t01, port.t10, port.t00, port.t11) == (
        ref.t01, ref.t10, ref.t00, ref.t11)


@pytest.mark.parametrize("scheme", ["basic", "quark", "cast", "extent"])
def test_energy_per_word_matches(scheme):
    for w in jcs.FIG13_WORKLOADS:
        _close(cache_sim.energy_per_word(cache_sim.mix_from_fig13(w), scheme),
               jcs.energy_per_word(jcs.mix_from_fig13(w), scheme), TABLE_RTOL)
    mix = {int(Priority.LOW): 1.0}
    _close(cache_sim.energy_per_word(cache_sim.mix_from_fig13("sha"),
                                     "extent", mix),
           jcs.energy_per_word(jcs.mix_from_fig13("sha"), "extent", mix),
           TABLE_RTOL)


def test_fig14_and_wer_for_mix_match():
    _close(cache_sim.fig14_normalized_energy(), jcs.fig14_normalized_energy(),
           TABLE_RTOL)
    for w in jcs.FIG13_WORKLOADS:
        assert cache_sim.wer_for_mix(cache_sim.mix_from_fig13(w)) == \
            jcs.wer_for_mix(jcs.mix_from_fig13(w))


@pytest.mark.parametrize("level", list(Priority))
def test_ecc_compare_matches(level):
    port = ecc.compare(level)
    ref = jecc.compare(jprio.Priority(int(level)))
    _close(port, ref, TABLE_RTOL)
    for scheme in ("ecc", "extent"):
        assert port[scheme]["raw_ber"] == ref[scheme]["raw_ber"]
        assert port[scheme]["storage_overhead"] == \
            ref[scheme]["storage_overhead"]


@pytest.mark.parametrize("p", [0.0, 1e-10, 1e-4, 3e-2])
def test_residual_word_failure_equal(p):
    assert ecc.residual_word_failure(p) == jecc.residual_word_failure(p)


def test_exact_baseline_energy_equal():
    for bits in (0, 64, 1000, 123456):
        assert energy_model.exact_baseline_energy_pj(bits) == \
            jem.exact_baseline_energy_pj(bits)


@pytest.mark.parametrize("n,seed,sigma", [(64, 0, 0.03), (100, 2, 0.05),
                                          (64, 1, 0.0), (64, 3, 0.10)])
def test_variation_samples_bit_equal(n, seed, sigma):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    ref = jax.vmap(lambda k: jem._one_sample(k, sigma, 60.0))(keys)
    z = torch.from_numpy(energy_model.variation_draws(rng.PRNGKey(seed), n))
    port = energy_model.variation_samples(z, sigma)
    assert port._fields == ref._fields
    for f in ref._fields:
        np.testing.assert_array_equal(
            getattr(port, f).numpy().view(np.uint32),
            np.asarray(getattr(ref, f)).view(np.uint32), f)


@pytest.mark.parametrize("seed,sigma", [(0, 0.03), (1, 0.10)])
def test_monte_carlo_variation_matches(seed, sigma):
    port = energy_model.monte_carlo_variation(
        rng.PRNGKey(seed), n=64, v_supply_sigma=sigma, device=CPU)
    ref = jem.monte_carlo_variation(jax.random.PRNGKey(seed), n=64,
                                    v_supply_sigma=sigma)
    assert set(port) == set(ref)
    _close(port, ref, SUMMARY_RTOL)
    for k in ("energy_full_pj", "energy_approx_pj", "wer_low", "i_rel_eff"):
        assert port[k]["min"] == ref[k]["min"]   # the samples are exact
        assert port[k]["max"] == ref[k]["max"]


def test_voltage_sweep_matches():
    port = energy_model.voltage_sweep(rng.PRNGKey(2), sigmas=(0.0, 0.05),
                                      n=64, device=CPU)
    ref = jem.voltage_sweep(jax.random.PRNGKey(2), sigmas=(0.0, 0.05), n=64)
    assert list(port) == list(ref)
    _close(port, ref, SUMMARY_RTOL)


def test_percentile_f32_matches_jnp():
    rs = np.random.default_rng(0)
    for n in (64, 200, 250):
        x = (rs.standard_normal(n) * 3).astype(np.float32)
        for q in (5, 95):
            np.testing.assert_allclose(
                energy_model.percentile_f32(x, q),
                float(jnp.percentile(jnp.asarray(x), q)),
                rtol=SUMMARY_RTOL)


def test_monte_carlo_variation_without_device_targets_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        energy_model.monte_carlo_variation(rng.PRNGKey(0), n=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        energy_model.voltage_sweep(rng.PRNGKey(0), sigmas=(0.0,), n=8)


def test_meter_add_matches_reference():
    m_t, m_j = energy_model.StepEnergyMeter(), jem.StepEnergyMeter()
    old = np.zeros((4, 8), np.float32)
    new = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    for i, level in enumerate(Priority):
        _, st = approx_write_with_stats(rng.PRNGKey(i), torch.from_numpy(old),
                                        torch.from_numpy(new), level)
        _, sj = japprox(jax.random.PRNGKey(i), jnp.asarray(old),
                        jnp.asarray(new), jprio.Priority(int(level)))
        m_t.add(f"s{i % 2}", st)
        m_j.add(f"s{i % 2}", sj)
    port, ref = m_t.summary(), m_j.summary()
    for s_t, s_j in zip([*port["streams"].values(), port["total"]],
                        [*ref["streams"].values(), ref["total"]]):
        e_t, e_j = s_t.pop("energy_pj"), s_j.pop("energy_pj")
        np.testing.assert_allclose(e_t, e_j, rtol=ORACLE_ENERGY_RTOL)
        _close(s_t, s_j, TABLE_RTOL)   # counts equal, latency to the table


# ---------------------------------------------------------------------------
# priority tagging
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    count: object
    mu: object
    nu: object


class Momentum(NamedTuple):
    m: object
    v: object


def _opt_tree(lib):
    z = lambda *s: lib.zeros(s)
    return {
        "params": {"w": z(2, 3), "b": z(3), "ln": {"scale": z(3)}},
        "opt": [AdamState(z(), {"w": z(2, 3), "b": z(3)},
                          {"w": z(2, 3), "b": z(3)}),
                Momentum(z(3), z(3))],
        "step": z(),
        "extra": (z(1), None),
    }


def test_tag_pytree_checkpoint_policy_equal():
    port = priority.tag_pytree(_opt_tree(torch), priority.checkpoint_policy)
    ref = jprio.tag_pytree(_opt_tree(jnp), jprio.checkpoint_policy)
    p_leaves = jax.tree_util.tree_leaves(
        port, is_leaf=lambda x: isinstance(x, priority.Priority))
    r_leaves = jax.tree_util.tree_leaves(ref)
    assert [int(p) for p in p_leaves] == [int(r) for r in r_leaves]
    assert {int(p) for p in p_leaves} == {0, 1, 3}   # LOW, MID and EXACT


def test_keystr_renders_like_jax():
    tree = _opt_tree(torch)
    seen = []
    tree_mod.map_with_path(lambda path, leaf: seen.append(priority.keystr(path)),
                    tree)
    ref = [jax.tree_util.keystr(p) for p, _ in
           jax.tree_util.tree_flatten_with_path(_opt_tree(jnp))[0]]
    assert seen == ref


def test_tag_pytree_rules_and_default():
    rule = lambda path, leaf: ("low" if leaf.ndim == 2 else
                               (None if leaf.ndim == 0 else 2))
    port = priority.tag_pytree(_opt_tree(torch), rule,
                               default=priority.Priority.MID)
    ref = jprio.tag_pytree(_opt_tree(jnp), rule,
                           default=jprio.Priority.MID)
    p_leaves = jax.tree_util.tree_leaves(
        port, is_leaf=lambda x: isinstance(x, priority.Priority))
    assert [int(p) for p in p_leaves] == [
        int(r) for r in jax.tree_util.tree_leaves(ref)]


@pytest.mark.parametrize("level", list(Priority))
def test_priority_mask_and_of_equal(level):
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16), (torch.int8, jnp.int8)):
        m = priority.priority_mask(dt_t, level)
        assert m.dtype == torch.int32
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(jprio.priority_mask(dt_j, jprio.Priority(
                int(level)))))
    tags = {"a": level}
    assert priority.priority_of(tags, "a") == jprio.priority_of(tags, "a")
    assert priority.priority_of([level], 0) == jprio.priority_of([level], 0)
