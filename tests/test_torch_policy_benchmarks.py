"""The port's policy benchmarks against the reference modules on the CPU:
``endurance_sweep``, ``prefix_reuse`` and ``workload_mixes`` (its
frontier table for two arms, and the adversarial prefix x wear flood).

The serving benchmarks run through the reference-numerics adapter
(``JaxModel``, put in place of the module's engine), so every count —
tokens, flips, errors, links, wear, rotations, scrub passes — is exact;
energies are float32 sums in another order, held at ``RTOL`` = 1e-5
(``test_torch_serve._check_exact``). ``endurance_sweep`` runs on the
memory substrate only, on the same host normal draws as the reference:
its counts are exact, its energies at ``RTOL``.
"""
import jax
import numpy as np
import pytest
import torch

from benchmarks import endurance_sweep as jes
from benchmarks import prefix_reuse as jpr
from benchmarks import workload_mixes as jwm
from repro.configs import get_config as jget
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.workload import TraceSource as JTraceSource
from repro.workload import build_ramp as jbuild_ramp
from repro.workload.replay import join_reports as jjoin_reports
from repro_torch.benchmarks import endurance_sweep, prefix_reuse
from repro_torch.benchmarks import workload_mixes
from repro_torch.configs import get_config
from repro_torch.workload import build_ramp
from test_torch_serve import ARCH
from test_torch_serving_benchmarks import engine_factory, jparams  # noqa

CPU = torch.device("cpu")
RTOL = 1e-5
#: the energy-valued keys of a flattened serve report
ENERGY_KEYS = ("energy_pj", "energy_pj_per_step", "lifetime_energy_pj",
               "scrub_energy_pj", "remap_energy_pj", "prefix_net_saved_pj")


def _same_row(port: dict, ref: dict, what) -> None:
    """Counts exact, energies at RTOL, the same keys."""
    assert list(port) == list(ref), what
    for k, v in ref.items():
        if k in ENERGY_KEYS:
            np.testing.assert_allclose(port[k], v, rtol=RTOL,
                                       err_msg=f"{what} {k}")
        else:
            assert port[k] == v, (what, k, port[k], v)


# ---------------------------------------------------------------------------
# endurance_sweep
# ---------------------------------------------------------------------------

def test_endurance_sweep_matches_the_reference():
    """steps=64, shape=(8, 32): wear, time to first worn group, worn
    groups, rotations and stuck-at errors exact; energies at RTOL."""
    port = endurance_sweep.run(steps=64, shape=(8, 32), device=CPU)
    ref = jes.run(steps=64, shape=(8, 32))
    assert port["claims"] == ref["claims"] and all(port["claims"].values())
    for k in ("steps", "budget", "group_cols", "wear_leveling_gain"):
        assert port[k] == ref[k], k
    for arm in ("none", "rotate"):
        for k, v in ref[arm].items():
            if k.endswith("energy_pj"):
                np.testing.assert_allclose(port[arm][k], v, rtol=RTOL)
            else:
                assert port[arm][k] == v, (arm, k)
    np.testing.assert_allclose(port["remap_overhead_frac"],
                               ref["remap_overhead_frac"], rtol=RTOL)
    assert port["backend"] == "lanes_ref"


# ---------------------------------------------------------------------------
# prefix_reuse
# ---------------------------------------------------------------------------

def test_prefix_reuse_matches_the_reference(jparams, monkeypatch):  # noqa
    """n=8 through the adapter: the claims, the prefix ledger and the
    BERs exact; admission energies at RTOL."""
    monkeypatch.setattr(prefix_reuse, "ServingEngine",
                        engine_factory(jparams, adapter=True))
    port = prefix_reuse.run(n=8, device=CPU)
    ref = jpr.run(n=8)
    assert port["claims"] == ref["claims"]
    assert port["workload"] == ref["workload"]
    assert port["prefix"]["linked_admissions"] >= 1
    for k, v in ref["prefix"].items():
        if k.endswith("energy_pj") or k.endswith("saved_pj"):
            np.testing.assert_allclose(port["prefix"][k], v, rtol=RTOL)
        else:
            assert port["prefix"][k] == v, k
    for k in ("ber_off", "ber_on", "ber_rel_delta"):
        assert port[k] == ref[k], k
    for k in ("admission_energy_off_pj", "admission_energy_on_pj",
              "admission_energy_reduction"):
        np.testing.assert_allclose(port[k], ref[k], rtol=RTOL)
    assert set(prefix_reuse.bench_metrics(port)) == set(
        jpr.bench_metrics(ref))


# ---------------------------------------------------------------------------
# workload_mixes
# ---------------------------------------------------------------------------

def test_adversarial_matches_the_reference(jparams, monkeypatch):  # noqa
    """The prefix x wear flood: links, worn groups, rotations and every
    other count exact in both arms; its claims hold."""
    monkeypatch.setattr(workload_mixes, "ServingEngine",
                        engine_factory(jparams, adapter=True))
    port = workload_mixes.adversarial(device=CPU)
    ref = jwm.adversarial()
    assert port["claims"] == ref["claims"] and all(port["claims"].values())
    for arm in ("none", "rotate"):
        _same_row(port[arm], ref[arm], arm)


#: two arms of the frontier: the plain engine and the prefix cache
FRONTIER_ARMS = ("baseline", "prefix")


def _reference_frontier(events: int):
    """The reference run()'s (mix, arm) loop, restricted to
    FRONTIER_ARMS."""
    cfg = jget(ARCH).reduced()
    ramp = jbuild_ramp(cfg, seed=0, n=events)
    max_seq = max(m["trace"].max_seq() for m in ramp)
    max_new = max(m["trace"].max_new_tokens() for m in ramp)
    entries = []
    for name in FRONTIER_ARMS:
        arm = jwm.ARMS[name]
        eng = JEngine(cfg, JServeConfig(max_seq=max_seq,
                                        max_new_tokens=max_new,
                                        **arm["scfg"]))
        for m in ramp:
            report = jwm._scheduler(eng, arm).run(JTraceSource(
                m["trace"], cfg, quality_override=arm.get("quality")))
            entries.append({"mix": m["mix"], "name": m["name"],
                            "pressure": m["pressure"], "arm": name,
                            "report": report})
    return jjoin_reports(entries)


def test_frontier_matches_the_reference(jparams, monkeypatch):  # noqa
    """events=4, the baseline and prefix arms through the adapter: the
    joined table's columns and every row's counts exact, energies at
    RTOL."""
    monkeypatch.setattr(workload_mixes, "ServingEngine",
                        engine_factory(jparams, adapter=True))
    cfg = get_config(ARCH).reduced()
    port = workload_mixes.frontier(cfg, build_ramp(cfg, seed=0, n=4),
                                   FRONTIER_ARMS, CPU)
    ref = _reference_frontier(4)
    assert port["columns"] == ref["columns"]
    assert len(port["rows"]) == len(ref["rows"]) == 2 * 6
    for p, r in zip(port["rows"], ref["rows"]):
        _same_row(p, r, (r["arm"], r["name"]))
    assert any(r["linked_admissions"] >= 1 for r in port["rows"]
               if r["arm"] == "prefix")


def test_arms_match_the_reference():
    assert list(workload_mixes.ARMS) == list(jwm.ARMS)
    for name, arm in jwm.ARMS.items():
        assert workload_mixes.ARMS[name] == arm, name
    assert workload_mixes.CAPACITY == jwm.CAPACITY
