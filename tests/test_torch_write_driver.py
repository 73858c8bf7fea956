"""The port's write driver: Table 1 and the headline claims (twins of
``tests/test_write_driver.py``), and its word-level energy and latency
against the JAX reference.

The reference calibrates ``default_driver`` once per process, inside or
outside ``jax.ensure_compile_time_eval`` — whichever its process asks
first (its ``lru_cache``) — and the two differ in the last bit of some
energies and latencies. The port reproduces the serving path's
calibration (inside), so the reference side is calibrated that way here,
uncached, and the word-level values are then held equal.
"""
import jax
import numpy as np
import pytest

from repro.core import write_driver as jwd
from repro_torch.core import cache_sim, write_driver
from repro_torch.core.priority import Priority

LEVEL_MIX = {int(Priority.EXACT): 0.35, int(Priority.HIGH): 0.15,
             int(Priority.MID): 0.20, int(Priority.LOW): 0.30}


def _fig13_avg():
    mixes = [cache_sim.mix_from_fig13(w) for w in cache_sim.FIG13_WORKLOADS]
    return (float(np.mean([m.t01 for m in mixes])),
            float(np.mean([m.t10 for m in mixes])))


def _ref_levels(cfg=jwd.DriverConfig()):
    with jax.ensure_compile_time_eval():
        return jwd.default_driver.__wrapped__(cfg)


def _port_cfg(cfg):
    return write_driver.DriverConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


# ---------------------------------------------------------------------------
# twins of tests/test_write_driver.py
# ---------------------------------------------------------------------------

class TestLevelOrdering:
    def test_wer_strictly_improves_with_priority(self):
        levels = sorted(write_driver.default_driver(), key=lambda l: l.code)
        w01 = [l.wer_0to1 for l in levels]
        w10 = [l.wer_1to0 for l in levels]
        assert all(a > b for a, b in zip(w01, w01[1:]))
        assert all(a >= b for a, b in zip(w10, w10[1:]))

    def test_energy_rises_with_priority_modestly(self):
        levels = sorted(write_driver.default_driver(), key=lambda l: l.code)
        assert levels[-1].wer_0to1 < 1e-6, "exact level must be ~error-free"
        assert levels[0].wer_0to1 > 1e-3, "low level must actually approximate"

    def test_p2ap_costs_more(self):
        for l in write_driver.default_driver():
            assert l.e_0to1_pj > l.e_1to0_pj


class TestTable1Reproduction:
    def test_extent_word_energy(self):
        t01, t10 = _fig13_avg()
        levels = write_driver.default_driver()
        e = 0.0
        for code, frac in LEVEL_MIX.items():
            lvl = next(l for l in levels if l.code == code)
            e += frac * write_driver.WORD_BITS * (
                t01 * lvl.e_0to1_pj + t10 * lvl.e_1to0_pj)
        np.testing.assert_allclose(e, 337.2, rtol=0.01)

    def test_extent_word_latency(self):
        lat = write_driver.word_latency_ns(write_driver.default_driver(),
                                           LEVEL_MIX)
        np.testing.assert_allclose(lat, 6.9, rtol=0.02)

    def test_headline_energy_saving_vs_ranjan(self):
        """Paper abstract: 33.04% lower write energy than [18] (503.6 pJ)."""
        t01, t10 = _fig13_avg()
        levels = write_driver.default_driver()
        e = sum(frac * write_driver.WORD_BITS *
                (t01 * next(l for l in levels if l.code == c).e_0to1_pj +
                 t10 * next(l for l in levels if l.code == c).e_1to0_pj)
                for c, frac in LEVEL_MIX.items())
        saving = 1.0 - e / write_driver.TABLE1["ranjan_dac15"]["energy_pj"]
        np.testing.assert_allclose(saving, 0.3304, atol=0.005)

    def test_headline_latency_saving_vs_quark(self):
        """Paper abstract: 5.47% lower latency than [21] (7.3 ns)."""
        lat = write_driver.word_latency_ns(write_driver.default_driver(),
                                           LEVEL_MIX)
        saving = 1.0 - lat / write_driver.TABLE1["quark_islped17"][
            "latency_ns"]
        np.testing.assert_allclose(saving, 0.0547, atol=0.005)

    def test_area_overhead_row(self):
        t1 = write_driver.TABLE1
        overhead = t1["extent"]["area_mm2"] / t1["cast_tcad20"]["area_mm2"] - 1
        np.testing.assert_allclose(overhead, 0.037, atol=0.003)


class TestSelfTermination:
    def test_self_termination_saves_energy(self):
        on = write_driver.default_driver(
            write_driver.DriverConfig(self_terminate=True))
        off = write_driver.default_driver(
            write_driver.DriverConfig(self_terminate=False))
        for a, b in zip(on, off):
            assert a.e_0to1_pj < b.e_0to1_pj
            assert a.e_1to0_pj < b.e_1to0_pj

    def test_level_table_shapes(self):
        t = write_driver.level_table()
        for k in ("wer01", "wer10", "e01", "e10", "lat"):
            assert t[k].shape == (4,)


# ---------------------------------------------------------------------------
# parity with the reference (equal)
# ---------------------------------------------------------------------------

def test_table1_and_pulse_equal():
    assert write_driver.TABLE1 == jwd.TABLE1
    assert write_driver.PULSE_NS == jwd.PULSE_NS
    assert write_driver.WORD_BITS == jwd.WORD_BITS


@pytest.mark.parametrize("cfg", [
    jwd.DriverConfig(), jwd.DriverConfig(self_terminate=False),
    jwd.DriverConfig(delta=50.0)], ids=["default", "no_cmp", "delta50"])
def test_levels_equal(cfg):
    ref = _ref_levels(cfg)
    port = write_driver.default_driver(_port_cfg(cfg))
    for a, b in zip(ref, port):
        assert {f: getattr(a, f) for f in a.__dataclass_fields__} == {
            f: getattr(b, f) for f in b.__dataclass_fields__}


MIXES = [LEVEL_MIX, {0: 1.0}, {3: 1.0}, {1: 0.5, 2: 0.5},
         {0: 0.0, 3: 1.0}, {}]


@pytest.mark.parametrize("mix", MIXES, ids=lambda m: str(sorted(m.items())))
def test_word_energy_and_latency_equal(mix):
    ref = _ref_levels()
    port = write_driver.default_driver()
    for p_t in (0.5, 0.25, 1.0):
        assert write_driver.word_energy_pj(port, mix, p_t) == \
            jwd.word_energy_pj(ref, mix, p_t)
    assert write_driver.word_latency_ns(port, mix) == \
        jwd.word_latency_ns(ref, mix)
