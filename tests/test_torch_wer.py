"""The port's WER model (paper Eq. 1-3, 14-15) against the JAX reference,
and twins of ``tests/test_wer.py``.

Every form is held bit-equal to the reference (the same float32
operations in the same order, ``exp`` by XLA's CPU polynomial):
``delta_of_t``, ``wer_thermal``, ``wer_thermal_at`` and
``wer_exponential`` on the host; ``wer_bit_t`` and
``expected_pulse_fraction_t`` on torch tensors against the reference
evaluated under ``vmap``, as its Monte Carlo evaluates it (the grid
``jnp.linspace`` evaluated eagerly, the trapezoid over the batch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare env: deterministic fallback, module still runs
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core import mtj as jmtj
from repro.core import wer as jwer
from repro_torch.core import mtj
from repro_torch.core import wer


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# twins of tests/test_wer.py
# ---------------------------------------------------------------------------

class TestEq1:
    def test_range(self):
        w = wer.wer_bit(np.asarray([1e-10, 1e-9, 5e-9, 1e-8, 2e-8]), 1.5,
                        60.0)
        assert np.all((w >= 0) & (w <= 1))

    def test_monotone_in_pulse_width(self):
        w = wer.wer_bit(np.geomspace(1e-10, 3e-8, 25), 1.4, 60.0)
        assert np.all(np.diff(w) <= 1e-9), "WER must fall as pulse widens"

    def test_monotone_in_overdrive(self):
        w = wer.wer_bit(1e-8, np.linspace(1.05, 2.5, 40), 60.0)
        assert np.all(np.diff(w) <= 1e-9), "WER must fall as current rises"

    def test_subcritical_never_switches(self):
        assert float(wer.wer_bit(1e-8, 0.9, 60.0)) == 1.0
        assert float(wer.wer_bit(1e-8, 1.0, 60.0)) == 1.0

    @settings(max_examples=60, deadline=None)
    @given(t_ns=st.floats(0.1, 50.0), i_rel=st.floats(1.01, 3.0),
           delta=st.floats(20.0, 90.0))
    def test_valid_probability_everywhere(self, t_ns, i_rel, delta):
        w = float(wer.wer_bit(t_ns * 1e-9, i_rel, delta))
        assert 0.0 <= w <= 1.0 and np.isfinite(w)

    @settings(max_examples=30, deadline=None)
    @given(t_ns=st.floats(1.0, 20.0), i_rel=st.floats(1.1, 2.5),
           d1=st.floats(20.0, 50.0), d2=st.floats(50.0, 90.0))
    def test_higher_delta_harder_to_switch(self, t_ns, i_rel, d1, d2):
        w1 = float(wer.wer_bit(t_ns * 1e-9, i_rel, d1))
        w2 = float(wer.wer_bit(t_ns * 1e-9, i_rel, d2))
        assert w2 >= w1 - 1e-7


class TestEq2Consistency:
    def test_same_shape_as_eq1(self):
        w2 = wer.wer_thermal(np.geomspace(1e-10, 3e-8, 20), 1.4, 60.0)
        assert np.all(np.diff(w2) <= 1e-9)
        assert 0.0 <= w2.min() and w2.max() <= 1.0


class TestEq3:
    def test_exponential_incomplete_write(self):
        p = wer.wer_exponential(np.asarray([0.0, 1e-8, 1e-7]), 1e-8)
        np.testing.assert_allclose(
            p, [1.0, np.exp(-1.0), np.exp(-10.0)], rtol=1e-5)


class TestEq14_15:
    def test_switching_time_explodes_below_vc(self):
        assert float(wer.switching_time(60.0, 0.5)) > 1e3 * float(
            wer.switching_time(60.0, 1.0))

    def test_psw_increases_with_pulse_and_voltage(self):
        p1 = float(wer.switching_probability(1e-9, 60.0, 1.1))
        p2 = float(wer.switching_probability(5e-9, 60.0, 1.1))
        p3 = float(wer.switching_probability(1e-9, 60.0, 1.5))
        assert p2 >= p1 and p3 >= p1

    def test_thermal_assist(self):
        hot = float(wer.switching_probability(5e-9, 40.0, 0.98))
        cold = float(wer.switching_probability(5e-9, 70.0, 0.98))
        assert hot > cold


class TestDirectionAsymmetry:
    def test_p2ap_harder(self):
        assert float(wer.wer_from_level(1e-8, 1.4, 60.0, True)) > float(
            wer.wer_from_level(1e-8, 1.4, 60.0, False))


class TestSelfTermination:
    def test_pulse_fraction_bounds(self):
        assert 0.0 < float(wer.expected_pulse_fraction(1e-8, 1.8, 60.0)) < 1.0

    def test_stronger_drive_terminates_earlier(self):
        assert float(wer.expected_pulse_fraction(1e-8, 2.0, 60.0)) < float(
            wer.expected_pulse_fraction(1e-8, 1.2, 60.0))


# ---------------------------------------------------------------------------
# parity with the reference (bit-equal)
# ---------------------------------------------------------------------------

def test_constants_equal():
    assert wer.ALPHA_DAMPING == jwer.ALPHA_DAMPING
    assert wer.GAMMA_GYRO == jwer.GAMMA_GYRO
    assert wer.MU_0 == jwer.MU_0
    assert wer.H_K_EFF == jwer.H_K_EFF


def test_delta_of_t_bit_equal():
    t = np.linspace(250.0, 450.0, 21)
    np.testing.assert_array_equal(
        _bits(wer.delta_of_t(t)),
        _bits(jwer.delta_of_t(jnp.asarray(t, jnp.float32))))


@pytest.mark.parametrize("i_rel", [0.9, 1.0, 1.05, 1.4, 1.8, 2.5])
@pytest.mark.parametrize("delta", [40.0, 60.0, 75.0])
def test_wer_thermal_bit_equal(i_rel, delta):
    ts = np.geomspace(1e-10, 3e-8, 20).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(wer.wer_thermal(ts, i_rel, delta)),
        _bits(jwer.wer_thermal(jnp.asarray(ts), i_rel, delta)))


@pytest.mark.parametrize("t_k", [250.0, 300.0, 350.0, 400.0, 450.0])
def test_wer_thermal_at_bit_equal(t_k):
    for i_rel in (1.2, 1.4, 1.8):
        assert _bits(wer.wer_thermal_at(1e-8, i_rel, t_k)) == _bits(
            jwer.wer_thermal_at(1e-8, i_rel, t_k, jmtj.DEFAULT_MTJ))


def test_wer_exponential_bit_equal():
    t_wr = np.asarray([0.0, 1e-9, 5e-9, 1e-8, 3e-8, 1e-7], np.float32)
    for t_sw in (1e-9, 1e-8, 0.0):
        np.testing.assert_array_equal(
            _bits(wer.wer_exponential(t_wr, t_sw)),
            _bits(jwer.wer_exponential(jnp.asarray(t_wr), t_sw)))


def _corners(seed: int, n: int):
    rs = np.random.default_rng(seed)
    return (rs.uniform(0.95, 2.4, n).astype(np.float32),
            rs.uniform(45.0, 75.0, n).astype(np.float32))


@pytest.mark.parametrize("t_w", [5e-9, 1e-8])
@pytest.mark.parametrize("seed", [0, 1])
def test_wer_bit_t_bit_equal(seed, t_w):
    i, d = _corners(seed, 256)
    ref = jax.vmap(lambda a, b: jwer.wer_bit(t_w, a, b))(
        jnp.asarray(i), jnp.asarray(d))
    port = wer.wer_bit_t(t_w, torch.from_numpy(i), torch.from_numpy(d))
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(_bits(port.numpy()), _bits(ref))
    np.testing.assert_array_equal(_bits(port.numpy()),
                                  _bits(wer.wer_bit(t_w, i, d)))


@pytest.mark.parametrize("t_w", [5e-9, 1e-8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expected_pulse_fraction_t_bit_equal(seed, t_w):
    i, d = _corners(seed, 512)
    i = np.maximum(i, np.float32(1.001))
    ref = jax.vmap(lambda a, b: jwer.expected_pulse_fraction(t_w, a, b))(
        jnp.asarray(i), jnp.asarray(d))
    port = wer.expected_pulse_fraction_t(t_w, torch.from_numpy(i),
                                         torch.from_numpy(d))
    np.testing.assert_array_equal(_bits(port.numpy()), _bits(ref))


def test_exp_f32_t_equals_host_form():
    x = np.linspace(-100.0, 88.0, 100001).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(wer._exp_f32_t(torch.from_numpy(x)).numpy()),
        _bits(wer._exp_f32(x)))
    np.testing.assert_array_equal(
        _bits(wer._exp_f32_t(torch.from_numpy(x)).numpy()),
        _bits(jnp.exp(jnp.asarray(x))))
