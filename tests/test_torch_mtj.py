"""The port's MTJ device model (paper Table 3, Eq. 4-6, Fig. 6/7 + s-LLGS)
against the JAX reference, and twins of ``tests/test_mtj.py``.

Tolerances:
  * the closed forms (TMR, g, Ic, R_AP, Delta, the Eq. 5 switching time
    and the Fig. 7 voltage) are bit-equal: the same float32 operations in
    the same order, with XLA's CPU ``log`` (``rng.xla_log``);
  * the s-LLGS noise is bit-equal (``rng.normal_keys``);
  * s-LLGS trajectories agree to ``TRAJ_ATOL``: torch's float32 ``sin``
    and ``cos`` are not XLA's, and XLA may fuse the update's multiply-adds,
    so trajectories differ in the last bits (measured up to 2.2e-6 rad
    over 2000 steps);
  * a switching decision could flip where a final angle lies within that
    of pi/2, so ``monte_carlo_wer`` counts the decisions that differ; at
    the seeds below none does (held at ``DECISIONS_DIFFERING``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mtj as jmtj
from repro_torch import rng
from repro_torch.core import mtj

CPU = "cpu"
TRAJ_ATOL = 1e-5
DECISIONS_DIFFERING = 0
P = mtj.DEFAULT_MTJ
JP = jmtj.DEFAULT_MTJ
TEMPS = np.linspace(250.0, 450.0, 41)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# twins of tests/test_mtj.py
# ---------------------------------------------------------------------------

class TestTable3Calibration:
    def test_critical_current_at_300k(self):
        ic = float(mtj.critical_current(P, 300.0))
        np.testing.assert_allclose(ic, 200e-6, rtol=1e-5)

    def test_resistances(self):
        rp, rap = mtj.resistances(P, 300.0)
        np.testing.assert_allclose(float(rp), 4.2e3, rtol=1e-6)
        np.testing.assert_allclose(float(rap), 4.2e3 * 3.0, rtol=1e-3)


class TestFig6Thermal:
    def test_tmr_falls_with_temperature(self):
        tmr = mtj.tmr_of_t(P, np.linspace(250, 450, 20))
        assert np.all(np.diff(tmr) < 0)

    def test_tmr_falls_with_bias(self):
        assert float(mtj.tmr_of_t(P, 300.0, 0.5)) < float(
            mtj.tmr_of_t(P, 300.0, 0.0))

    def test_delta_falls_with_temperature(self):
        assert float(mtj.delta_of_t(P, 400.0)) < float(
            mtj.delta_of_t(P, 300.0))


class TestFig7SwitchingVoltage:
    def test_faster_switching_needs_more_voltage(self):
        assert float(mtj.switching_voltage(P, 2e-9)) > float(
            mtj.switching_voltage(P, 20e-9))

    def test_hotter_cell_needs_less_voltage(self):
        assert float(mtj.switching_voltage(P, 5e-9, 400.0)) < float(
            mtj.switching_voltage(P, 5e-9, 300.0))


class TestEq5SwitchingTime:
    def test_time_falls_with_current(self):
        t = mtj.switching_time(P, np.linspace(250e-6, 600e-6, 10))
        assert np.all(np.diff(t) < 0)


class TestLLGS:
    def test_overdrive_switches_underdrive_does_not(self):
        key = rng.PRNGKey(0)
        _, sw_hi = mtj.llgs_switch(key, P, 500e-6, 10e-9, device=CPU)
        _, sw_lo = mtj.llgs_switch(key, P, 20e-6, 10e-9, device=CPU)
        assert bool(sw_hi) and not bool(sw_lo)

    def test_monte_carlo_wer_monotone(self):
        key = rng.PRNGKey(1)
        w_lo = float(mtj.monte_carlo_wer(key, P, 260e-6, n=64, device=CPU))
        w_hi = float(mtj.monte_carlo_wer(key, P, 500e-6, n=64, device=CPU))
        assert w_hi <= w_lo

    def test_trajectory_is_bounded(self):
        traj, _ = mtj.llgs_switch(rng.PRNGKey(2), P, 400e-6, 5e-9,
                                  device=CPU)
        t = traj.numpy()
        assert np.all((t > 0) & (t < np.pi)) and np.all(np.isfinite(t))


class TestDirectionAsymmetry:
    def test_ap_to_p_has_lower_wer(self):
        key = rng.PRNGKey(5)
        w_p2ap = float(mtj.monte_carlo_wer(key, P, 260e-6, n=96, to_ap=True,
                                           device=CPU))
        w_ap2p = float(mtj.monte_carlo_wer(key, P, 260e-6, n=96,
                                           to_ap=False, device=CPU))
        assert w_ap2p < w_p2ap

    def test_ap_to_p_switches_faster(self):
        key = rng.PRNGKey(7)
        t_p2ap, s1 = mtj.llgs_switch(key, P, 500e-6, 10e-9, to_ap=True,
                                     device=CPU)
        t_ap2p, s2 = mtj.llgs_switch(key, P, 500e-6, 10e-9, to_ap=False,
                                     device=CPU)
        assert bool(s1) and bool(s2)
        cross = lambda tr: int(np.argmax(tr.numpy() > np.pi / 2))
        assert cross(t_ap2p) < cross(t_p2ap)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v_bias", [0.0, 0.2, 0.5])
def test_closed_forms_bit_equal(v_bias):
    t = jnp.asarray(TEMPS, jnp.float32)
    pairs = [
        (jmtj.tmr_of_t(JP, t, v_bias), mtj.tmr_of_t(P, TEMPS, v_bias)),
        (jmtj.g_factor(JP, t, v_bias), mtj.g_factor(P, TEMPS, v_bias)),
        (jmtj.critical_current(JP, t, v_bias),
         mtj.critical_current(P, TEMPS, v_bias)),
        (jmtj.resistances(JP, t, v_bias)[1],
         mtj.resistances(P, TEMPS, v_bias)[1]),
        (jmtj.delta_of_t(JP, t), mtj.delta_of_t(P, TEMPS)),
    ]
    for ref, port in pairs:
        assert _ulps(ref, port) == 0   # bit-equal


@pytest.mark.parametrize("temp", [250.0, 300.0, 400.0, 450.0])
def test_switching_time_and_voltage_bit_equal(temp):
    i = np.linspace(250e-6, 600e-6, 10).astype(np.float32)
    ref = jax.vmap(lambda ii: jmtj.switching_time(JP, ii, temp))(
        jnp.asarray(i))
    assert _ulps(ref, mtj.switching_time(P, i, temp)) == 0
    assert _ulps(jmtj.switching_time(JP, 3e-4, temp, theta0=0.1),
                 mtj.switching_time(P, 3e-4, temp, theta0=0.1)) == 0
    for t_sw in (2e-9, 5e-9, 20e-9):
        for to_ap in (True, False):
            assert _ulps(jmtj.switching_voltage(JP, t_sw, temp, to_ap),
                         mtj.switching_voltage(P, t_sw, temp, to_ap)) == 0


def test_constants_equal():
    assert mtj.AP_TO_P_OVERDRIVE == jmtj.AP_TO_P_OVERDRIVE
    assert dataclasses.asdict(P) == dataclasses.asdict(JP)


@pytest.mark.parametrize("seed,i_write,t_pulse,to_ap", [
    (0, 500e-6, 10e-9, True), (2, 400e-6, 5e-9, True),
    (7, 500e-6, 10e-9, False), (0, 20e-6, 10e-9, True)])
def test_llgs_switch_trajectory_matches(seed, i_write, t_pulse, to_ap):
    traj_j, sw_j = jmtj.llgs_switch(jax.random.PRNGKey(seed), JP, i_write,
                                    t_pulse, to_ap=to_ap)
    traj_t, sw_t = mtj.llgs_switch(rng.PRNGKey(seed), P, i_write, t_pulse,
                                   to_ap=to_ap, device=CPU)
    assert traj_t.dtype == torch.float32 and traj_t.shape == traj_j.shape
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), rtol=0,
                               atol=TRAJ_ATOL)
    assert bool(sw_t) == bool(sw_j)


def test_llgs_noise_bit_equal():
    keys = jax.random.split(jax.random.PRNGKey(3), 16)
    ref = jax.vmap(lambda k: jax.random.normal(k, (2000,), jnp.float32))(
        keys)
    port = mtj.llgs_noise(rng.split(rng.PRNGKey(3), 16), 2000)
    np.testing.assert_array_equal(port.view(np.uint32),
                                  np.asarray(ref).view(np.uint32))


@pytest.mark.parametrize("seed,n,i_write,to_ap", [
    (1, 64, 260e-6, True), (0, 64, 300e-6, True), (5, 48, 260e-6, False),
    (0, 32, 240e-6, True), (0, 32, 400e-6, True)])
def test_monte_carlo_wer_matches(seed, n, i_write, to_ap):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    traj_j, _ = jax.vmap(lambda k: jmtj.llgs_switch(
        k, JP, i_write, 10e-9, to_ap=to_ap))(keys)
    noise = mtj.llgs_noise(rng.split(rng.PRNGKey(seed), n), 2000)
    traj_t = mtj.integrate_llgs(torch.from_numpy(noise), P, i_write,
                                to_ap=to_ap).numpy()
    np.testing.assert_allclose(traj_t, np.asarray(traj_j), rtol=0,
                               atol=TRAJ_ATOL)
    half_pi = np.float32(np.pi / 2)
    differing = int(((np.asarray(traj_j)[:, -1] > half_pi)
                     != (traj_t[:, -1] > half_pi)).sum())
    assert differing <= DECISIONS_DIFFERING
    w_j = float(jmtj.monte_carlo_wer(jax.random.PRNGKey(seed), JP, i_write,
                                     n=n, to_ap=to_ap))
    w_t = mtj.monte_carlo_wer(rng.PRNGKey(seed), P, i_write, n=n,
                              to_ap=to_ap, device=CPU)
    assert w_t.dtype == torch.float32 and w_t.dim() == 0
    assert abs(float(w_t) - w_j) <= differing / n


def test_final_angles_only_equal_the_trajectory_end():
    noise = torch.from_numpy(mtj.llgs_noise(rng.split(rng.PRNGKey(9), 8),
                                            400))
    traj = mtj.integrate_llgs(noise, P, 300e-6)
    last = mtj.integrate_llgs(noise, P, 300e-6, trajectory=False)
    assert torch.equal(traj[:, -1], last)


def test_monte_carlo_without_device_targets_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        mtj.monte_carlo_wer(rng.PRNGKey(0), P, 300e-6, n=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        mtj.llgs_switch(rng.PRNGKey(0), P, 300e-6)


@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_stacked_key_draws_equal_per_key(shape):
    """``split_keys``, ``bits_keys`` and ``normal_keys`` equal ``vmap``
    over the stack, row for row, and each row the single-key draw."""
    keys = rng.split(rng.PRNGKey(11), 6)
    jkeys = jax.random.split(jax.random.PRNGKey(11), 6)
    np.testing.assert_array_equal(
        rng.split_keys(keys, 5), np.asarray(jax.vmap(
            lambda k: jax.random.split(k, 5))(jkeys)))
    normal = rng.normal_keys(keys, shape)
    ref = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(jkeys)
    np.testing.assert_array_equal(normal.view(np.uint32),
                                  np.asarray(ref).view(np.uint32))
    bits = rng.bits_keys(keys, shape)
    for j, k in enumerate(keys):
        np.testing.assert_array_equal(bits[j], rng.bits(k, shape))
        np.testing.assert_array_equal(normal[j].view(np.uint32),
                                      rng.normal(k, shape).view(np.uint32))
