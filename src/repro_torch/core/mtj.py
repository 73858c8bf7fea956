"""MTJ device model: the paper's device layer (Table 3 + Eq. 4-6).

  * cell constants from paper Table 3 (PMA CoFeB/MgO MTJ);
  * TMR(T, V) roll-off (Fig. 6), g(T) (Eq. 6), the critical current
    Ic(T) (Eq. 4), the resistances R_P / R_AP, the thermal stability
    factor Delta(T), the switching time (Eq. 5) and the switching voltage
    (Fig. 7): host float32 numpy, the reference's operations in its
    order, with XLA's CPU ``log`` (``rng.xla_log``), so each equals the
    reference's value bit for bit;
  * the stochastic macrospin (s-LLGS) integrator for the Fig. 2/3/5
    transients and its Monte-Carlo WER: torch tensors on a device (the
    card unless the caller asks for the CPU). The noise is the
    reference's, drawn on the host (``rng.normal_keys``) and moved to
    the device once; all n trajectories advance together, one ``(n,)``
    state through ``n_steps`` Euler steps, and the loop never reads the
    device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.device import resolve_device

# physical constants (SI)
KB = 1.380649e-23        # Boltzmann, J/K
MU_B = 9.2740100783e-24  # Bohr magneton, J/T
E_CHARGE = 1.602176634e-19
GAMMA = 1.76086e11       # gyromagnetic ratio, rad/(s.T)
MU_0 = 4.0e-7 * math.pi


@dataclasses.dataclass(frozen=True)
class MTJParams:
    """Paper Table 3 defaults (PMA STT-MTJ, 32 nm flow)."""
    area_m2: float = 16e-15
    tmr_0: float = 2.0
    t_ox: float = 8.5e-10
    ra_ohm_um2: float = 5.0
    i_c0: float = 200e-6
    t_free: float = 1.3e-9
    r_p: float = 4.2e3
    r_ap: float = 6.6e3
    temperature: float = 300.0
    delta0: float = 60.0
    alpha: float = 0.01
    ms: float = 1.05e6
    h_k: float = 1.8e5
    tau0: float = 1.0e-9
    spin_polarization: float = 0.62


DEFAULT_MTJ = MTJParams()

# AP->P effective-overdrive multiplier vs. P->AP at equal drive current
# (spin-torque efficiency asymmetry; see llgs_switch)
AP_TO_P_OVERDRIVE = 1.3

f32 = np.float32


# ---------------------------------------------------------------------------
# Eq. 4-6 and Fig. 6/7: closed forms (host float32)
# ---------------------------------------------------------------------------

def tmr_of_t(p: MTJParams, t, v_bias=0.0) -> np.ndarray:
    """TMR(T, V) roll-off (Fig. 6): linear in T around 300 K (0.08 %/K),
    times the bias suppression 1 / (1 + (V / 0.5 V)^2)."""
    t = np.asarray(t, f32)
    tmr_t = f32(p.tmr_0) * np.maximum(
        f32(1.0) - f32(8.0e-4) * (t - f32(300.0)), f32(0.05))
    v = np.asarray(v_bias, f32)
    x = v / f32(0.5)
    return (tmr_t / (f32(1.0) + x * x)).astype(f32)


def g_factor(p: MTJParams, t, v_bias=0.0) -> np.ndarray:
    """Eq. 6: g(T) = sqrt(TMR (TMR+2)) / (2 (TMR+1))."""
    tmr = tmr_of_t(p, t, v_bias)
    return (np.sqrt(tmr * (tmr + f32(2.0)))
            / (f32(2.0) * (tmr + f32(1.0)))).astype(f32)


def _ic_raw(p: MTJParams, g, e_barrier) -> np.ndarray:
    """2 alpha (gamma e / (mu_B g)) E, with the reference's weak-typed
    Python constants folded first."""
    ge = f32(GAMMA * E_CHARGE) / (f32(MU_B) * g)
    return (f32(2.0 * p.alpha) * ge * e_barrier).astype(f32)


def critical_current(p: MTJParams, t=300.0, v_bias=0.0) -> np.ndarray:
    """Eq. 4: Ic = 2 alpha (gamma e / (mu_B g(T))) E, calibrated so
    Ic(300 K) == p.i_c0; T enters through g(T) and E(T) = Delta(T) kB T."""
    t = np.asarray(t, f32)
    e_barrier = delta_of_t(p, t) * f32(KB) * t
    raw = _ic_raw(p, g_factor(p, t, v_bias), e_barrier)
    raw300 = _ic_raw(p, g_factor(p, 300.0, 0.0),
                     f32(p.delta0 * KB * 300.0))
    return (f32(p.i_c0) * raw / raw300).astype(f32)


def delta_of_t(p: MTJParams, t) -> np.ndarray:
    """Thermal stability factor Delta(T) = E/(kB T), float32 like the
    reference: the barrier falls mildly with T, the 1/T term dominates."""
    t = np.asarray(t, np.float32)
    e0 = np.float32(p.delta0 * KB * 300.0)
    barrier = e0 * np.maximum(np.float32(1.0) - np.float32(1.0e-3)
                              * (t - np.float32(300.0)), np.float32(0.05))
    return (barrier / (np.float32(KB) * t)).astype(np.float32)


def resistances(p: MTJParams, t=300.0, v_bias=0.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(R_P, R_AP) at temperature t: R_P is T-independent; R_AP tracks
    TMR."""
    r_p = np.asarray(p.r_p, f32)
    return r_p, (r_p * (f32(1.0) + tmr_of_t(p, t, v_bias))).astype(f32)


_LAMBDA = 0.2333


def _log_pi_over_2theta0(delta) -> np.ndarray:
    """ln(pi / (2 theta0)) at the thermal initial angle
    theta0 = sqrt(1 / (2 Delta)), with XLA's float32 log."""
    theta0 = np.sqrt(f32(1.0) / (f32(2.0) * delta))
    return rng.xla_log(f32(math.pi) / (f32(2.0) * theta0))


def switching_time(p: MTJParams, i_write, t=300.0, theta0=None
                   ) -> np.ndarray:
    """Eq. 5: 1/t_sw = (I/(lambda Ic) - 1) / (tau0 ln(pi / (2 theta0))),
    lambda = 0.2333; theta0 defaults to sqrt(1 / (2 Delta))."""
    delta = delta_of_t(p, t)
    if theta0 is None:
        log_term = _log_pi_over_2theta0(delta)
    else:
        log_term = rng.xla_log(
            f32(math.pi) / (f32(2.0) * np.asarray(theta0, f32)))
    ic = critical_current(p, t)
    over = np.maximum(np.asarray(i_write, f32) / (f32(_LAMBDA) * ic)
                      - f32(1.0), f32(1e-6))
    rate = over / (f32(p.tau0) * log_term)
    return (f32(1.0) / rate).astype(f32)


def switching_voltage(p: MTJParams, t_sw, t=300.0, to_ap: bool = True
                      ) -> np.ndarray:
    """Fig. 7: the voltage that switches the cell within t_sw at T, the
    inverted Eq. 5 current times the starting state's resistance."""
    delta = delta_of_t(p, t)
    ic = critical_current(p, t)
    i_need = (f32(_LAMBDA) * ic) * (
        f32(1.0) + f32(p.tau0) * _log_pi_over_2theta0(delta)
        / np.asarray(t_sw, f32))
    r_p, r_ap = resistances(p, t)
    return (i_need * (r_p if to_ap else r_ap)).astype(f32)


# ---------------------------------------------------------------------------
# stochastic macrospin (s-LLGS) integrator: Fig. 2/3/5 transients
# ---------------------------------------------------------------------------

def llgs_noise(keys: np.ndarray, n_steps: int) -> np.ndarray:
    """The thermal noise of one trajectory per key of the ``(n, 2)``
    stack: ``(n, n_steps)`` float32, ``normal(k, (n_steps,))`` of each
    key (host draws, bit-exact with the reference's)."""
    return rng.normal_keys(keys, (n_steps,))


def integrate_llgs(noise: torch.Tensor, p: MTJParams, i_write,
                   dt: float = 5e-12, t: float = 300.0,
                   to_ap: bool = True, trajectory: bool = True
                   ) -> torch.Tensor:
    """Integrate the macrospin polar angle of ``n`` trajectories together
    under spin torque + thermal field:

      theta <- clip(theta + rate (I/Ic - cos th) sin th dt + sigma eps,
                    1e-4, pi - 1e-4),

    absorbing once past pi/2 (the free layer settles). ``noise`` is the
    ``(n, n_steps)`` float32 draws on the device the integration runs
    on. Returns the ``(n, n_steps)`` trajectories, or with
    ``trajectory=False`` only the ``(n,)`` final angles. Every constant
    is a float32 tensor on that device, so nothing promotes the state and
    the loop never reads the device back."""
    dev = noise.device
    delta = delta_of_t(p, t)
    over = f32(i_write) / critical_current(p, t)
    if not to_ap:
        # AP->P transitions see the full spin torque (electrons flow
        # pinned -> free): ~1.3x effective overdrive vs the weak P->AP
        # direction
        over = over * f32(AP_TO_P_OVERDRIVE)
    rate = p.alpha * GAMMA * MU_0 * p.h_k
    sigma_th = np.sqrt(f32(rate * dt) / delta)
    theta_init = np.sqrt(f32(1.0) / (f32(2.0) * delta))

    def c(v) -> torch.Tensor:
        return torch.tensor(float(f32(v)), dtype=torch.float32, device=dev)

    over_t, rate_t, dt_t, sig_t = c(over), c(rate), c(dt), c(sigma_th)
    lo, hi, half_pi = c(1e-4), c(math.pi - 1e-4), c(0.5 * math.pi)
    n, n_steps = noise.shape
    eps = noise.t().contiguous()  # (n_steps, n): one contiguous row a step
    out = torch.empty((n_steps if trajectory else 1, n),
                      dtype=torch.float32, device=dev)
    theta = torch.full((n,), float(theta_init), dtype=torch.float32,
                       device=dev)
    for i in range(n_steps):
        torque = rate_t * (over_t - torch.cos(theta)) * torch.sin(
            theta) * dt_t
        theta2 = torch.clamp(theta + torque + sig_t * eps[i], lo, hi)
        theta = torch.where(theta > half_pi,
                            torch.maximum(theta2, half_pi), theta2,
                            out=out[i if trajectory else 0])
    return out.t() if trajectory else out[0]


def llgs_switch(key: np.ndarray, p: MTJParams, i_write,
                t_pulse: float = 10e-9, dt: float = 5e-12,
                t: float = 300.0, to_ap: bool = True, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One s-LLGS transient from ``key``: ``(theta trajectory (n_steps,),
    switched)``, switched when the last angle is past pi/2."""
    dev = resolve_device(device)
    n_steps = int(t_pulse / dt)
    noise = torch.from_numpy(llgs_noise(np.asarray(key)[None], n_steps))
    traj = integrate_llgs(noise.to(dev), p, i_write, dt, t, to_ap)[0]
    return traj, traj[-1] > float(f32(0.5 * math.pi))


def monte_carlo_wer(key: np.ndarray, p: MTJParams, i_write,
                    t_pulse: float = 10e-9, n: int = 256, t: float = 300.0,
                    to_ap: bool = True, device=None,
                    noise: Optional[np.ndarray] = None) -> torch.Tensor:
    """Empirical WER over n independent s-LLGS runs (the paper uses 64 and
    1e3), one per key of ``split(key, n)``: a float32 0-d tensor on the
    device. ``to_ap`` selects P->AP (True, the weak-torque direction) or
    AP->P (~1.3x effective overdrive, lower WER). ``noise`` takes draws
    already made by ``llgs_noise(split(key, n), n_steps)``."""
    dev = resolve_device(device)
    dt = 5e-12
    if noise is None:
        noise = llgs_noise(rng.split(key, n), int(t_pulse / dt))
    theta = integrate_llgs(torch.from_numpy(noise).to(dev), p, i_write, dt,
                           t, to_ap, trajectory=False)
    switched = (theta > float(f32(0.5 * math.pi))).to(torch.float32)
    # the reference's float32 mean: the sum times f32(1/n), as XLA
    # computes ``jnp.mean``
    return 1.0 - switched.sum() * float(f32(1.0 / switched.numel()))
