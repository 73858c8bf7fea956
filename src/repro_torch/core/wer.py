"""Write-error-rate model: the paper's Eq. 1-3 and Eq. 14-15, the CMP
pulse-occupancy factor, and their torch forms for the Monte-Carlo study.

The host forms are float32 numpy: they calibrate the driver's level
table (twenty constants) once per process and reproduce the reference's
float32 calibration bit for bit, which keeps every threshold and energy
of the write path identical to the JAX package's:

  * the same float32 operations in the same order;
  * ``_exp_f32`` evaluates the Cephes polynomial that XLA's CPU backend
    uses for float32 ``exp`` (with fused multiply-adds), because the
    reference evaluates its calibration through XLA and a correctly
    rounded ``exp`` differs from it in the last bit for about one input
    in ten;
  * the trapezoid sum adds its 63 terms in XLA's CPU row-reduction order
    (a 32-wide vector accumulator, then the scalar tail);
  * the retention rates (``switching_probability``) keep the reference's
    ``clip(d (1 - v), -60, 60)`` and its float32 ``1 - exp(-t/tau)``;
  * the grid of pulse fractions is ``i / 63`` by true division — the
    reference's serving path calibrates under
    ``jax.ensure_compile_time_eval`` (``leaf_vectors``), where
    ``jnp.linspace`` divides rather than multiplying by ``1/63``.

The ``_t`` forms (``wer_bit_t``, ``expected_pulse_fraction_t``) take
float32 tensors of process corners on any device and compute the same
float32 operations one torch op at a time, ``exp`` by the same Cephes
polynomial (each fused multiply-add as one float64 multiply-add rounded
once, which is exact), and the trapezoid terms summed in the same
row-reduction order, one vector add at a time. Every op is an IEEE
float32 or float64 operation, so the card and the CPU give the same bits.
Their grid is ``i * f32(1/63)``: the reference's Monte-Carlo study
(``energy_model._one_sample``) evaluates ``jnp.linspace`` eagerly, where
XLA multiplies by the reciprocal.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import mtj as _mtj

f32 = np.float32

# paper section II.A constants, from the device layer's single copy
ALPHA_DAMPING = _mtj.DEFAULT_MTJ.alpha       # Landau-Lifshitz-Gilbert damping
GAMMA_GYRO = _mtj.GAMMA                      # gyromagnetic ratio, rad/(s.T)
MU_0 = _mtj.MU_0
H_K_EFF = _mtj.DEFAULT_MTJ.h_k * MU_0        # anisotropy field in Tesla

# Eq. 1 rate constant, calibrated so the exact level (I/Ic=1.8, 10 ns)
# gives a product-grade WER ~1e-10 (see repro.core.wer).
C_TECH = 3.5e9

_EPS = 1e-30
_F32_TINY = float(np.finfo(np.float32).tiny)

_CEPHES_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: the float64 product of two float32
    values is exact, so one rounding of the float64 sum to float32
    gives the fused result."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def _exp_f32(x) -> np.ndarray:
    """float32 exp as XLA's CPU backend computes it: n = floor(x log2 e +
    1/2), a two-constant Cody-Waite reduction, a degree-5 Cephes
    polynomial in Horner form, then scaling by 2^n."""
    x = np.clip(np.asarray(x, f32), f32(-87.8), f32(88.8))
    n = np.clip(np.floor(_fma(x, f32(1.44269504088896341), f32(0.5))),
                f32(-127), f32(127)).astype(f32)
    r = _fma(n, -f32(0.693359375), x)
    r = _fma(n, -f32(-2.12194440e-4), r)
    z = _fma(r, f32(_CEPHES_P[0]), f32(_CEPHES_P[1]))
    for c in _CEPHES_P[2:]:
        z = _fma(z, r, f32(c))
    z = _fma(z, (r * r).astype(f32), r)
    z = (f32(1.0) + z).astype(f32)
    with np.errstate(over="ignore"):
        out = (z * np.ldexp(f32(1.0), n.astype(np.int32)).astype(f32)
               ).astype(f32)
    # XLA's CPU code flushes subnormal results to zero (below
    # exp(-87.34))
    return np.where(out < _F32_TINY, f32(0.0), out).astype(f32)


def wer_bit(t_w, i_rel, delta) -> np.ndarray:
    """Paper Eq. 1: WER = 1 - exp(-pi^2 (I-1) Delta / (4 (I e^{C(I-1)t} - 1))),
    WER = 1 at or below the critical current."""
    t_w = np.asarray(t_w, f32)
    i = np.asarray(i_rel, f32)
    d = np.asarray(delta, f32)
    over = (i - f32(1.0)).astype(f32)
    growth = _exp_f32(np.clip((f32(C_TECH) * over).astype(f32) * t_w,
                              f32(0.0), f32(60.0)))
    denom = np.maximum((i * growth).astype(f32) - f32(1.0), f32(_EPS))
    arg = ((f32(-(math.pi ** 2)) * over).astype(f32) * d).astype(f32) / (
        f32(4.0) * denom).astype(f32)
    wer = (f32(1.0) - _exp_f32(arg.astype(f32))).astype(f32)
    return np.where(i <= f32(1.0) + f32(1e-6), f32(1.0),
                    np.clip(wer, f32(0.0), f32(1.0))).astype(f32)


def delta_of_t(t, p: "_mtj.MTJParams" = _mtj.DEFAULT_MTJ) -> np.ndarray:
    """Thermal stability factor Delta(T): the one Delta(T) source of the
    stack, ``mtj.delta_of_t`` (note the argument order)."""
    return _mtj.delta_of_t(p, t)


def wer_thermal_at(t_w, i_rel, t_k, p: "_mtj.MTJParams" = _mtj.DEFAULT_MTJ
                   ) -> np.ndarray:
    """Eq. 2 at die temperature ``t_k``: Delta and the LLG constants from
    one ``MTJParams``."""
    return wer_thermal(t_w, i_rel, delta_of_t(t_k, p),
                       h_k=p.h_k * MU_0, alpha=p.alpha)


def wer_thermal(t_w, i_rel, delta, h_k: float = H_K_EFF,
                alpha: float = ALPHA_DAMPING) -> np.ndarray:
    """Paper Eq. 2 (micromagnetic form): Eq. 1 with the rate constant
    2 a g Hk / (1 + a^2) written out in the LLG parameters."""
    t_w = np.asarray(t_w, f32)
    i = np.asarray(i_rel, f32)
    over = (i - f32(1.0)).astype(f32)
    rate = 2.0 * alpha * GAMMA_GYRO * h_k / (1.0 + alpha ** 2)
    growth = _exp_f32(np.clip((f32(rate) * t_w).astype(f32) * over,
                              f32(0.0), f32(60.0)))
    denom = np.maximum((i * growth).astype(f32) - f32(1.0), f32(_EPS))
    arg = ((f32(-(math.pi ** 2)) * over).astype(f32)
           * np.asarray(delta, f32)).astype(f32) / (f32(4.0) * denom)
    p = (f32(1.0) - _exp_f32(arg.astype(f32))).astype(f32)
    return np.where(i <= f32(1.0 + 1e-6), f32(1.0),
                    np.clip(p, f32(0.0), f32(1.0))).astype(f32)


def wer_exponential(t_wr, t_sw) -> np.ndarray:
    """Paper Eq. 3: P_WER = exp(-t_wr / t_sw), the incomplete-write
    probability given the cell's mean switching delay t_sw."""
    return _exp_f32(-np.asarray(t_wr, f32)
                    / np.maximum(np.asarray(t_sw, f32), f32(_EPS)))


def wer_from_level(t_w, i_rel, delta, to_ap: bool) -> np.ndarray:
    """Direction-aware WER: P->AP ("write 1") is derated to 0.75 of the
    overdrive (the weak-torque direction)."""
    derate = f32(0.75) if to_ap else f32(1.0)
    i_eff = (f32(1.0) + (np.asarray(i_rel, f32) - f32(1.0)) * derate
             ).astype(f32)
    return wer_bit(t_w, i_eff, delta)


def _row_sum_f32(v: np.ndarray) -> np.float32:
    """Sum a short float32 row in XLA's CPU reduction order: 32-wide
    vector partials over the full chunks, reduced left to right, plus the
    remaining elements added one by one into a separate scalar."""
    n = len(v) // 32 * 32
    acc = np.zeros(32, f32)
    for j in range(0, n, 32):
        acc = (acc + v[j:j + 32]).astype(f32)
    head = f32(0.0)
    for a in acc:
        head = f32(head + a)
    tail = f32(0.0)
    for a in v[n:]:
        tail = f32(tail + a)
    return f32(head + tail)


def expected_pulse_fraction(t_w, i_rel, delta, n_grid: int = 64
                            ) -> np.float32:
    """E[min(T_sw, t_w)]/t_w under the Eq. 1 switching CDF: the CMP
    self-termination energy factor, by the trapezoid rule on a fixed
    grid of pulse fractions."""
    div = n_grid - 1
    ts = np.concatenate([(np.arange(div, dtype=f32) / f32(div)
                          ).astype(f32), np.ones(1, f32)])
    vals = wer_bit((f32(t_w) * ts).astype(f32), i_rel, delta)
    dx = (ts[1:] - ts[:-1]).astype(f32)
    terms = (dx * (vals[1:] + vals[:-1]).astype(f32)).astype(f32)
    integral = f32(f32(0.5) * _row_sum_f32(terms))
    return f32(np.clip(integral, f32(0.0), f32(1.0)))


def switching_time(delta, v_rel, tau0: float = 1.0e-9) -> np.ndarray:
    """Paper Eq. 15: tau = tau0 exp(Delta (1 - V/Vc0)), the mean thermal
    switching time under a sub-critical voltage V."""
    d = np.asarray(delta, f32)
    v = np.asarray(v_rel, f32)
    arg = np.clip((d * (f32(1.0) - v).astype(f32)).astype(f32),
                  f32(-60.0), f32(60.0))
    return (f32(tau0) * _exp_f32(arg)).astype(f32)


def switching_probability(t_p, delta, v_rel, tau0: float = 1.0e-9
                          ) -> np.ndarray:
    """Paper Eq. 14: P_sw = 1 - exp(-t_p / tau(Delta, V)) — the retention
    decay probability of one stored bit over a dwell ``t_p`` at V = 0."""
    tau = switching_time(delta, v_rel, tau0)
    x = (-np.asarray(t_p, f32) / tau).astype(f32)
    return (f32(1.0) - _exp_f32(x)).astype(f32)


# ---------------------------------------------------------------------------
# torch forms over vectors of process corners (the Monte-Carlo study)
# ---------------------------------------------------------------------------

def _fma_t(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the float64 product of two float32
    values is exact, so one rounding of the float64 sum gives it."""
    return (a.double() * b + c).float()


def _exp_f32_t(x: torch.Tensor) -> torch.Tensor:
    """``_exp_f32`` in torch ops on ``x``'s device, bit for bit."""
    x = torch.clamp(x, float(f32(-87.8)), float(f32(88.8)))
    n = torch.clamp(torch.floor(_fma_t(x, float(f32(1.44269504088896341)),
                                       0.5)), -127.0, 127.0)
    r = _fma_t(n, -float(f32(0.693359375)), x.double())
    r = _fma_t(n, -float(f32(-2.12194440e-4)), r.double())
    z = _fma_t(r, float(f32(_CEPHES_P[0])), float(f32(_CEPHES_P[1])))
    for c in _CEPHES_P[2:]:
        z = _fma_t(z, r.double(), float(f32(c)))
    z = _fma_t(z, (r * r).double(), r.double())
    z = 1.0 + z
    # 2^n as the float64 whose exponent field is n + 1023 (|n| <= 127)
    scale = ((n.to(torch.int64) + 1023) << 52).view(torch.float64)
    out = (z.double() * scale).float()
    return torch.where(out < _F32_TINY, torch.zeros_like(out), out)


def wer_bit_t(t_w, i_rel: torch.Tensor, delta: torch.Tensor
              ) -> torch.Tensor:
    """``wer_bit`` over float32 tensors (``t_w`` a host scalar or a
    tensor broadcasting against them), the same operations in order."""
    i, d = i_rel, delta
    over = i - 1.0
    growth = _exp_f32_t(torch.clamp(
        float(f32(C_TECH)) * over * (t_w if torch.is_tensor(t_w)
                                     else float(f32(t_w))), 0.0, 60.0))
    denom = torch.clamp_min(i * growth - 1.0, float(f32(_EPS)))
    arg = float(f32(-(math.pi ** 2))) * over * d / (4.0 * denom)
    wer = 1.0 - _exp_f32_t(arg)
    return torch.where(i <= float(f32(1.0 + 1e-6)), torch.ones_like(wer),
                       torch.clamp(wer, 0.0, 1.0))


def _row_sum_t(rows: torch.Tensor) -> torch.Tensor:
    """``_row_sum_f32`` down axis 0 of a ``(m, n)`` float32 tensor: the
    same adds, each one an ``(n,)`` vector op."""
    m = rows.shape[0]
    full = m // 32 * 32
    head = torch.zeros_like(rows[0])
    if full:
        acc = rows[:32]
        for j in range(32, full, 32):
            acc = acc + rows[j:j + 32]
        for a in acc:
            head = head + a
    tail = torch.zeros_like(rows[0])
    for j in range(full, m):
        tail = tail + rows[j]
    return head + tail


def expected_pulse_fraction_t(t_w, i_rel: torch.Tensor, delta: torch.Tensor,
                              n_grid: int = 64) -> torch.Tensor:
    """``expected_pulse_fraction`` over float32 tensors of corners, on
    their device, as the reference evaluates it inside its ``vmap``-ed
    Monte Carlo: the grid ``i * f32(1/(n_grid-1))`` and the trapezoid's
    terms in the row-reduction order. Bit-exact with it on the CPU and on
    the card."""
    div = n_grid - 1
    ts = np.concatenate([(np.arange(div, dtype=f32) * f32(1.0 / div)
                          ).astype(f32), np.ones(1, f32)])
    tw = f32(t_w)
    grid = torch.from_numpy((tw * ts).astype(f32)).to(i_rel.device)
    vals = wer_bit_t(grid.view((n_grid,) + (1,) * i_rel.dim()),
                     i_rel, delta)
    dx = torch.from_numpy((ts[1:] - ts[:-1]).astype(f32)).to(i_rel.device)
    terms = dx.view((div,) + (1,) * i_rel.dim()) * (vals[1:] + vals[:-1])
    return torch.clamp(0.5 * _row_sum_t(terms), 0.0, 1.0)
