"""Write-error-rate model (paper Eq. 1), the CMP pulse-occupancy factor and
the thermal switching probability of a stored bit (Eq. 14-15).

Host-side float32 numpy: these functions only calibrate the driver's
level table (twenty constants), so they run once per process, never on
the device. They reproduce the reference's float32 calibration bit for
bit, which keeps every threshold and energy of the write path identical
to the JAX package's:

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
"""
from __future__ import annotations

import math

import numpy as np

f32 = np.float32

# Eq. 1 rate constant, calibrated so the exact level (I/Ic=1.8, 10 ns)
# gives a product-grade WER ~1e-10 (see repro.core.wer).
C_TECH = 3.5e9

_EPS = 1e-30

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
    return (z * np.ldexp(f32(1.0), n.astype(np.int32)).astype(f32)
            ).astype(f32)


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
