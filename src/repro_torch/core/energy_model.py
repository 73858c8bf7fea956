"""Per-step energy accounting + Monte-Carlo process-variation analysis.

  1. The serving ledger: the per-slot attribution accumulators that ride
     on the device between scheduler events, and the host-side
     ``StepEnergyMeter`` that folds synced ``WriteStats`` into the
     report's per-stream ledger.

  2. ``monte_carlo_variation`` — paper §IV.D: a Monte Carlo over CMOS
     (3-sigma on W/L/Vth ~ +-10% on drive current) and MTJ (oxide 10%,
     free-layer thickness 10%, resistance 5%) parameters, with the
     write-energy spread with and without approximation (Fig. 15) and its
     sensitivity to supply-voltage variation (``voltage_sweep``, Fig. 16).
     The n corners' five normal draws are the reference's (host draws off
     ``split(key, n)``); the corners are evaluated together as ``(n,)``
     float32 tensors on the device, bit-exact with the reference's
     ``vmap``-ed samples (``wer.wer_bit_t``,
     ``wer.expected_pulse_fraction_t``), and the summaries are computed on
     the host from the samples.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import wer as wer_mod
from repro_torch.core import write_driver
from repro_torch.device import resolve_device

#: per-slot attribution layout: one float32 accumulator row per cache slot.
SLOT_STAT_KEYS = ("energy_pj", "flips", "errors")


def zero_slot_stats(n_slots: int, device) -> Dict[str, torch.Tensor]:
    """Fresh all-zero per-slot attribution accumulator ((n_slots,) f32)."""
    return {k: torch.zeros((n_slots,), dtype=torch.float32, device=device)
            for k in SLOT_STAT_KEYS}


def add_slot_stats(slot_acc: Dict[str, torch.Tensor], stats: Any,
                   active: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Attribute one write's device stats evenly across the active slots
    (the lane-packed write reduces per leaf, not per batch row)."""
    act = active.to(torch.float32)
    share = act / torch.clamp(act.sum(), min=1.0)
    flips = (stats.flips01 + stats.flips10).to(torch.float32)
    return {
        "energy_pj": slot_acc["energy_pj"] + share * stats.energy_pj,
        "flips": slot_acc["flips"] + share * flips,
        "errors": slot_acc["errors"] + share * stats.errors.to(
            torch.float32),
    }


@dataclasses.dataclass
class StepEnergyMeter:
    """Accumulates write energy per named stream (host side)."""
    streams: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def _stream(self, stream: str) -> Dict[str, float]:
        return self.streams.setdefault(stream, {
            "energy_pj": 0.0, "bits_written": 0, "bits_total": 0,
            "bit_errors": 0, "soft_strikes": 0, "latency_ns": 0.0})

    def add(self, stream: str, stats: Any) -> None:
        """Fold one legacy ``approx_store.WriteStats`` into a stream (one
        host read of its five fields)."""
        s = self._stream(stream)
        e, lat, written, total, errors = torch.stack([
            torch.as_tensor(v, dtype=torch.float64) for v in (
                stats.energy_pj, stats.latency_ns, stats.bits_written,
                stats.bits_total, stats.bit_errors)]).tolist()
        s["energy_pj"] += e
        s["bits_written"] += int(written)
        s["bits_total"] += int(total)
        s["bit_errors"] += int(errors)
        s["latency_ns"] = max(s["latency_ns"], lat)

    def add_stream(self, stream: str, host_stats: Dict[str, Any]) -> None:
        """Fold one synced ``WriteStats.host_dict()`` into a stream."""
        s = self._stream(stream)
        s["energy_pj"] += float(host_stats["energy_pj"])
        s["bits_written"] += int(host_stats["bits_written"])
        s["bit_errors"] += int(host_stats["bit_errors"])
        s["soft_strikes"] += int(host_stats["soft_strikes"])
        s["bits_total"] += int(host_stats["bits_total"])
        s["latency_ns"] = max(s["latency_ns"],
                              float(host_stats["latency_ns"]))

    def summary(self) -> Dict[str, Any]:
        tot = {k: sum(s.get(k, 0) for s in self.streams.values())
               for k in ("energy_pj", "bits_written", "bits_total",
                         "bit_errors", "soft_strikes")}
        tot["write_skip_rate"] = (
            1.0 - tot["bits_written"] / tot["bits_total"]
            if tot["bits_total"] else 0.0)
        tot["ber_realized"] = (
            tot["bit_errors"] / max(1, tot["bits_written"]))
        return {"streams": self.streams, "total": tot}


def exact_baseline_energy_pj(bits_total: int,
                             cfg: write_driver.DriverConfig = None) -> float:
    """Energy the same traffic would cost on the non-approximate basic cell
    (full pulse, every bit): the denominator for Fig. 14-style savings."""
    e_word = write_driver.TABLE1["basic"]["energy_pj"]
    return bits_total / write_driver.WORD_BITS * e_word


# ---------------------------------------------------------------------------
# Monte-Carlo process variation (paper §IV.D, Fig. 15/16)
# ---------------------------------------------------------------------------

class VariationSample(NamedTuple):
    energy_full_pj: torch.Tensor     # per-word energy, uniform exact write
    energy_approx_pj: torch.Tensor   # per-word energy, EXTENT level mix
    wer_exact: torch.Tensor
    wer_low: torch.Tensor
    i_rel_eff: torch.Tensor


#: the five gaussians of a corner, in draw order: oxide, free layer,
#: resistance (3-sigma bounds 10%, 10%, 5%), CMOS drive (10%), supply
_SIGMAS = (0.10 / 3, 0.10 / 3, 0.05 / 3, 0.10 / 3)


def variation_draws(key: np.ndarray, n: int) -> np.ndarray:
    """The ``(n, 5)`` float32 standard normals of n corners: corner ``j``
    splits ``split(key, n)[j]`` five ways and draws one scalar from each,
    as the reference's ``_one_sample`` does under ``vmap``."""
    sub = rng.split_keys(rng.split(key, n), 5)
    return rng.normal_keys(sub.reshape(-1, 2), ()).reshape(n, 5)


def variation_samples(z: torch.Tensor, v_supply_sigma: float = 0.03,
                      delta0: float = 60.0) -> VariationSample:
    """Evaluate the driver at the ``(n, 5)`` corners ``z`` on their device.

    Variation model (paper §IV.D): MTJ oxide and free-layer thickness and
    resistance fold into Ic and Delta (Ic ~ thickness x area, Delta ~
    barrier volume); CMOS W/L/Vth into a lumped drive scaling; the supply
    is a gaussian of ``v_supply_sigma``. The reference's float32
    operations, in its order."""
    f32 = np.float32
    g = [1.0 + float(f32(s)) * z[:, j] for j, s in
         enumerate(_SIGMAS + (v_supply_sigma,))]
    ox, tfl, res, drive, vdd = g
    # effective overdrive: I ~ drive * vdd / (R * ox); Ic ~ tfl (volume)
    i_scale = drive * vdd / (res * ox)
    delta = float(f32(delta0)) * tfl * ox
    e_bit = write_driver.DriverConfig().e_bit_full_pj

    def level(i: int):
        _, _, _, i_rel, pulse_ns, e_rel = write_driver._LEVEL_PARAMS[i]
        i_eff = float(f32(i_rel)) * i_scale
        t_w = pulse_ns * 1e-9
        frac = wer_mod.expected_pulse_fraction_t(
            t_w, torch.clamp_min(i_eff, float(f32(1.001))), delta)
        # drive power varies quadratically with the perturbed rail
        e_full = float(f32(e_bit * e_rel)) * (vdd * vdd)
        return e_full * frac, wer_mod.wer_bit_t(
            t_w, torch.clamp_min(i_eff, float(f32(1.0 + 1e-6))), delta)

    (e_low, wer_low), (e_mid, _), (e_high, _), (e_exact, wer_exact) = (
        level(i) for i in range(4))
    w = float(write_driver.WORD_BITS * 0.5)  # nominal transition fraction
    # EXTENT mix (cache_sim's default)
    mix = 0.35 * e_exact + 0.15 * e_high + 0.20 * e_mid + 0.30 * e_low
    return VariationSample(w * e_exact, w * mix, wer_exact, wer_low,
                           i_scale)


def percentile_f32(x, q: float) -> float:
    """``jnp.percentile(x, q)`` of a float32 sample (linear
    interpolation) in its float32 arithmetic: position ``f32(q/100) *
    (n-1)``, weights ``pos - floor(pos)`` and ``1 - that``, and the
    neighbours' weighted sum with the upper term fused."""
    f32 = np.float32
    xs = np.sort(np.asarray(x, f32))
    pos = f32(f32(q) / f32(100.0)) * f32(len(xs) - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = f32(pos - f32(lo))
    w_lo = f32(f32(1.0) - w_hi)
    low_term = np.float64(f32(xs[lo] * w_lo))
    return float(f32(np.float64(xs[hi]) * np.float64(w_hi) + low_term))


def describe(x) -> Dict[str, float]:
    """mean, population std (``ddof=0``), min, max and the 5th/95th
    percentiles of a float32 sample, on the host. The mean and std are
    float64 sums (the reference sums in float32 in XLA's order, so they
    may differ in the last float32 bits); the percentiles are
    ``percentile_f32``."""
    x = np.asarray(x, np.float32)
    x64 = x.astype(np.float64)
    return {"mean": float(x64.mean()), "std": float(x64.std()),
            "min": float(x.min()), "max": float(x.max()),
            "p05": percentile_f32(x, 5), "p95": percentile_f32(x, 95)}


def monte_carlo_variation(key: np.ndarray, n: int = 1000,
                          v_supply_sigma: float = 0.03, delta0: float = 60.0,
                          device=None) -> Dict[str, Any]:
    """Paper's 1000-run Monte Carlo; returns distribution summaries. The
    corners run on ``device`` (the card unless the CPU is asked for)."""
    dev = resolve_device(device)
    z = torch.from_numpy(variation_draws(key, n)).to(dev)
    samples = variation_samples(z, v_supply_sigma, delta0)
    host = {k: v.cpu().numpy() for k, v in samples._asdict().items()}
    return {**{k: describe(v) for k, v in host.items()},
            "n": n, "v_supply_sigma": v_supply_sigma}


def voltage_sweep(key: np.ndarray, sigmas=(0.0, 0.01, 0.03, 0.05, 0.10),
                  n: int = 500, device=None) -> Dict[float, Dict[str, Any]]:
    """Fig. 16: write energy sensitivity vs. supply-voltage variation."""
    return {float(s): monte_carlo_variation(key, n=n, v_supply_sigma=float(s),
                                            device=device)
            for s in sigmas}
