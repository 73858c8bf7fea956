"""Trace-driven LLC write-transition simulator: paper Fig. 13 / Fig. 14.

The paper profiles MiBench workloads in GEM5 and shows (Fig. 13) that ~80%
of L2 write traffic is in the expensive 0->1 direction, then evaluates
(Fig. 14) the normalized write energy of EXTENT vs. state-of-the-art on
those transition mixes. The analysis pipeline of ``repro.core.cache_sim``:
the paper's published per-benchmark transition mixes, the measured mix of
a real tensor write (bit planes counted on the tensor's device), and the
energy per access from the calibrated driver table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.core import write_driver
from repro_torch.core.priority import Priority, bits_of, int_type

# Fig. 13 digitized access-pattern mixes per MiBench workload:
# fractions of L2 write-bit traffic {0->1, 1->0, 0->0, 1->1}.
FIG13_WORKLOADS: Dict[str, Dict[str, float]] = {
    "qsort":      {"t01": 0.46, "t10": 0.11, "t00": 0.33, "t11": 0.10},
    "susan":      {"t01": 0.42, "t10": 0.10, "t00": 0.38, "t11": 0.10},
    "jpeg":       {"t01": 0.44, "t10": 0.12, "t00": 0.33, "t11": 0.11},
    "lame":       {"t01": 0.40, "t10": 0.13, "t00": 0.35, "t11": 0.12},
    "dijkstra":   {"t01": 0.43, "t10": 0.11, "t00": 0.36, "t11": 0.10},
    "patricia":   {"t01": 0.41, "t10": 0.12, "t00": 0.36, "t11": 0.11},
    "stringsearch": {"t01": 0.45, "t10": 0.10, "t00": 0.35, "t11": 0.10},
    "sha":        {"t01": 0.48, "t10": 0.14, "t00": 0.27, "t11": 0.11},
}

#: the paper's evaluation level mix: multimedia payload LOW/MID, control
#: EXACT
DEFAULT_LEVEL_MIX = {int(Priority.EXACT): 0.35, int(Priority.HIGH): 0.15,
                     int(Priority.MID): 0.20, int(Priority.LOW): 0.30}


@dataclasses.dataclass(frozen=True)
class TransitionMix:
    t01: float  # 0->1 (P->AP, expensive direction)
    t10: float  # 1->0
    t00: float  # redundant zero
    t11: float  # redundant one

    @property
    def flip_fraction(self) -> float:
        return self.t01 + self.t10

    @property
    def expensive_share(self) -> float:
        """Share of *flipping* traffic in the 0->1 direction (Fig. 13's
        headline: ~80% of energy-relevant accesses)."""
        f = self.flip_fraction
        return self.t01 / f if f else 0.0


def mix_from_fig13(name: str) -> TransitionMix:
    return TransitionMix(**FIG13_WORKLOADS[name])


def trace_transition_mix(old: torch.Tensor, new: torch.Tensor
                         ) -> TransitionMix:
    """Measure the actual bit-transition mix of one tensor write. The bit
    planes are counted on the tensors' device through the signed integer
    view of their width (an arithmetic shift then ``& 1`` reads each
    plane, the sign plane included)."""
    it = int_type(old.dtype)
    nbits = bits_of(old.dtype)
    shift = torch.arange(nbits, dtype=it, device=old.device)
    bo = (old.contiguous().view(it)[..., None] >> shift) & 1
    bn = (new.contiguous().view(it)[..., None] >> shift) & 1
    total = bo.numel()
    counts = torch.stack([((bo == 0) & (bn == 1)).sum(),
                          ((bo == 1) & (bn == 0)).sum(),
                          ((bo == 1) & (bn == 1)).sum()]).tolist()
    t01, t10, t11 = (c / total for c in counts)
    return TransitionMix(t01=t01, t10=t10, t00=1.0 - t01 - t10 - t11, t11=t11)


# ---------------------------------------------------------------------------
# energy evaluation (Fig. 14)
# ---------------------------------------------------------------------------

def _intensity(m: TransitionMix) -> float:
    """Direction-weighted flip intensity of a workload (2.5:1)."""
    return 2.5 * m.t01 + m.t10


def energy_per_word(
    mix: TransitionMix,
    scheme: str = "extent",
    level_mix: Optional[Dict[int, float]] = None,
    cfg: write_driver.DriverConfig = write_driver.DriverConfig(),
) -> float:
    """Expected energy (pJ) of one 64-bit word write under a scheme.

    Schemes:
      basic  — full static pulse on every bit (no CMP, no skip),
      quark  — Table-1 [21] scaling: tuned Delta, no self-termination,
      cast   — [40]: self-termination, single exact level,
      extent — self-termination + redundant-skip + the level mix
               (default: the paper's high/low priority split).
    """
    # average Fig. 13 intensity: the operating point at which each
    # scheme's published Table-1 word energy was measured
    avg = TransitionMix(
        t01=float(np.mean([v["t01"] for v in FIG13_WORKLOADS.values()])),
        t10=float(np.mean([v["t10"] for v in FIG13_WORKLOADS.values()])),
        t00=0.0, t11=0.0)
    if scheme == "basic":
        return write_driver.TABLE1["basic"]["energy_pj"]
    if scheme == "quark":
        return (write_driver.TABLE1["quark_islped17"]["energy_pj"]
                * _intensity(mix) / _intensity(avg))
    if scheme == "cast":
        return (write_driver.TABLE1["cast_tcad20"]["energy_pj"]
                * _intensity(mix) / _intensity(avg))
    if scheme != "extent":
        raise ValueError(f"unknown scheme {scheme!r}")
    levels = write_driver.default_driver(cfg)
    e = 0.0
    if level_mix is None:
        level_mix = DEFAULT_LEVEL_MIX
    for code, frac in level_mix.items():
        lvl = next(l for l in levels if l.code == code)
        e += frac * write_driver.WORD_BITS * (
            mix.t01 * lvl.e_0to1_pj + mix.t10 * lvl.e_1to0_pj)
    return e


def fig14_normalized_energy(
    workloads: Iterable[str] = tuple(FIG13_WORKLOADS),
) -> Dict[str, Dict[str, float]]:
    """Normalized (to basic-cell) energy per workload per scheme — the
    Fig. 14 reproduction."""
    out = {}
    for w in workloads:
        mix = mix_from_fig13(w)
        basic = energy_per_word(mix, "basic")
        out[w] = {scheme: energy_per_word(mix, scheme) / basic
                  for scheme in ("basic", "quark", "cast", "extent")}
    return out


def wer_for_mix(mix: TransitionMix,
                level_mix: Optional[Dict[int, float]] = None,
                cfg: write_driver.DriverConfig = write_driver.DriverConfig(),
                ) -> float:
    """Expected per-bit write error rate for a transition/level mix — the
    system-level accuracy proxy the paper uses in §IV.A."""
    levels = write_driver.default_driver(cfg)
    wer = 0.0
    if level_mix is None:
        level_mix = DEFAULT_LEVEL_MIX
    for code, frac in level_mix.items():
        lvl = next(l for l in levels if l.code == code)
        wer += frac * (mix.t01 * lvl.wer_0to1 + mix.t10 * lvl.wer_1to0)
    return wer
