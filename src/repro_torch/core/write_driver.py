"""EXTENT 4-level write driver (paper Fig. 9) and its calibrated level table.

A copy of ``repro.core.write_driver``: four quality levels 00(low)..11(high),
each a (current overdrive, pulse width, energy) bank, folded through the
WER model and the CMP self-termination expectation into per-bit failure
probabilities, energies and latencies; the paper's Table 1 rows; and the
word-level energy and latency of a priority mix. The table is host data
(numpy float32, bit-equal to the reference's serving table) that the
write plan turns into device operands once.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np

from repro_torch.core import wer as wer_mod

VDDH = 0.9
VDDL = 0.86001
WORD_BITS = 64
PULSE_NS = 10.0  # write-enable pulse budget (matches SOTA [2][17][20][37])

# Table 1 reference rows (word-level, for the table1 benchmark)
TABLE1 = {
    "basic": {"area_mm2": 1.31, "latency_ns": 19.0, "energy_pj": 1046.0,
              "self_term": False, "monitoring": "none"},
    "ranjan_dac15": {"area_mm2": 1.37, "latency_ns": 2.2, "energy_pj": 503.6,
                     "self_term": False, "monitoring": "continuous"},  # [18]
    "quark_islped17": {"area_mm2": 1.31, "latency_ns": 7.3, "energy_pj": 393.3,
                       "self_term": False, "monitoring": "none"},      # [21]
    "extent": {"area_mm2": 1.46, "latency_ns": 6.9, "energy_pj": 337.2,
               "self_term": True, "monitoring": "continuous"},
    "cast_tcad20": {"area_mm2": 1.41, "latency_ns": 7.8, "energy_pj": 356.9,
                    "self_term": True, "monitoring": "continuous"},    # [40]
}


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """One write-quality level of the driver (paper Fig. 9 transistor bank)."""
    name: str
    code: int
    vdd: float
    i_rel: float
    pulse_ns: float
    e_rel: float = 1.0
    wer_0to1: float = 0.0
    wer_1to0: float = 0.0
    e_0to1_pj: float = 0.0
    e_1to0_pj: float = 0.0
    latency_ns: float = 0.0


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    delta: float = 60.0
    temperature: float = 400.0
    self_terminate: bool = True
    redundant_write_elim: bool = True
    p2ap_energy_ratio: float = 2.5
    e_bit_full_pj: float = 1046.0 / WORD_BITS * 2.5889
    t_overhead_ns: float = 0.67418


#   name          code  vdd   i_rel pulse_ns e_rel
_LEVEL_PARAMS: Tuple[Tuple[str, int, float, float, float, float], ...] = (
    ("approx_low",  0b00, VDDL, 1.22, 10.0, 0.25),
    ("approx_mid",  0b01, VDDL, 1.38, 10.0, 0.45),
    ("approx_high", 0b10, VDDH, 1.55, 10.0, 0.75),
    ("exact",       0b11, VDDH, 1.80, 10.0, 1.10),
)


def _calibrate_level(name: str, code: int, vdd: float, i_rel: float,
                     pulse_ns: float, e_rel: float,
                     cfg: DriverConfig) -> LevelSpec:
    """Fold the WER equations + self-termination expectation into a level."""
    t_w = pulse_ns * 1e-9
    w01 = float(wer_mod.wer_from_level(t_w, i_rel, cfg.delta, True))
    w10 = float(wer_mod.wer_from_level(t_w, i_rel, cfg.delta, False))
    e_full = cfg.e_bit_full_pj * e_rel
    if cfg.self_terminate:
        frac01 = float(wer_mod.expected_pulse_fraction(
            t_w, 1.0 + (i_rel - 1.0) * 0.75, cfg.delta))
        frac10 = float(wer_mod.expected_pulse_fraction(t_w, i_rel,
                                                       cfg.delta))
    else:
        frac01 = frac10 = 1.0
    r = cfg.p2ap_energy_ratio
    occ = 0.5 * (frac01 + frac10)
    e01 = e_full * occ * (2.0 * r / (1.0 + r))
    e10 = e_full * occ * (2.0 / (1.0 + r))
    lat_occ = max(frac01, frac10) if cfg.self_terminate else 1.0
    lat = pulse_ns * lat_occ + cfg.t_overhead_ns
    return LevelSpec(name=name, code=code, vdd=vdd, i_rel=i_rel,
                     pulse_ns=pulse_ns, e_rel=e_rel, wer_0to1=w01,
                     wer_1to0=w10, e_0to1_pj=e01, e_1to0_pj=e10,
                     latency_ns=lat)


@functools.lru_cache(maxsize=32)
def default_driver(cfg: DriverConfig = DriverConfig()) -> Tuple[LevelSpec, ...]:
    return tuple(_calibrate_level(*p, cfg) for p in _LEVEL_PARAMS)


@functools.lru_cache(maxsize=32)
def level_table(cfg: DriverConfig = DriverConfig()) -> Dict[str, np.ndarray]:
    """{wer01, wer10, e01, e10, lat}[4] float32, indexed by the 2-bit
    priority code (host arrays; callers copy, never mutate)."""
    by_code = sorted(default_driver(cfg), key=lambda l: l.code)
    table = {
        "wer01": [l.wer_0to1 for l in by_code],
        "wer10": [l.wer_1to0 for l in by_code],
        "e01": [l.e_0to1_pj for l in by_code],
        "e10": [l.e_1to0_pj for l in by_code],
        "lat": [l.latency_ns for l in by_code],
    }
    out = {k: np.asarray(v, np.float32) for k, v in table.items()}
    for v in out.values():
        v.setflags(write=False)
    return out


def word_energy_pj(levels: Tuple[LevelSpec, ...], level_mix: Dict[int, float],
                   p_transition: float = 0.5) -> float:
    """Expected 64-bit word write energy for a priority mix; a bit flips
    with probability ``p_transition`` (the Fig. 13 access pattern),
    50/50 between directions."""
    total = 0.0
    for code, frac in level_mix.items():
        lvl = next(l for l in levels if l.code == code)
        e_bit = 0.5 * (lvl.e_0to1_pj + lvl.e_1to0_pj)
        total += frac * WORD_BITS * p_transition * e_bit
    return total


def word_latency_ns(levels: Tuple[LevelSpec, ...],
                    level_mix: Dict[int, float]) -> float:
    """Word write latency: the per-level banks write in parallel, so the
    slowest *used* bank (mix fraction > 0) bounds the word."""
    used = [next(l for l in levels if l.code == code)
            for code, frac in level_mix.items() if frac > 0]
    return max((l.latency_ns for l in used), default=0.0)
