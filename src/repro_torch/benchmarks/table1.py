"""Paper Table 1: EXTENT vs. state-of-the-art write circuits.

Reproduces the comparison rows from the calibrated driver model and checks
the paper's headline claims (33.04% energy, 5.47% latency, 3.7% area).
Host arithmetic on the driver's level table.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import arg_parser
from repro_torch.core import cache_sim, write_driver
from repro_torch.device import resolve_device

LEVEL_MIX = cache_sim.DEFAULT_LEVEL_MIX


def run(device=None):
    resolve_device(device)
    mixes = [cache_sim.mix_from_fig13(w) for w in cache_sim.FIG13_WORKLOADS]
    t01 = float(np.mean([m.t01 for m in mixes]))
    t10 = float(np.mean([m.t10 for m in mixes]))
    levels = write_driver.default_driver()
    e_extent = sum(
        frac * write_driver.WORD_BITS *
        (t01 * next(l for l in levels if l.code == c).e_0to1_pj +
         t10 * next(l for l in levels if l.code == c).e_1to0_pj)
        for c, frac in LEVEL_MIX.items())
    lat_extent = write_driver.word_latency_ns(levels, LEVEL_MIX)

    rows = []
    for name, row in write_driver.TABLE1.items():
        ours = name == "extent"
        rows.append({
            "scheme": name,
            "area_mm2": row["area_mm2"],
            "latency_ns": round(lat_extent, 2) if ours else row["latency_ns"],
            "energy_pj": round(e_extent, 1) if ours else row["energy_pj"],
            "self_term": row["self_term"],
            "paper_energy_pj": row["energy_pj"],
        })
    claims = {
        "energy_saving_vs_ranjan": 1 - e_extent / 503.6,
        "paper_claim_energy": 0.3304,
        "latency_saving_vs_quark": 1 - lat_extent / 7.3,
        "paper_claim_latency": 0.0547,
        "area_overhead_vs_cast": write_driver.TABLE1["extent"]["area_mm2"]
        / write_driver.TABLE1["cast_tcad20"]["area_mm2"] - 1,
        "paper_claim_area": 0.037,
    }
    return {"rows": rows, "claims": claims}


def parser():
    return arg_parser(__doc__)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    out = run(device=args.device)
    print(f"{'scheme':16s} {'area':>6s} {'lat ns':>7s} {'E pJ':>7s} "
          f"self-term")
    for r in out["rows"]:
        print(f"{r['scheme']:16s} {r['area_mm2']:6.2f} "
              f"{r['latency_ns']:7.2f} {r['energy_pj']:7.1f} "
              f"{r['self_term']}")
    for k, v in out["claims"].items():
        print(f"{k}: {v:.4f}")


if __name__ == "__main__":
    main()
