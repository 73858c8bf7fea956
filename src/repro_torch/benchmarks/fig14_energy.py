"""Paper Fig. 14: normalized write energy vs. state-of-the-art, per workload
(the Fig. 13 transition mixes through the calibrated driver table)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import cache_sim
from repro_torch.device import resolve_device


def run(device=None):
    resolve_device(device)
    table = cache_sim.fig14_normalized_energy()
    rows = {w: {k: round(v, 4) for k, v in r.items()}
            for w, r in table.items()}
    extent_savings = 1.0 - float(np.mean([r["extent"] for r in
                                          table.values()]))
    vs_best_sota = [1.0 - r["extent"] / min(r["quark"], r["cast"])
                    for r in table.values()]
    return {
        "normalized_energy": rows,
        "mean_saving_vs_basic": extent_savings,
        "mean_saving_vs_best_sota": float(np.mean(vs_best_sota)),
        "ordering_holds_all_workloads": all(
            r["extent"] < r["cast"] < r["quark"] < r["basic"]
            for r in table.values()),
    }
