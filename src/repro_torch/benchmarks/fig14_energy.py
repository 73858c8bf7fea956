"""Paper Fig. 14: normalized write energy vs. state-of-the-art, per workload
(the Fig. 13 transition mixes through the calibrated driver table)."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import arg_parser
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


def parser():
    return arg_parser(__doc__)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    out = run(device=args.device)
    print(f"{'workload':14s} {'basic':>6s} {'quark':>6s} {'cast':>6s} "
          f"{'extent':>7s}")
    for w, r in out["normalized_energy"].items():
        print(f"{w:14s} {r['basic']:6.3f} {r['quark']:6.3f} "
              f"{r['cast']:6.3f} {r['extent']:7.3f}")
    print(f"mean saving vs basic: {out['mean_saving_vs_basic']:.3f}")
    print(f"mean saving vs best SOTA: "
          f"{out['mean_saving_vs_best_sota']:.3f}")


if __name__ == "__main__":
    main()
