"""Paper Fig. 15/16: Monte-Carlo process/voltage variation of write energy
(1000 samples; CMOS 3-sigma W/L/Vth, MTJ 10/10/5% oxide/FM/resistance),
the corners evaluated on the device."""
from __future__ import annotations

import json

from repro_torch import rng
from repro_torch.benchmarks import arg_parser
from repro_torch.core import energy_model
from repro_torch.device import resolve_device

SWEEP_SIGMAS = (0.0, 0.03, 0.05, 0.10)


def run(n: int = 1000, device=None):
    dev = resolve_device(device)
    key = rng.PRNGKey(0)
    mc = energy_model.monte_carlo_variation(key, n=n, device=dev)
    sweep = energy_model.voltage_sweep(key, sigmas=SWEEP_SIGMAS,
                                       n=max(200, n // 4), device=dev)
    v_sensitivity = {
        s: round(v["energy_full_pj"]["std"], 3) for s, v in sweep.items()}
    return {
        "fig15_full_write_energy": mc["energy_full_pj"],
        "fig15_approx_write_energy": mc["energy_approx_pj"],
        # paper Fig. 15 reading: the approximated-write energy DISTRIBUTION
        # sits below the completed-write one — the range is lower, not
        # merely narrower
        "fig15_claim_approx_spread_lower": bool(
            mc["energy_approx_pj"]["p95"] < mc["energy_full_pj"]["p95"]
            and mc["energy_approx_pj"]["mean"] < mc["energy_full_pj"]["mean"]),
        "fig16_energy_std_vs_vdd_sigma": v_sensitivity,
        "wer_exact_under_pv": mc["wer_exact"],
        "wer_low_under_pv": mc["wer_low"],
        "n_samples": n,
    }


def parser():
    return arg_parser(__doc__)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    print(json.dumps(run(device=args.device), indent=1, default=float))


if __name__ == "__main__":
    main()
