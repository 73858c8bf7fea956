"""Paper Fig. 2/3/5: stochastic switching dynamics of the MTJ cell.

Monte-Carlo s-LLGS transients on the device: the switching failure rate
against the drive current, beside the closed-form Eq. 1. Every current
integrates the same ``n_mc`` noise trajectories (the reference draws them
off one key for each), so they are drawn on the host once.
"""
from __future__ import annotations

import time

from repro_torch import rng
from repro_torch.benchmarks import arg_parser
from repro_torch.core import mtj, wer
from repro_torch.device import resolve_device

CURRENTS_UA = (240, 300, 400, 500)
T_PULSE = 10e-9
DT = 5e-12


def run(n_mc: int = 128, device=None):
    dev = resolve_device(device)
    p = mtj.DEFAULT_MTJ
    key = rng.PRNGKey(0)
    out = {}
    t0 = time.time()
    noise = mtj.llgs_noise(rng.split(key, n_mc), int(T_PULSE / DT))
    for i_ua in CURRENTS_UA:
        w = float(mtj.monte_carlo_wer(key, p, i_ua * 1e-6, t_pulse=T_PULSE,
                                      n=n_mc, device=dev, noise=noise))
        analytic = float(wer.wer_bit(10e-9, i_ua / 200.0, p.delta0))
        out[f"I={i_ua}uA"] = {"mc_wer": w, "eq1_wer": analytic}
    # Fig 2's qualitative claim: higher current -> lower switching failure
    wers = [v["mc_wer"] for v in out.values()]
    out["monotone"] = bool(all(a >= b - 0.05 for a, b in zip(wers, wers[1:])))
    out["us_per_call"] = (time.time() - t0) / (4 * n_mc) * 1e6
    return out


def parser():
    return arg_parser(__doc__)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    for k, v in run(device=args.device).items():
        print(k, v)


if __name__ == "__main__":
    main()
