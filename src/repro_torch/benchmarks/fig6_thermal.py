"""Paper Fig. 6/7: TMR(T) roll-off and switching time/voltage vs temperature
(+ the Eq. 14/15 thermal-assist curves the EXTENT Vth tuning exploits).

Delta(T) comes through ``wer.delta_of_t``, the one Delta(T) source of the
stack. Host float32 closed forms, each the reference's value bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import arg_parser
from repro_torch.core import mtj, wer
from repro_torch.device import resolve_device


def run(device=None):
    resolve_device(device)
    p = mtj.DEFAULT_MTJ
    temps = np.asarray([250.0, 300.0, 350.0, 400.0, 450.0])
    tmr = np.asarray(mtj.tmr_of_t(p, temps))
    delta = np.asarray(wer.delta_of_t(temps, p))
    v_5ns = np.asarray([float(mtj.switching_voltage(p, 5e-9, t))
                        for t in temps])
    psw = np.asarray([float(wer.switching_probability(5e-9, d, 0.98))
                      for d in delta])
    wth = np.asarray([float(wer.wer_thermal_at(1e-8, 1.4, t, p))
                      for t in temps])
    return {
        "temps_K": temps.tolist(),
        "tmr": tmr.tolist(),
        "delta": delta.tolist(),
        "v_switch_5ns": v_5ns.tolist(),
        "p_sw_subcritical": psw.tolist(),
        "wer_thermal_10ns_1p4": wth.tolist(),
        "fig6_tmr_monotone_down": bool(np.all(np.diff(tmr) < 0)),
        "fig7_voltage_monotone_down": bool(np.all(np.diff(v_5ns) < 0)),
        "thermal_assist_monotone_up": bool(np.all(np.diff(psw) > 0)),
        # hotter die -> lower Delta -> easier switching -> lower write WER
        "wer_thermal_monotone_down": bool(np.all(np.diff(wth) <= 1e-12)),
    }


def parser():
    return arg_parser(__doc__)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    for k, v in run(device=args.device).items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
