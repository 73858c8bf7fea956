"""Runner of the port's paper benchmarks: one module per paper table/figure.

Usage: PYTHONPATH=src python -m repro_torch.benchmarks.run [--only NAME]
       [--fast] [--device cuda|cpu] [--out-dir DIR]

Prints ``name,seconds,key_results`` per benchmark; exits nonzero if any
benchmark fails. The sizes are the reference runner's
(``benchmarks/run.py``), with and without ``--fast``. Every run also
writes a machine-readable ``BENCH_<n>.json`` into ``--out-dir`` (default
``build/bench_torch``; ``n`` is one more than the highest index there):
suite name, device, wall time, and per-benchmark {seconds, metrics}, the
metrics being the result's scalar leaves.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.benchmarks import (fig2_switching, fig6_thermal,
                                    fig12_waveform, fig14_energy,
                                    fig15_variation, table1)
from repro_torch.device import resolve_device

SUITE = "extent-repro-torch-benchmarks"

#: name -> run(fast, device)
BENCHES: Dict[str, Callable[[bool, torch.device], Any]] = {
    "table1": lambda fast, dev: table1.run(device=dev),
    "fig2_switching": lambda fast, dev: fig2_switching.run(
        n_mc=32 if fast else 128, device=dev),
    "fig6_thermal": lambda fast, dev: fig6_thermal.run(device=dev),
    "fig12_waveform": lambda fast, dev: fig12_waveform.run(device=dev),
    "fig14_energy": lambda fast, dev: fig14_energy.run(device=dev),
    "fig15_variation": lambda fast, dev: fig15_variation.run(
        n=200 if fast else 1000, device=dev),
}


def headline(name: str, out) -> str:
    if name == "table1":
        c = out["claims"]
        return (f"energy_saving={c['energy_saving_vs_ranjan']:.4f} "
                f"(paper 0.3304) latency_saving="
                f"{c['latency_saving_vs_quark']:.4f} (paper 0.0547)")
    if name == "fig2_switching":
        return f"mc_vs_eq1 monotone={out['monotone']}"
    if name == "fig6_thermal":
        return (f"tmr_down={out['fig6_tmr_monotone_down']} "
                f"v_down={out['fig7_voltage_monotone_down']}")
    if name == "fig12_waveform":
        return json.dumps(out["checks"])
    if name == "fig14_energy":
        return (f"mean_saving_vs_basic={out['mean_saving_vs_basic']:.3f} "
                f"ordering={out['ordering_holds_all_workloads']}")
    if name == "fig15_variation":
        return f"approx_spread_lower={out['fig15_claim_approx_spread_lower']}"
    return ""


def scrape_metrics(out, prefix: str = "", depth: int = 0) -> dict:
    """Scalar leaves of a (shallow) result dict as flat metric entries."""
    metrics = {}
    if not isinstance(out, dict) or depth > 2:
        return metrics
    for k, v in out.items():
        key = f"{prefix}{k}"
        if isinstance(v, bool):
            metrics[key] = v
        elif isinstance(v, (int, float)):
            metrics[key] = float(v)
        elif isinstance(v, dict):
            metrics.update(scrape_metrics(v, f"{key}.", depth + 1))
    return metrics


def next_bench_path(out_dir: Path) -> Path:
    """BENCH_<n>.json with n = 1 + the highest existing index."""
    pat = re.compile(r"^BENCH_(\d+)\.json$")
    taken = [int(m.group(1)) for p in out_dir.glob("BENCH_*.json")
             if (m := pat.match(p.name))]
    return out_dir / f"BENCH_{max(taken, default=0) + 1}.json"


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(BENCHES))
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out-dir", default="build/bench_torch",
                    help="directory the BENCH_<n>.json report lands in")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    failures = []
    results = {}
    t_suite = time.time()
    print("name,seconds,key_results")
    for name, fn in BENCHES.items():
        if args.only and name != args.only:
            continue
        t0 = time.time()
        try:
            out = fn(args.fast, dev)
            dt = time.time() - t0
            print(f"{name},{dt:.2f},{headline(name, out)}")
            results[name] = {"seconds": round(dt, 3),
                             "metrics": scrape_metrics(out)}
        except Exception as e:  # report every benchmark, then fail
            failures.append((name, repr(e)))
            traceback.print_exc()
            print(f"{name},FAIL,{e!r}")
            results[name] = {"seconds": round(time.time() - t0, 3),
                             "failed": True, "error": repr(e)}
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = next_bench_path(out_dir)
    path.write_text(json.dumps({
        "suite": SUITE,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "fast": args.fast,
        "only": args.only,
        "wall_time_s": round(time.time() - t_suite, 3),
        "benchmarks": results,
    }, indent=1, default=float))
    print(f"wrote {path}")
    if failures:
        print(f"{len(failures)} benchmark(s) failed: {failures}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
