"""Runner of the port's benchmarks: the paper's tables and figures and
the serving stack's benchmarks, one module each.

Usage: PYTHONPATH=src python -m repro_torch.benchmarks.run [--only NAME]
       [--fast] [--quick] [--device cuda|cpu] [--out-dir DIR]

Prints ``name,seconds,key_results`` per benchmark; exits nonzero if any
benchmark fails. The sizes are the reference runner's
(``benchmarks/run.py``), with and without ``--fast``. ``--quick`` is
the reference's quick profile (implies ``--fast``). Every run also
writes a machine-readable ``BENCH_<n>.json`` into ``--out-dir``
(default ``build/bench_torch``; ``n`` is one more than the highest
index there): suite name, device, wall time, and per-benchmark
{seconds, metrics}. A module's metrics are its ``bench_metrics(out)``
where it has one (a hook that raises falls back to the scraped scalar
leaves, flagged ``_metrics_fallback``), else the result's scalar leaves.
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

from repro_torch.benchmarks import (endurance_sweep, fig2_switching,
                                    fig6_thermal, fig12_waveform,
                                    fig13_access, fig14_energy,
                                    fig15_variation,
                                    kernel_bench, prefix_reuse,
                                    retention_sweep, serving_energy,
                                    shard_scaling, table1,
                                    telemetry_overhead, workload_mixes)
from repro_torch.device import resolve_device

SUITE = "extent-repro-torch-benchmarks"

#: name -> run(fast, device)
BENCHES: Dict[str, Callable[[bool, torch.device], Any]] = {
    "table1": lambda fast, dev: table1.run(device=dev),
    "fig2_switching": lambda fast, dev: fig2_switching.run(
        n_mc=32 if fast else 128, device=dev),
    "fig6_thermal": lambda fast, dev: fig6_thermal.run(device=dev),
    "fig12_waveform": lambda fast, dev: fig12_waveform.run(device=dev),
    "fig13_access": lambda fast, dev: fig13_access.run(device=dev),
    "fig14_energy": lambda fast, dev: fig14_energy.run(device=dev),
    "fig15_variation": lambda fast, dev: fig15_variation.run(
        n=200 if fast else 1000, device=dev),
    "kernel_bench": lambda fast, dev: kernel_bench.run(
        n_mib=2 if fast else 8, device=dev),
    "serving_energy": lambda fast, dev: serving_energy.run(
        archs=("qwen2.5-3b",) if fast else ("qwen2.5-3b",
                                            "recurrentgemma-2b"),
        new_tokens=4 if fast else 8, device=dev),
    "retention_sweep": lambda fast, dev: retention_sweep.run(
        steps=8 if fast else 16,
        shape=(32, 64) if fast else (64, 128), device=dev),
    "endurance_sweep": lambda fast, dev: endurance_sweep.run(
        steps=64 if fast else 160,
        shape=(8, 32) if fast else (8, 64), device=dev),
    "prefix_reuse": lambda fast, dev: prefix_reuse.run(
        n=12 if fast else 16, device=dev),
    "workload_mixes": lambda fast, dev: workload_mixes.run(
        events=4 if fast else 6, device=dev),
    "telemetry_overhead": lambda fast, dev: telemetry_overhead.check(
        MEASURES["telemetry_overhead"](fast, dev)),
    "shard_scaling": lambda fast, dev: shard_scaling.check(
        MEASURES["shard_scaling"](fast, dev)),
}

#: name -> measure(fast, device) of the modules whose claims include
#: wall-clock comparisons (their ``TIMED_CLAIMS``): the result and its
#: claims, not asserted (BENCHES asserts them)
MEASURES: Dict[str, Callable[[bool, torch.device], Any]] = {
    "telemetry_overhead": lambda fast, dev: telemetry_overhead.measure(
        repeats=4 if fast else 6, device=dev),
    "shard_scaling": lambda fast, dev: shard_scaling.measure(
        n=6 if fast else 8, repeats=2 if fast else 3, device=dev),
}

#: the paper's tables and figures
PAPER = ("table1", "fig2_switching", "fig6_thermal", "fig12_waveform",
         "fig13_access", "fig14_energy", "fig15_variation")
#: the serving stack's benchmarks
SERVING = ("kernel_bench", "serving_energy", "retention_sweep",
           "endurance_sweep", "prefix_reuse", "workload_mixes",
           "telemetry_overhead", "shard_scaling")

#: the --quick profile: the reference's QUICK_BENCHES (its sub-minute
#: subset, one invocation, one JSON)
QUICK_BENCHES = ("table1", "fig6_thermal", "kernel_bench",
                 "retention_sweep", "endurance_sweep", "prefix_reuse",
                 "workload_mixes", "telemetry_overhead", "shard_scaling")

#: modules exposing ``bench_metrics(out)``
METRIC_FNS = {
    "serving_energy": serving_energy.bench_metrics,
    "kernel_bench": kernel_bench.bench_metrics,
    "retention_sweep": retention_sweep.bench_metrics,
    "endurance_sweep": endurance_sweep.bench_metrics,
    "prefix_reuse": prefix_reuse.bench_metrics,
    "workload_mixes": workload_mixes.bench_metrics,
    "telemetry_overhead": telemetry_overhead.bench_metrics,
    "shard_scaling": shard_scaling.bench_metrics,
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
    if name == "fig13_access":
        return (f"kv_expensive_share="
                f"{out['kv_decode_stream']['expensive_share']:.2f}")
    if name == "fig14_energy":
        return (f"mean_saving_vs_basic={out['mean_saving_vs_basic']:.3f} "
                f"ordering={out['ordering_holds_all_workloads']}")
    if name == "fig15_variation":
        return f"approx_spread_lower={out['fig15_claim_approx_spread_lower']}"
    if name == "kernel_bench":
        return (f"fusion_x={out['fusion_traffic_reduction_x']} "
                f"h100_us={out['projected_h100_us_fused']}")
    if name == "serving_energy":
        k = next(iter(out))
        return (f"{k}: saving={out[k]['saving_vs_basic']:.3f} "
                f"skip={out[k]['write_skip_rate']:.3f}")
    if name == "retention_sweep":
        return json.dumps(out["claims"])
    if name == "endurance_sweep":
        return (f"leveling_gain={out['wear_leveling_gain']:.1f}x "
                f"remap_overhead={out['remap_overhead_frac']:.2f}")
    if name == "prefix_reuse":
        return (f"admission_energy_reduction="
                f"{out['admission_energy_reduction']:.3f} "
                f"hit_rate={out['prefix']['hit_rate']:.2f}")
    if name == "workload_mixes":
        adv = out["adversarial"]
        return (f"mixes={len(out['ramp'])} "
                f"pressure={out['ramp'][0]['pressure']:.2f}→"
                f"{out['ramp'][-1]['pressure']:.2f} "
                f"adversarial_worn none={adv['none']['worn_groups']:.0f} "
                f"rotate={adv['rotate']['worn_groups']:.0f}")
    if name == "telemetry_overhead":
        return (f"overhead={out['overhead_frac']:+.3f} "
                f"bit_exact={out['claims']['bit_exact_tokens']} "
                f"drains/event={out['telemetry']['drains_per_event']:g}")
    if name == "shard_scaling":
        return (f"bit_identical="
                f"{out['claims']['bit_identical_across_dies']} "
                f"speedup_4die={out['speedup_vs_1die']['4']:.2f}x "
                f"collective_free="
                f"{out['claims']['burst_collective_free']}")
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


def metrics_for(name: str, out) -> dict:
    fn = METRIC_FNS.get(name)
    if fn is None:
        return scrape_metrics(out)
    try:
        return {k: (v if isinstance(v, bool) else float(v))
                for k, v in fn(out).items()}
    except Exception as e:
        # a broken hook must not hide: the series would change schema
        # mid-way. Flag the fallback in the report.
        print(f"WARNING: {name}.bench_metrics failed ({e!r}); falling "
              f"back to scraped metrics", file=sys.stderr)
        return {"_metrics_fallback": True, **scrape_metrics(out)}


def next_bench_path(out_dir: Path) -> Path:
    """BENCH_<n>.json with n = 1 + the highest existing index."""
    pat = re.compile(r"^BENCH_(\d+)\.json$")
    taken = [int(m.group(1)) for p in out_dir.glob("BENCH_*.json")
             if (m := pat.match(p.name))]
    return out_dir / f"BENCH_{max(taken, default=0) + 1}.json"


def selected(only: Optional[str] = None, quick: bool = False) -> list:
    """The benchmarks a run takes, in registration order: ``only`` alone,
    else the quick profile with ``quick``, else all."""
    if only:
        return [only]
    return [n for n in BENCHES if not quick or n in QUICK_BENCHES]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(BENCHES))
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="the quick profile (implies --fast): "
                         "QUICK_BENCHES in one invocation, one BENCH json")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out-dir", default="build/bench_torch",
                    help="directory the BENCH_<n>.json report lands in")
    args = ap.parse_args(argv)
    if args.quick:
        args.fast = True
    dev = resolve_device(args.device)
    failures = []
    results = {}
    t_suite = time.time()
    print("name,seconds,key_results")
    for name in selected(args.only, args.quick):
        t0 = time.time()
        try:
            out = BENCHES[name](args.fast, dev)
            dt = time.time() - t0
            print(f"{name},{dt:.2f},{headline(name, out)}")
            results[name] = {"seconds": round(dt, 3),
                             "metrics": metrics_for(name, out)}
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
        "quick": args.quick,
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
