"""extent_write micro-benchmark and HBM-roofline accounting, driven
through the ``repro_torch.memory`` backend registry (the counterpart of
``benchmarks/kernel_bench.py``).

What it measures, at ``n_mib`` of bf16 (the reference's inputs: normal
draws of ``PRNGKey(0)`` and ``PRNGKey(1)``, bit-exact with
``jax.random.normal``):

  * bytes moved per write (the kernel's memory-roofline numerator: read
    old and new, write stored) against the unfused composition's;
  * wall-clock per call of the lane twin (``lanes_ref``), of the eager
    bit-unpacked oracle (``approx_write_with_stats``: one uniform per
    (element, bit), stats read to the host) and of the device's backend
    (``cuda`` on the card, the twin on the CPU), each timed with the
    device synchronised around ``perf_counter`` — the wrapper and its
    launches, not the kernel's device time;
  * the level sweep: a level swaps the driver's vector operands only;
  * the projected kernel time on an H100 at its HBM rate
    (``launch.hw.HBM_BW``). At the default 8 MiB the three streams are
    25.2 MB, inside the card's 50 MB L2, so a repeated call may not read
    them from HBM.
"""
from __future__ import annotations

import time

import torch

from repro_torch import memory, rng
from repro_torch.core.approx_store import approx_write_with_stats
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device
from repro_torch.launch.hw import HBM_BW


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device, reps: int = 3) -> float:
    fn()  # warm-up (and the kernel's first load)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps


def inputs(n: int, device: torch.device):
    """(old, new, key) of ``n`` bf16 elements: the reference's draws."""
    old = torch.from_numpy(rng.normal(rng.PRNGKey(0), (n,)))
    new = torch.from_numpy(rng.normal(rng.PRNGKey(1), (n,)))
    return (old.to(torch.bfloat16).to(device),
            new.to(torch.bfloat16).to(device), rng.PRNGKey(2))


def run(n_mib: int = 8, device=None):
    dev = resolve_device(device)
    backend = memory.default_backend(dev)
    n = n_mib * 1024 * 1024 // 2  # bf16 elements
    old, new, key = inputs(n, dev)

    bytes_fused = 3 * n * 2              # read old+new, write stored
    nbits = 16
    bytes_unfused = bytes_fused + 2 * (n * nbits * 4) * 2  # unpacked u32 x2

    lane_s = _timed(lambda: memory.write(key, old, new, level=Priority.LOW,
                                         backend="lanes_ref"), dev)
    eager_s = _timed(lambda: approx_write_with_stats(
        key, old, new, Priority.LOW), dev, reps=1)

    # the level sweep on the lane twin: a level swaps vector operands
    sweep_s = {}
    for level in (Priority.MID, Priority.HIGH, Priority.EXACT):
        sweep_s[level.name] = _timed(
            lambda lv=level: memory.write(key, old, new, level=lv,
                                          backend="lanes_ref"),
            dev, reps=1)

    kernel_s = _timed(lambda: memory.write(key, old, new, level=Priority.LOW,
                                           backend=backend), dev)
    _, stats = memory.write(key, old, new, level=Priority.LOW,
                            backend=backend)

    return {
        "tensor_mib": n_mib,
        "backend": backend,
        "bytes_fused": bytes_fused,
        "bytes_unfused_jnp": bytes_unfused,
        "fusion_traffic_reduction_x": round(bytes_unfused / bytes_fused, 1),
        "projected_h100_us_fused": round(bytes_fused / HBM_BW * 1e6, 2),
        "projected_h100_us_unfused": round(bytes_unfused / HBM_BW * 1e6, 2),
        "lane_path_s": lane_s,
        "eager_oracle_s": eager_s,
        "lane_vs_eager_speedup_x": round(eager_s / max(lane_s, 1e-9), 1),
        "level_sweep_s": sweep_s,
        "cuda_backend_s": kernel_s,
        "errors": int(stats.errors),
    }


def bench_metrics(out) -> dict:
    """Flat latency/traffic metrics for the runner's BENCH_<n>.json."""
    m = {
        "tensor_mib": out["tensor_mib"],
        "fusion_traffic_reduction_x": out["fusion_traffic_reduction_x"],
        "projected_h100_us_fused": out["projected_h100_us_fused"],
        "lane_path_s": out["lane_path_s"],
        "eager_oracle_s": out["eager_oracle_s"],
        "lane_vs_eager_speedup_x": out["lane_vs_eager_speedup_x"],
        "cuda_backend_s": out["cuda_backend_s"],
    }
    for level, secs in out["level_sweep_s"].items():
        m[f"level_sweep_{level.lower()}_s"] = secs
    return m
