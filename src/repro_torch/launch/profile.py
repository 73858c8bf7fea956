"""Where a decode step's time goes, on the card.

  python -m repro_torch.launch.profile [--arch qwen2.5-3b] [--batch 4] \
      [--prompt-len 256] [--steps 8] [--out profile.txt]
  python -m repro_torch.launch.profile --arch dbrx-132b --layers 6

Builds the engine at the given config (full width unless ``--reduced``;
``--layers N`` cuts the depth to N layers, as a model too large for one
card needs: dbrx-132b's 40 layers are 263 GB of bf16),
prefills one batch, warms up, then runs ``--steps`` fused decode steps
under ``torch.profiler`` (CPU and CUDA activities). Prints one JSON line:
host wall ms per step, device-busy ms per step (the sum of kernel times)
and the busy share, the extent_write kernel's share, and the top ops by
host time and by device time. ``--out`` also writes the full
``key_averages`` table. A vlm's prompts carry their image embeddings
and an audio model's whisper's 1500 frames (``modal_leaves``). Needs a
CUDA device.

``steady_burst`` is the decode-step setup shared with ``chip_smoke.py``,
which times the same step without the profiler.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.core.energy_model import zero_slot_stats
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device
from repro_torch.memory import WriteStats
from repro_torch.models import whisper
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.serve.scheduler import modal_leaves


def _dev_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def steady_burst(eng: ServingEngine, batch: int, prompt_len: int,
                 seed: int = 0, extra: Optional[Dict[str, Any]] = None):
    """Prefill a full pool of ``batch`` random prompts of ``prompt_len``
    tokens (drawn from ``seed``; ``extra``: the prompt's other leaves, a
    vlm's ``image_embeds`` or an audio model's ``frames``) at the LOW
    floor; returns ``run(n)``,
    which decodes ``n`` fused steps from that state (with the retention
    decay and the wear layer, through the identity map, when the engine
    has them on). The state is not carried over, so every call repeats
    the same steps."""
    device = eng.device
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, eng.cfg.vocab_size, (batch, prompt_len))).to(device)
    vec = eng.vectors_for_floor(Priority.LOW)
    prompt = {"tokens": toks, **(extra or {})}
    tok, cache, key, _ = eng.prefill(eng.params, prompt, None,
                                     rng.PRNGKey(seed), vec)
    pos = torch.full((batch,), eng.prompt_len(prompt), dtype=torch.int64,
                     device=device)
    active = torch.ones((batch,), dtype=torch.bool, device=device)
    life = rvec = None
    if eng.life_plan is not None:
        life = eng.life_plan.init_state(cache)
        rvec = eng.retention_vectors_for(Priority.LOW)
    shifts = eng.plan.identity_address().shifts if eng.wear else None

    def run(n: int):
        return eng.burst(eng.params, tok, cache, pos, key,
                         WriteStats.zero(device),
                         zero_slot_stats(batch, device), active, vec, life,
                         rvec, shifts, n=n)

    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's own)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    # a vlm's prompts carry their image columns, an audio model's its
    # 30-second window of frames
    extra = modal_leaves(cfg, 1, device, batch=args.batch,
                         frames=whisper.ENC_LEN)
    image = cfg.num_image_tokens if cfg.family == "vlm" else 0
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=args.prompt_len + 2 * args.steps + 4 + image), device=device)
    run = steady_burst(eng, args.batch, args.prompt_len, extra=extra)
    run(3)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    rows = [(e.key, e.count, float(e.self_cpu_time_total), _dev_us(e),
             "CUDA" in str(getattr(e, "device_type", "")))
            for e in avgs]
    # device busy: kernel rows only — an aten row's device time is the
    # time of the kernels it launched, which the kernel rows already hold
    dev_total = sum(r[3] for r in rows if r[4])
    ew = sum(r[3] for r in rows if r[4] and "extent_write" in r[0])
    n = args.steps
    top_host = sorted(rows, key=lambda r: -r[2])[:12]
    top_dev = sorted((r for r in rows if r[4]), key=lambda r: -r[3])[:12]
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.num_layers, "batch": args.batch,
        "steps": n,
        "wall_ms_per_step": wall * 1e3 / n,
        "device_busy_ms_per_step": dev_total / 1e3 / n,
        "device_busy_share": dev_total / 1e6 / wall,
        "extent_write_device_ms_per_step": ew / 1e3 / n,
        "kernels_per_step": sum(r[1] for r in rows if r[4]) / n,
        "top_host_ms_per_step": [[r[0], r[1] / n, r[2] / 1e3 / n]
                                 for r in top_host],
        "top_device_ms_per_step": [[r[0], r[1] / n, r[3] / 1e3 / n]
                                   for r in top_dev],
    }), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(avgs.table(sort_by="self_cpu_time_total",
                                             row_limit=60))


if __name__ == "__main__":
    main()
