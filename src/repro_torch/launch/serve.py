"""Serving launcher of the port (continuous batching by default).

  python -m repro_torch.launch.serve --arch qwen2.5-3b --requests 6 \
      --capacity 3 --arrival-every 2 --new-tokens 16 --quality chat=high
  python -m repro_torch.launch.serve --trace tests/fixtures/trace_smoke.jsonl
  python -m repro_torch.launch.serve --monolithic --batch 4
  python -m repro_torch.launch.serve --ambient-k 350 \
      --retention-scale 1000 --scrub-policy periodic --scrub-interval 8
  python -m repro_torch.launch.serve --reduced --device cpu ...   # CPU

Runs on CUDA unless ``--device cpu``; ``--reduced`` shrinks the config
(float32, a few narrow layers). ``--backend`` picks the write path from
the ``repro_torch.memory`` registry (default: ``cuda`` on a CUDA device,
``lanes_ref`` on the CPU). Synthetic prompts are drawn with numpy and
differ from the JAX launcher's; replay a trace for a like-for-like run.

``--retention-scale`` (seconds of modelled dwell per decode step) turns
on retention decay at ``--ambient-k`` kelvin; ``--scrub-policy`` runs
background scrub passes between bursts (whole leaves, or windows of
``--scrub-cols`` ring columns) and implies ``--retention-scale 1000``
when that is left at 0. The report then ends with the lifetime ledger.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device
from repro_torch.memory import available_backends
from repro_torch.reliability import make_scrub_policy
from repro_torch.serve import (ContinuousScheduler, ServeConfig,
                               ServingEngine, synthetic_requests)
from repro_torch.telemetry import render_report
from repro_torch.workload import TraceSource, load_trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to ask for "
                         "the CPU)")
    ap.add_argument("--backend", default=None, choices=available_backends(),
                    help="write-path backend (default: cuda on a CUDA "
                         "device, lanes_ref on the CPU)")
    ap.add_argument("--batch", type=int, default=4,
                    help="monolithic-mode batch size")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--no-extent", action="store_true")
    ap.add_argument("--monolithic", action="store_true",
                    help="single fixed batch, no arrival stream")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="replay a recorded workload trace (JSONL)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--capacity", type=int, default=3)
    ap.add_argument("--arrival-every", type=int, default=2)
    ap.add_argument("--apps", default="chat,summarize",
                    help="comma-separated app ids cycled over requests")
    ap.add_argument("--quality", action="append", default=[],
                    metavar="APP=LEVEL",
                    help="tag an app block (low/mid/high/exact); repeats")
    ap.add_argument("--ambient-k", type=float, default=300.0,
                    help="die ambient temperature (kelvin) for the "
                         "retention model")
    ap.add_argument("--retention-scale", type=float, default=0.0,
                    help="modelled device dwell (seconds) per decode "
                         "step; 0 disables the retention model")
    ap.add_argument("--scrub-policy", default="none",
                    choices=("none", "periodic", "wear_aware",
                             "quality_floor"),
                    help="background scrub policy (continuous mode; "
                         "implies --retention-scale 1000 when that is 0)")
    ap.add_argument("--scrub-interval", type=int, default=8,
                    help="base scrub interval in decode steps")
    ap.add_argument("--scrub-cols", type=int, default=0,
                    help="columns per scrub pass (0 = whole leaves)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    retention_scale = args.retention_scale
    if args.scrub_policy != "none" and retention_scale == 0.0:
        retention_scale = 1000.0  # scrubbing without decay is a no-op

    def serve_cfg(max_seq: int, new_tokens: int) -> ServeConfig:
        return ServeConfig(max_seq=max_seq, max_new_tokens=new_tokens,
                           extent_enabled=not args.no_extent,
                           backend=args.backend,
                           retention_scale=retention_scale,
                           ambient_k=args.ambient_k)

    if args.monolithic:
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len))
        eng = ServingEngine(cfg, serve_cfg(args.prompt_len + args.new_tokens,
                                           args.new_tokens), device=device)
        out, report = eng.generate(
            {"tokens": torch.from_numpy(toks).to(device)})
        print(f"generated {tuple(out.shape)} tokens; first row: "
              f"{out[0, :8].tolist()}...")
        if not args.no_extent:
            tot = report["total"]
            print(f"KV write energy {tot['energy_pj'] / 1e6:.3f} uJ "
                  f"(backend={eng.backend}), "
                  f"skip-rate {tot['write_skip_rate']:.3f}, "
                  f"BER {tot['ber_realized']:.2e}")
        return

    if args.trace:
        trace = load_trace(args.trace)
        eng = ServingEngine(cfg, serve_cfg(trace.max_seq(),
                                           trace.max_new_tokens()),
                            device=device)
        reqs = TraceSource(trace, cfg, device)
        print(f"workload: trace {args.trace}, {len(trace.events)} events")
    else:
        eng = ServingEngine(cfg, serve_cfg(args.prompt_len + args.new_tokens,
                                           args.new_tokens), device=device)
        apps = [a for a in args.apps.split(",") if a] or [None]
        reqs = synthetic_requests(
            cfg, args.requests, device=device, prompt_len=args.prompt_len,
            new_tokens=args.new_tokens, arrival_every=args.arrival_every,
            app_ids=apps)
        print(f"workload: synthetic, {len(reqs)} events")
    for spec in args.quality:
        app, _, level = spec.partition("=")
        eng.controller.tag("kv_request", app, Priority.coerce(level))
    scrub_policy = None
    if args.scrub_policy != "none":
        scrub_policy = make_scrub_policy(args.scrub_policy,
                                         interval=args.scrub_interval,
                                         cols_per_pass=args.scrub_cols)
    report = ContinuousScheduler(eng, capacity=args.capacity,
                                 scrub_policy=scrub_policy).run(reqs)
    for line in render_report(report, backend=eng.backend,
                              show_extent=not args.no_extent):
        print(line)


if __name__ == "__main__":
    main()
