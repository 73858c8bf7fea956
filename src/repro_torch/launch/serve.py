"""Serving launcher of the port (continuous batching by default).

  python -m repro_torch.launch.serve --arch qwen2.5-3b --requests 6 \
      --capacity 3 --arrival-every 2 --new-tokens 16 --quality chat=high
  python -m repro_torch.launch.serve --trace tests/fixtures/trace_smoke.jsonl
  python -m repro_torch.launch.serve --monolithic --batch 4
  python -m repro_torch.launch.serve --ambient-k 350 \
      --retention-scale 1000 --scrub-policy periodic --scrub-interval 8
  python -m repro_torch.launch.serve --backend oracle --soft-error-ber 1e-6
  python -m repro_torch.launch.serve --prefix-cache --shared-prefix 8
  python -m repro_torch.launch.serve --reduced --device cpu ...   # CPU
  python -m repro_torch.launch.serve --arch dbrx-132b --reduced --device cpu
  python -m repro_torch.launch.serve --arch mamba2-2.7b
  python -m repro_torch.launch.serve --arch llava-next-mistral-7b
  python -m repro_torch.launch.serve --arch whisper-large-v3 --monolithic

Runs on CUDA unless ``--device cpu``; ``--reduced`` shrinks the config
(float32, a few narrow layers). ``--backend`` picks the write path from
the ``repro_torch.memory`` registry (default: ``cuda`` on a CUDA device,
``lanes_ref`` on the CPU; ``oracle`` is the eager bit-unpacked write).
Synthetic prompts, the ``--monolithic`` batch and the ``--shared-prefix``
head are the JAX launcher's (threefry ``randint`` off ``PRNGKey(seed +
17 i)``, ``PRNGKey(0)`` and ``PRNGKey(1234)``); a vlm or audio prompt's
image embeddings or frames are ``normal`` draws off ``PRNGKey(seed + 17 i
+ 1)`` (``--monolithic``: ``PRNGKey(1)``). The audio family serves only
``--monolithic``: its continuous modes exit with the scheduler's refusal,
as the reference's scheduler fails on it.

Trace-driven workloads (``repro_torch.workload``): ``--workload PRESET``
generates the arrival stream from a preset (``--requests`` events, root
seed ``--workload-seed``; byte-identical to the JAX launcher's),
``--trace-record PATH`` saves whatever stream is served as a trace, and
``--trace PATH`` replays one. Every stream prints its KV-write pressure:

  python -m repro_torch.launch.serve --workload bursty --requests 12 \
      --workload-seed 7 --trace-record stream.jsonl
  python -m repro_torch.launch.serve --trace stream.jsonl   # same report

``--soft-error-ber`` turns on the post-write radiation-upset hook (the
hardened driver protects sign and exponent unless
``--soft-error-unhardened``); the report adds a soft-error line.
``--prefix-cache`` links matched prompt prefixes (``--prefix-chunk``
tokens a digest, ``--prefix-table-size`` CAM entries) to resident KV
columns instead of writing them, and ``--shared-prefix N`` gives the
synthetic prompts one common N-token head (numpy, seed 1234) for it to
hit; the report adds the prefix ledger.

``--retention-scale`` (seconds of modelled dwell per decode step) turns
on retention decay at ``--ambient-k`` kelvin; ``--scrub-policy`` runs
background scrub passes between bursts (whole leaves, or windows of
``--scrub-cols`` ring columns) and implies ``--retention-scale 1000``
when that is left at 0. The report then ends with the lifetime ledger.

``--wear-policy rotate`` turns on the physical addressing layer and wear
leveling (continuous mode): every ``--wear-check-interval`` steps the
scheduler reads the row-group wear of ``--remap-group-cols`` ring
columns and rotates the column map by one group once the hottest group
has gained ``--hot-row-wear``. ``--endurance-budget N`` makes groups
that reach N writes and scrubs stuck-at. The report adds the kv_remap
stream and the wear-leveling line:

  python -m repro_torch.launch.serve --wear-policy rotate \
      --remap-group-cols 4 --wear-check-interval 2 --hot-row-wear 2

``--shards N`` splits the slot pool over N dies (``--capacity`` must
divide evenly); any N is bit-identical to one die until ``--die-ambient
DIE=KELVIN`` (repeatable) heats a die: its slots then decay at its
temperature, it gets an extra die-masked scrub pass per pass, and
HIGH-quality admissions steer away from it. The report adds a
``sharding:`` section with a ledger line per die.

``--metrics-out PATH`` (Prometheus text, or annotated JSON when PATH
ends in ``.json``) and ``--trace-timeline PATH`` (Chrome trace-event
JSON, for Perfetto; ``python -m repro_torch.telemetry PATH`` validates
it) turn telemetry on; off, the run writes no file and is unchanged:

  python -m repro_torch.launch.serve --capacity 4 --shards 2 \
      --die-ambient 1=420 --retention-scale 1000 --scrub-policy periodic \
      --metrics-out metrics.prom --trace-timeline timeline.json
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device
from repro_torch.memory import available_backends
from repro_torch.reliability import make_scrub_policy, make_wear_policy
from repro_torch.serve import (ContinuousScheduler, ServeConfig,
                               ServingEngine, synthetic_requests)
from repro_torch.serve.scheduler import AUDIO_REFUSAL, modal_leaves
from repro_torch.telemetry import (Telemetry, render_report, write_metrics,
                                   write_timeline)
from repro_torch import rng
from repro_torch.workload import (TraceSource, load_trace, make_workload,
                                  pressure_score, record_requests,
                                  save_trace)


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
    ap.add_argument("--workload", default=None, metavar="PRESET",
                    help="generate the arrival stream from a workload "
                         "preset (steady, diurnal, bursty, heavy_tail, "
                         "chat_batch, shared_system_prompt)")
    ap.add_argument("--workload-seed", type=int, default=0,
                    help="root seed of --workload (a (preset, seed) pair "
                         "is the trace)")
    ap.add_argument("--trace-record", default=None, metavar="PATH",
                    help="record the served arrival stream as a "
                         "replayable trace file")
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
    ap.add_argument("--soft-error-ber", type=float, default=0.0,
                    help="post-write radiation upsets per stored bit")
    ap.add_argument("--soft-error-unhardened", action="store_true",
                    help="let upsets strike sign/exponent bits too")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="link matched prompt prefixes to resident KV "
                         "columns instead of writing them")
    ap.add_argument("--prefix-chunk", type=int, default=8,
                    help="prompt tokens per prefix digest")
    ap.add_argument("--prefix-table-size", type=int, default=256,
                    help="prefix CAM entries")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="leading prompt tokens shared by every synthetic "
                         "request")
    ap.add_argument("--wear-policy", default="none",
                    choices=("none", "rotate"),
                    help="wear leveling over the logical -> physical "
                         "column map (continuous mode): 'rotate' rotates "
                         "it when hot-row wear concentrates, paying a "
                         "migration write (the remap energy)")
    ap.add_argument("--endurance-budget", type=int, default=0,
                    help="writes+scrubs a physical row group survives "
                         "before going stuck-at (0 = unbounded)")
    ap.add_argument("--remap-group-cols", type=int, default=8,
                    help="ring columns per physical row group (the wear "
                         "and failure granularity)")
    ap.add_argument("--wear-check-interval", type=int, default=8,
                    help="decode steps between device wear reads")
    ap.add_argument("--hot-row-wear", type=int, default=16,
                    help="max-group wear since the last rotation that "
                         "arms the next one")
    ap.add_argument("--shards", type=int, default=1,
                    help="STT-RAM dies the slot pool is split over "
                         "(capacity must divide evenly; bit-identical to "
                         "1 until a die's state diverges)")
    ap.add_argument("--die-ambient", action="append", default=[],
                    metavar="DIE=KELVIN",
                    help="one die's ambient temperature (repeats), e.g. "
                         "--die-ambient 1=400")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write end-of-run metrics (Prometheus text, or "
                         "annotated JSON when PATH ends in .json); turns "
                         "telemetry on")
    ap.add_argument("--trace-timeline", default=None, metavar="PATH",
                    help="write the per-request span timeline as Chrome "
                         "trace-event JSON; turns telemetry on")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    telemetry = (Telemetry() if args.metrics_out or args.trace_timeline
                 else None)

    def export_telemetry(snapshot) -> None:
        if args.metrics_out:
            print(f"metrics -> {write_metrics(snapshot, args.metrics_out)}")
        if args.trace_timeline:
            p = write_timeline(snapshot, args.trace_timeline)
            print(f"timeline -> {p} (open in https://ui.perfetto.dev "
                  f"or chrome://tracing)")

    retention_scale = args.retention_scale
    if args.scrub_policy != "none" and retention_scale == 0.0:
        retention_scale = 1000.0  # scrubbing without decay is a no-op

    def serve_cfg(max_seq: int, new_tokens: int) -> ServeConfig:
        return ServeConfig(max_seq=max_seq, max_new_tokens=new_tokens,
                           extent_enabled=not args.no_extent,
                           backend=args.backend,
                           retention_scale=retention_scale,
                           ambient_k=args.ambient_k,
                           soft_error_ber=args.soft_error_ber,
                           soft_error_hardened=not args.soft_error_unhardened,
                           prefix_cache=args.prefix_cache,
                           prefix_chunk=args.prefix_chunk,
                           prefix_table_size=args.prefix_table_size,
                           wear_policy=args.wear_policy,
                           endurance_budget=args.endurance_budget,
                           remap_group_cols=args.remap_group_cols,
                           shards=args.shards)

    soft = dict(soft_error_ber=args.soft_error_ber,
                soft_error_hardened=not args.soft_error_unhardened)

    def tokens(seed: int, shape) -> torch.Tensor:
        toks = rng.randint(rng.PRNGKey(seed), shape, 0, cfg.vocab_size)
        return torch.from_numpy(toks.astype(np.int64)).to(device)

    # the vlm's image columns lead every prompt in the cache
    vlm_extra = cfg.num_image_tokens if cfg.family == "vlm" else 0
    if args.monolithic:
        eng = ServingEngine(cfg, serve_cfg(
            args.prompt_len + args.new_tokens + vlm_extra, args.new_tokens),
            device=device)
        prompt = {"tokens": tokens(0, (args.batch, args.prompt_len)),
                  **modal_leaves(cfg, 1, device, batch=args.batch)}
        out, report = eng.generate(prompt, telemetry=telemetry)
        print(f"generated {tuple(out.shape)} tokens; first row: "
              f"{out[0, :8].tolist()}...")
        if not args.no_extent:
            tot = report["total"]
            print(f"KV write energy {tot['energy_pj'] / 1e6:.3f} uJ "
                  f"(backend={eng.backend}), "
                  f"skip-rate {tot['write_skip_rate']:.3f}, "
                  f"BER {tot['ber_realized']:.2e}")
            if args.soft_error_ber > 0:
                hardened = not args.soft_error_unhardened
                print(f"soft errors: {tot['soft_strikes']} strikes at "
                      f"BER {args.soft_error_ber:.1e} "
                      f"({'hardened' if hardened else 'unhardened'} "
                      f"driver)")
        if telemetry is not None:
            export_telemetry(telemetry.snapshot())
        return

    # continuous batching over an arrival stream: a replayed trace, a
    # generated workload preset, or the synthetic default
    if args.trace and args.workload:
        ap.error("--trace and --workload are mutually exclusive")
    if cfg.family == "audio":
        ap.error(AUDIO_REFUSAL)
    trace = None
    if args.trace:
        trace = load_trace(args.trace)
        stream_desc = f"trace {args.trace}"
    elif args.workload:
        trace = make_workload(args.workload, cfg, args.requests,
                              seed=args.workload_seed)
        stream_desc = (f"workload {args.workload} "
                       f"(seed {args.workload_seed})")
    else:
        stream_desc = "synthetic"
    if trace is not None:
        eng = ServingEngine(cfg, serve_cfg(trace.max_seq() + vlm_extra,
                                           trace.max_new_tokens()),
                            device=device)
        reqs = TraceSource(trace, cfg, device)
    else:
        eng = ServingEngine(cfg, serve_cfg(
            args.prompt_len + args.new_tokens + vlm_extra, args.new_tokens),
            device=device)
        apps = [a for a in args.apps.split(",") if a] or [None]
        reqs = synthetic_requests(
            cfg, args.requests, device=device, prompt_len=args.prompt_len,
            new_tokens=args.new_tokens, arrival_every=args.arrival_every,
            app_ids=apps)
        if args.shared_prefix > 0:
            # one common system prompt over every prompt's head: the
            # cross-request overlap the prefix cache exists to exploit
            shared = tokens(1234, (1, args.shared_prefix))
            for r in reqs:
                r.prompt["tokens"] = torch.cat(
                    [shared, r.prompt["tokens"][:, args.shared_prefix:]],
                    dim=1)
    # every stream is recordable and scorable: the synthetic one is read
    # back into a trace (one host read per request, before serving)
    rec = trace if trace is not None else record_requests(
        reqs, cfg, meta={"source": "synthetic",
                         "arrival_every": args.arrival_every})
    if args.trace_record:
        save_trace(rec, args.trace_record)
        print(f"recorded trace -> {args.trace_record} "
              f"({len(rec.events)} events)")
    print(f"workload: {stream_desc}, {len(rec.events)} events, "
          f"pressure={pressure_score(rec):.4f}")
    for spec in args.quality:
        app, _, level = spec.partition("=")
        eng.controller.tag("kv_request", app, Priority.coerce(level))
    scrub_policy = None
    if args.scrub_policy != "none":
        scrub_policy = make_scrub_policy(args.scrub_policy,
                                         interval=args.scrub_interval,
                                         cols_per_pass=args.scrub_cols)
    wear_policy = None
    if args.wear_policy != "none":
        # rotate by a whole row group: the hot columns hop to fresh
        # physical rows instead of shuffling inside one group
        wear_policy = make_wear_policy(
            args.wear_policy, check_interval=args.wear_check_interval,
            rotate_step=args.remap_group_cols,
            hot_row_wear=args.hot_row_wear)
    die_ambients = {}
    for spec in args.die_ambient:
        die, _, kelvin = spec.partition("=")
        die_ambients[int(die)] = float(kelvin)
    report = ContinuousScheduler(eng, capacity=args.capacity,
                                 scrub_policy=scrub_policy,
                                 wear_policy=wear_policy,
                                 telemetry=telemetry,
                                 die_ambients=die_ambients).run(reqs)
    for line in render_report(report, backend=eng.backend,
                              show_extent=not args.no_extent, **soft):
        print(line)
    if telemetry is not None:
        export_telemetry(report["telemetry"])


if __name__ == "__main__":
    main()
