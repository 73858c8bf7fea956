"""Serving example: batched generation with EXTENT-approximate KV writes.

  PYTHONPATH=src python -m repro_torch.examples.serve_approx_kv \
      [--arch qwen2.5-3b] [--device cuda|cpu]

Serves a reduced-config model with the port's engine, comparing exact
against approximate KV storage: token agreement, realized write-energy
savings against the basic (non-approximate) STT-RAM cell, and the CMP
skip rate — then replays the same traffic as a staggered arrival stream
through the continuous-batching slot pool, with one request negotiating
a HIGH quality floor through the EXTENT-table handshake (per-request
energy/BER attribution in the serve report).

``--backend`` selects the write path from the ``repro_torch.memory``
registry; it defaults to the device's: ``cuda`` (the kernel) on the
card, ``lanes_ref`` (its twin) on the CPU; ``oracle`` is the eager
bit-unpacked reference.
"""
import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.core.energy_model import exact_baseline_energy_pj
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device
from repro_torch.memory import default_backend
from repro_torch.serve import (ContinuousScheduler, ServeConfig, ServingEngine,
                               synthetic_requests)


def batch_prompt(cfg, batch: int, prompt_len: int, device) -> dict:
    """The reference example's prompt: ``randint(PRNGKey(0), ...)``
    tokens, and ``normal(PRNGKey(1), ...)`` image embeddings or frames."""
    toks = rng.randint(rng.PRNGKey(0), (batch, prompt_len), 0,
                       cfg.vocab_size)
    prompt = {"tokens": torch.from_numpy(toks.astype(np.int64)).to(device)}
    if cfg.family == "vlm":
        shape = (batch, cfg.num_image_tokens, cfg.vision_dim)
        prompt["image_embeds"] = torch.from_numpy(
            rng.normal(rng.PRNGKey(1), shape)).to(device)
    if cfg.family == "audio":
        prompt["frames"] = torch.from_numpy(
            rng.normal(rng.PRNGKey(1), (batch, 24, cfg.d_model))).to(device)
    return prompt


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--backend", default=None,
                    help="repro_torch.memory write-path backend name "
                         "(default: the device's)")
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                    "cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    backend = args.backend or default_backend(dev)

    cfg = get_config(args.arch).reduced()
    prompt = batch_prompt(cfg, args.batch, args.prompt_len, dev)
    max_seq = args.prompt_len + args.new_tokens + (
        cfg.num_image_tokens if cfg.family == "vlm" else 0)

    eng_x = ServingEngine(cfg, ServeConfig(max_seq=max_seq,
                                           max_new_tokens=args.new_tokens,
                                           extent_enabled=False),
                          device=dev)
    toks_x, _ = eng_x.generate(prompt)

    eng_a = ServingEngine(cfg, ServeConfig(max_seq=max_seq,
                                           max_new_tokens=args.new_tokens,
                                           extent_enabled=True,
                                           backend=backend), device=dev)
    toks_a, report = eng_a.generate(prompt)

    agree = float((toks_x == toks_a).float().mean())
    tot = report["total"]
    baseline = exact_baseline_energy_pj(tot["bits_total"])
    print(f"arch={cfg.name}  batch={args.batch}  "
          f"new_tokens={args.new_tokens}  backend={backend}")
    print(f"token agreement (extent vs exact): {agree:.3f}")
    print(f"KV write energy: {tot['energy_pj']/1e6:.3f} uJ "
          f"(basic cell would pay {baseline/1e6:.3f} uJ -> "
          f"{100*(1-tot['energy_pj']/max(baseline,1e-9)):.1f}% saved)")
    print(f"CMP write-skip rate: {tot['write_skip_rate']:.3f}")
    print(f"realized KV bit-error rate: {tot['ber_realized']:.2e}")
    for stream, s in report["streams"].items():
        print(f"  {stream:12s} E={s['energy_pj']/1e6:.3f} uJ "
              f"errors={s['bit_errors']}")

    # ----- continuous batching: staggered arrivals through the slot pool,
    # one application negotiating HIGH quality via the EXTENT table
    print("\n-- continuous batching (slot pool, staggered arrivals) --")
    eng_c = ServingEngine(cfg, ServeConfig(max_seq=max_seq,
                                           max_new_tokens=args.new_tokens,
                                           extent_enabled=True,
                                           backend=backend), device=dev)
    reqs = synthetic_requests(
        cfg, args.batch + 2, device=dev, prompt_len=args.prompt_len,
        new_tokens=args.new_tokens,
        arrival_every=max(2, args.new_tokens // 4),
        app_ids=["chat", "legal", "chat"],
        qualities=[None, Priority.HIGH, None])
    rep = ContinuousScheduler(eng_c, capacity=args.batch).run(reqs)
    print(f"{len(rep['requests'])} requests, {rep['clock_steps']} steps, "
          f"{rep['bursts']} decode bursts, peak occupancy "
          f"{rep['pool']['peak_occupancy']}/{rep['pool']['capacity']}")
    for rid in sorted(rep["requests"]):
        r = rep["requests"][rid]
        print(f"  req {rid} app={str(r['app_id']):6s} q={r['quality']:5s} "
              f"queued {r['queue_steps']:2d} latency {r['latency_steps']:3d} "
              f"E={r['energy_pj']/1e3:7.1f} nJ BER={r['ber']:.2e}")
    tbl = rep["extent_table"]
    print(f"EXTENT table: {tbl['hits']} hits / {tbl['misses']} misses "
          f"(hit rate {tbl['hit_rate']:.2f})")


if __name__ == "__main__":
    main()
