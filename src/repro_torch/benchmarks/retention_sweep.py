"""Quality against temperature against scrub interval (the counterpart of
``benchmarks/retention_sweep.py``).

A bf16 KV-like region (K at MID, V at LOW: the serving policy) lives
through a synthetic epoch: written once, then per step it dwells
``dwell_s`` at the ambient temperature (``MemoryRegion.age``) and is
scrubbed every ``scrub_interval`` steps (0: never). Swept over ambient x
interval, each cell reports write, scrub and lifetime energy (pJ), the
retention flips sampled, the bits still decayed at the end, and the V
leaf's mean relative error against the golden copy.

The data are ``normal(fold_in(PRNGKey(0), 1 | 2))`` drawn on the host
(bit-exact with ``jax.random.normal``) and moved to the device, and the
keys are the reference's, so every count equals the reference's.
"""
from __future__ import annotations

import json
from typing import Dict

import torch

from repro_torch import rng
from repro_torch.benchmarks import arg_parser
from repro_torch.core.priority import Priority, path_contains
from repro_torch.device import resolve_device
from repro_torch.memory import MemoryRegion, default_backend


def _policy(path, leaf):
    if path_contains(path, "'v'"):
        return Priority.LOW
    if path_contains(path, "'k'"):
        return Priority.MID
    return Priority.EXACT


def _one_cell(temp_k: float, scrub_interval: int, *, steps: int,
              dwell_s: float, shape, backend: str,
              device: torch.device) -> Dict[str, float]:
    k0 = rng.PRNGKey(0)

    def draw(i):
        return torch.from_numpy(rng.normal(rng.fold_in(k0, i), shape)).to(
            torch.bfloat16).to(device)

    golden = {"kv": {"k": draw(1), "v": draw(2)}}
    region = MemoryRegion.create(
        {"kv": {k: torch.zeros_like(v) for k, v in golden["kv"].items()}},
        policy=_policy, backend=backend, ambient_k=temp_k,
        retention_scale=dwell_s)
    region = region.write(rng.fold_in(k0, 3), golden)
    for step in range(steps):
        region = region.age(rng.fold_in(k0, 100 + step))
        if scrub_interval and (step + 1) % scrub_interval == 0:
            region = region.scrub(rng.fold_in(k0, 200 + step))
    rep = region.report()
    v = region.read()["kv"]["v"].to(torch.float32)
    g = golden["kv"]["v"].to(torch.float32)
    rel = float(torch.mean(torch.abs(v - g)) / torch.mean(torch.abs(g)))
    return {
        "write_energy_pj": rep["energy_pj"],
        "scrub_energy_pj": rep.get("scrub_energy_pj", 0.0),
        "lifetime_energy_pj": rep.get("lifetime_energy_pj",
                                      rep["energy_pj"]),
        "retention_flips": rep.get("retention_flips", 0),
        "residual_decayed_bits": rep.get("residual_decayed_bits", 0),
        "v_rel_err": rel,
    }


def run(temps=(300.0, 350.0, 400.0), intervals=(0, 8, 2),
        steps: int = 16, dwell_s: float = 1000.0, shape=(64, 128),
        backend=None, device=None) -> Dict:
    """The frontier over ``temps`` x ``intervals``. ``backend`` defaults
    to the device's (``cuda`` on the card, ``lanes_ref`` on the CPU)."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    out = {"steps": steps, "dwell_s_per_step": dwell_s, "cells": {}}
    for t in temps:
        for iv in intervals:
            out["cells"][f"{int(t)}K/scrub={iv or 'never'}"] = _one_cell(
                t, iv, steps=steps, dwell_s=dwell_s, shape=shape,
                backend=backend, device=dev)
    c = out["cells"]
    cold = c["300K/scrub=never"]
    hot = c["400K/scrub=never"]
    hot_scrubbed = c["400K/scrub=2"]
    out["claims"] = {
        # cold, high Delta: bit-stable by construction (the clamp)
        "cold_never_decays": cold["retention_flips"] == 0,
        # a hotter die left unscrubbed rots measurably
        "hot_rots_unscrubbed": hot["retention_flips"] > 0
        and hot["v_rel_err"] > cold["v_rel_err"],
        # scrubbing buys the quality back ...
        "scrub_restores_quality":
            hot_scrubbed["v_rel_err"] < hot["v_rel_err"],
        # ... and the ledger shows what it cost
        "scrub_costs_energy": hot_scrubbed["lifetime_energy_pj"]
        > hot_scrubbed["write_energy_pj"],
    }
    return out


def bench_metrics(out) -> Dict[str, float]:
    """Flat energy, flip and quality metrics per cell, and the claims."""
    m = {}
    for cell, d in out["cells"].items():
        tag = cell.replace("/", "_").replace("=", "_")
        m[f"{tag}_lifetime_energy_pj"] = d["lifetime_energy_pj"]
        m[f"{tag}_retention_flips"] = d["retention_flips"]
        m[f"{tag}_v_rel_err"] = d["v_rel_err"]
    m.update({f"claim_{k}": bool(v) for k, v in out["claims"].items()})
    return m


def parser():
    return arg_parser(__doc__)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    print(json.dumps(run(device=args.device), indent=1, default=float))


if __name__ == "__main__":
    main()
