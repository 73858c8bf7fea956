"""Telemetry overhead: the observability tax, measured and bounded (the
counterpart of ``benchmarks/telemetry_overhead.py``).

Two arms over the SAME engine and the SAME arrival stream — telemetry off
and telemetry on (per-event instrument drains, per-request span tree,
device scalars landed once at finalize). One engine serves both, a
warm-up pass per arm absorbs first-call costs, then the arms alternate
for ``repeats`` timed runs and the headline compares best-of-N wall time.

``_arms`` serves the two arms and returns their reports and every timed
run's seconds (what the tests hold against the reference, with no timed
run); ``measure`` makes the result and its claims; ``run`` asserts them
(``check``); ``TIMED_CLAIMS`` are the ones that compare wall-clock:

* **bit-exactness** — telemetry only reads the device accumulators, so
  every token stream and the whole total ledger are identical across
  arms;
* **<5% wall overhead** — the recurring cost is one drain per scheduler
  event (audited: ``drains_per_event == 1.0``) plus host-side span
  bookkeeping, bounded at 5% of the telemetry-off wall time.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.serve import (ContinuousScheduler, ServeConfig, ServingEngine,
                               synthetic_requests)
from repro_torch.telemetry import Telemetry

#: total-ledger keys compared across arms (the WriteStats ground truth)
TOTAL_KEYS = ("energy_pj", "bits_written", "bit_errors", "bits_total")
#: the claims that compare host wall-clock
TIMED_CLAIMS = ("overhead_lt_5pct",)


def _arms(n: int = 10, prompt_len: int = 8, new_tokens: int = 10,
          capacity: int = 2, repeats: int = 0, device=None) -> Dict:
    """Serve the two arms over one engine and one stream: a warm-up run
    each (which absorbs first-call costs), then ``repeats`` timed runs
    alternating off/on with the GC held off. Returns the last reports of
    each arm and every timed run's seconds."""
    dev = resolve_device(device)
    cfg = get_config("qwen2.5-3b").reduced()
    eng = ServingEngine(cfg, ServeConfig(max_seq=32,
                                         max_new_tokens=new_tokens + 2),
                        device=dev)
    reqs = synthetic_requests(cfg, n, device=dev, prompt_len=prompt_len,
                              new_tokens=new_tokens, arrival_every=2,
                              seed=11)

    def arm(tele):
        rep = ContinuousScheduler(eng, capacity=capacity,
                                  telemetry=tele).run(list(reqs))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return rep

    out = {"off": arm(None), "on": arm(Telemetry()), "sec_off": [],
           "sec_on": [],
           "workload": {"n": n, "prompt_len": prompt_len,
                        "new_tokens": new_tokens, "capacity": capacity,
                        "repeats": repeats}}
    # timeit-style GC hygiene: a collection triggered by one arm's
    # allocations would otherwise be billed to whichever window it
    # lands in
    for _ in range(repeats):
        gc.collect()
        gc.disable()
        try:
            for name, tele in (("off", None), ("on", Telemetry)):
                t0 = time.perf_counter()
                out[name] = arm(tele and tele())
                out[f"sec_{name}"].append(time.perf_counter() - t0)
        finally:
            gc.enable()
    return out


def measure(n: int = 10, prompt_len: int = 8, new_tokens: int = 10,
            capacity: int = 2, repeats: int = 6, device=None) -> Dict:
    """The arms served and timed (``_arms``): best-of-N seconds (and every
    timed run's), the overhead and the claims, not asserted."""
    arms = _arms(n, prompt_len, new_tokens, capacity, repeats, device)
    rep_off, rep_on = arms["off"], arms["on"]
    bit_exact_tokens = all(
        rep_off["requests"][r]["tokens"] == rep_on["requests"][r]["tokens"]
        for r in rep_off["requests"])
    total_delta = {k: abs(rep_on["total"][k] - rep_off["total"][k])
                   for k in TOTAL_KEYS}
    best_off, best_on = min(arms["sec_off"]), min(arms["sec_on"])
    overhead_frac = (best_on - best_off) / best_off
    t = rep_on["telemetry"]
    return {
        "workload": arms["workload"],
        "sec_off": arms["sec_off"],
        "sec_on": arms["sec_on"],
        "sec_off_best": best_off,
        "sec_on_best": best_on,
        "overhead_frac": overhead_frac,
        "telemetry": {"events": t["events"], "spans": t["spans"],
                      "drains_per_event": t["drains_per_event"]},
        "total_delta": total_delta,
        "claims": {
            "bit_exact_tokens": bit_exact_tokens,
            "bit_exact_total_ledger": all(v == 0.0
                                          for v in total_delta.values()),
            "overhead_lt_5pct": overhead_frac < 0.05,
            "one_drain_per_event": t["drains_per_event"] == 1.0,
        },
    }


def check(out: Dict) -> Dict:
    for name, ok in out["claims"].items():
        assert ok, (name, out)
    return out


def run(n: int = 10, prompt_len: int = 8, new_tokens: int = 10,
        capacity: int = 2, repeats: int = 6, device=None):
    return check(measure(n, prompt_len, new_tokens, capacity, repeats,
                         device))


def bench_metrics(out) -> dict:
    return {
        "overhead_frac": out["overhead_frac"],
        "sec_off_best": out["sec_off_best"],
        "sec_on_best": out["sec_on_best"],
        "telemetry_events": float(out["telemetry"]["events"]),
        "telemetry_spans": float(out["telemetry"]["spans"]),
        "drains_per_event": out["telemetry"]["drains_per_event"],
    }
