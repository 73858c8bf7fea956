"""Shard scaling: one logical STT-RAM pool across 1/2/4 simulated dies
(the counterpart of ``benchmarks/shard_scaling.py``).

Two claims, one benchmark:

  * **Bit-identity** — the extent-write RNG hashes flat logical lane
    indices, so the die count is a pure layout choice: the SAME arrival
    stream served at ``shards`` 1, 2 and 4 must produce equal ledgers
    (energy, flips, errors, bits) and identical per-request tokens.
    Asserted exactly.
  * **Scaling** — the decode burst is one loop with zero cross-die
    transfers, so D dies decode their slot sub-batches concurrently and
    the pool-wide burst takes the slowest die's shard-local time.
    Measured as the burst's wall-clock at per-die batch B/D: tokens/s
    must rise monotonically 1 -> 4 dies. The reference times its
    compiled burst (one ``lax.scan`` executable); on the card the port
    times the burst captured once as a CUDA graph and replayed, its
    counterpart: the eager loop spends ~5 ms of host dispatch a step on
    ~0.7 ms of kernels at these sizes, whatever the batch, so its
    wall-clock shows the host, not the dies (reported beside it as
    ``tokens_per_s_eager``). The dies' bursts are timed in turns, best
    of ``repeats``; on the CPU the eager loop is timed.

Locality (``burst_collective_free``): one burst runs under
``torch.profiler``; on the card the trace must hold no kernel whose name
contains ``nccl`` and no peer-to-peer copy, on the CPU no ``c10d`` or
collective op. Per-die write energy comes from the sharded serve
report's ``sharding`` section.

``_arms`` serves the stream at each die count and returns the reports
(what the tests hold against the reference); ``measure`` adds the timing
and the locality profile and makes the claims; ``run`` asserts them
(``check``); ``TIMED_CLAIMS`` are the ones that compare wall-clock.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from repro_torch import rng
from repro_torch.benchmarks import arg_parser
from repro_torch.configs import get_config
from repro_torch.core.energy_model import zero_slot_stats
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device
from repro_torch.memory import WriteStats
from repro_torch.serve import (ContinuousScheduler, Request, ServeConfig,
                               ServingEngine)

#: the claims that compare wall-clock
TIMED_CLAIMS = ("throughput_monotone_1_to_4",)
#: profiler event names that would mean cross-die traffic inside the
#: decode burst (lower case): collective kernels and peer copies on the
#: card, process-group ops on the CPU
_COLLECTIVES = ("nccl", "c10d", "all_reduce", "allreduce", "all_gather",
                "allgather", "reduce_scatter", "all_to_all", "alltoall",
                "memcpy ptop")


def _requests(cfg, n: int, *, prompt_len: int, new_tokens: int,
              arrival_every: int, device, seed: int = 11):
    out = []
    for i in range(n):
        toks = rng.randint(rng.PRNGKey(seed + 13 * i), (1, prompt_len), 0,
                           cfg.vocab_size)
        out.append(Request(
            rid=i, prompt={"tokens": torch.from_numpy(
                toks.astype(np.int64)).to(device)},
            new_tokens=new_tokens + (i * i) % 3,
            arrival=i * arrival_every))
    return out


def _serve(shards: int, *, n: int, prompt_len: int, new_tokens: int,
           capacity: int, arrival_every: int, device):
    cfg = get_config("qwen2.5-3b").reduced()
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=prompt_len + new_tokens + 8,
        max_new_tokens=new_tokens + 4, shards=shards), device=device)
    reqs = _requests(cfg, n, prompt_len=prompt_len, new_tokens=new_tokens,
                     arrival_every=arrival_every, device=device)
    return ContinuousScheduler(eng, capacity=capacity).run(reqs)


def _ledger(rep) -> dict:
    tot = rep["total"]
    return {k: tot[k] for k in ("energy_pj", "bits_written", "bit_errors",
                                "bits_total")}


def _tokens(rep) -> dict:
    return {r: list(rep["requests"][r]["tokens"]) for r in rep["requests"]}


def _burst_args(eng, B: int):
    """Operands of one plain decode burst at slot batch ``B`` — what a
    single die carries when the pool is split D ways."""
    dev = eng.device
    cache = eng.api.init_cache(B, eng.scfg.max_seq, dev)
    return (eng.params, torch.zeros((B,), dtype=torch.int64, device=dev),
            cache, torch.full((B,), 4, dtype=torch.int64, device=dev),
            rng.PRNGKey(0), WriteStats.zero(dev), zero_slot_stats(B, dev),
            torch.ones((B,), dtype=torch.bool, device=dev),
            eng.vectors_for_floor(Priority.LOW))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _captured_burst(eng, args, steps: int):
    """The burst on ``args`` captured once as a CUDA graph: its replay
    runs the same kernels on the same operands (the same key, so the
    same seeds) as an eager call, without the host's dispatch."""
    dev = eng.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        eng.burst(*args, n=steps)  # warm-up off the capturing stream
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eng.burst(*args, n=steps)
    return graph.replay


def _time_bursts(eng, batches, steps: int, repeats: int, *,
                 captured: bool) -> dict:
    """{B: least wall-clock seconds of the burst at batch B}, the batches
    timed in turns after a warm-up each; ``captured``: graph replays
    (CUDA only; three warm replays, so the card's clocks settle), else
    eager calls."""
    runs = {}
    for B in batches:
        args = _burst_args(eng, B)
        runs[B] = (_captured_burst(eng, args, steps) if captured else
                   lambda a=args: eng.burst(*a, n=steps))
        for _ in range(3 if captured else 1):
            runs[B]()
    _sync(eng.device)
    best = {B: float("inf") for B in batches}
    for _ in range(repeats):
        for B in batches:
            t0 = time.perf_counter()
            runs[B]()
            _sync(eng.device)
            best[B] = min(best[B], time.perf_counter() - t0)
    return best


def burst_events(eng, B: int, steps: int) -> list:
    """Names of every event (host ops and device kernels and copies) one
    burst at batch ``B`` records under ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    args = _burst_args(eng, B)
    with torch.profiler.profile(activities=acts) as prof:
        eng.burst(*args, n=steps)
        _sync(eng.device)
    return sorted({e.name for e in prof.events()})


def collective_free(names) -> bool:
    """No event name of a collective or a peer-to-peer copy."""
    return not any(c in n.lower() for n in names for c in _COLLECTIVES)


def _arms(dies=(1, 2, 4), n: int = 8, prompt_len: int = 12,
          new_tokens: int = 5, capacity: int = 4, arrival_every: int = 2,
          device=None):
    """{dies: report} of the same stream served at each die count."""
    dev = resolve_device(device)
    return {d: _serve(d, n=n, prompt_len=prompt_len, new_tokens=new_tokens,
                      capacity=capacity, arrival_every=arrival_every,
                      device=dev) for d in dies}


def measure(dies=(1, 2, 4), n: int = 8, prompt_len: int = 12,
            new_tokens: int = 5, capacity: int = 4, arrival_every: int = 2,
            pool: int = 8, steps: int = 12, repeats: int = 3,
            device=None) -> dict:
    """The result and its claims, not asserted."""
    dev = resolve_device(device)
    kw = dict(n=n, prompt_len=prompt_len, new_tokens=new_tokens,
              capacity=capacity, arrival_every=arrival_every)

    # --- bit-identity: the same stream at every die count -------------
    reps = _arms(dies, device=dev, **kw)
    base = dies[0]
    ledgers = {d: _ledger(r) for d, r in reps.items()}
    tokens = {d: _tokens(r) for d, r in reps.items()}
    bit_identical = all(ledgers[d] == ledgers[base]
                        and tokens[d] == tokens[base] for d in dies)

    per_die_energy = {
        d: [die["energy_pj"] for die in reps[d]["sharding"]["dies"]]
        for d in dies if d > 1}

    # --- scaling: per-die burst time at batch pool/D ------------------
    cfg = get_config("qwen2.5-3b").reduced()
    eng = ServingEngine(cfg, ServeConfig(max_seq=32, max_new_tokens=8),
                        device=dev)
    assert all(pool % d == 0 for d in dies), (pool, dies)
    batches = [pool // d for d in dies]
    t_eager = _time_bursts(eng, batches, steps, repeats, captured=False)
    t = (_time_bursts(eng, batches, steps, repeats, captured=True)
         if dev.type == "cuda" else t_eager)
    tps = {d: pool * steps / t[pool // d] for d in dies}

    # --- locality: the burst records no collective and no peer copy ---
    is_local = collective_free(burst_events(eng, pool, steps))

    out = {
        "workload": {**kw, "dies": list(dies), "pool": pool,
                     "steps": steps},
        "ledger": ledgers[base],
        "per_die_energy_pj": per_die_energy,
        "burst_timing": "cuda graph replay" if dev.type == "cuda"
        else "eager",
        "tokens_per_s": {str(d): tps[d] for d in dies},
        "tokens_per_s_eager": {str(d): pool * steps / t_eager[pool // d]
                               for d in dies},
        "speedup_vs_1die": {str(d): tps[d] / tps[dies[0]] for d in dies},
        "claims": {
            "bit_identical_across_dies": bit_identical,
            "throughput_monotone_1_to_4": all(
                tps[b] >= tps[a] for a, b in zip(dies, dies[1:])),
            "burst_collective_free": is_local,
        },
    }
    return out


def check(out: dict) -> dict:
    for name, ok in out["claims"].items():
        assert ok, (name, out)
    return out


def run(dies=(1, 2, 4), n: int = 8, prompt_len: int = 12,
        new_tokens: int = 5, capacity: int = 4, arrival_every: int = 2,
        pool: int = 8, steps: int = 12, repeats: int = 3, device=None):
    return check(measure(dies, n, prompt_len, new_tokens, capacity,
                         arrival_every, pool, steps, repeats, device))


def bench_metrics(out) -> dict:
    tps = out["tokens_per_s"]
    m = {f"tokens_per_s_{d}die": v for d, v in tps.items()}
    m.update({f"speedup_{d}die": v
              for d, v in out["speedup_vs_1die"].items()})
    m["total_energy_pj"] = out["ledger"]["energy_pj"]
    m.update({k: v for k, v in out["claims"].items()})
    return m


def parser():
    return arg_parser(__doc__, fast=True)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    res = run(n=6 if args.fast else 8, repeats=2 if args.fast else 3,
              device=args.device)
    print(json.dumps(res, indent=2, default=float))


if __name__ == "__main__":
    main()
