"""KV-cache serving write energy, EXTENT against the exact basic cell,
across architecture families (the counterpart of
``benchmarks/serving_energy.py``), and the validations of the serving
stack:

  * **wall-clock (fused vs eager)**: one fused decode burst (the column
    write inside every step, stats accumulated on the device) against
    the seed engine's eager loop (``eager_extent_cache_write``: a
    whole-cache oracle write per token, its stats read to the host leaf
    by leaf);
  * **parity (fused vs eager)**: both write paths on the identical
    sequence of (old, new) cache pairs. Flips and energy do not depend
    on the RNG, so flips are equal and energies agree to float32
    summation; realized errors agree within sampling noise (the oracle
    draws one uniform per (element, bit), the lanes hash);
  * **continuous vs sequential**: a staggered arrival stream through the
    slot-pool scheduler against one ``generate()`` per request;
  * **lockstep parity**: the same requests admitted as one full-pool
    group reproduce the monolithic batch's energy, flips and errors bit
    for bit.

On the card every write runs the ``extent_write`` kernel, the
recurrentgemma-2b arm's prefill the ``local_attention`` kernel (float32:
its CUDA-core route) and the int8 fidelity check the ``kv_quant`` kernel.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.benchmarks import arg_parser
from repro_torch.configs import get_config
from repro_torch.core.energy_model import (exact_baseline_energy_pj,
                                           zero_slot_stats)
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device
from repro_torch.kernels.kv_quant import kv_dequant, kv_quant_store
from repro_torch.memory import WriteStats
from repro_torch.serve import (ContinuousScheduler, ServeConfig, ServingEngine,
                               synthetic_requests)
from repro_torch.serve.engine import _tag_cache, eager_extent_cache_write


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prompt(cfg, device) -> dict:
    """The reference's (2, 12) prompt: ``randint(PRNGKey(0), ...)``."""
    toks = rng.randint(rng.PRNGKey(0), (2, 12), 0, cfg.vocab_size)
    return {"tokens": torch.from_numpy(toks.astype(np.int64)).to(device)}


def _raw_fns(eng: ServingEngine):
    """Prefill/decode WITHOUT the fused extent write — the seed engine's
    separate calls, for the eager baseline."""
    def prefill(p, b):
        return eng.api.prefill(p, b, eng.scfg.max_seq)

    def decode(p, t, c, pos):
        return eng.api.decode_step(p, t, c, pos, eng.scfg.max_seq)
    return prefill, decode


def _clone(tree):
    return T.tree_map(torch.clone, tree)


def _decode_pairs(eng: ServingEngine, prompt, n_steps: int):
    """The decode-time (old cache, new cache) write stream of an exact
    trajectory — the common input both write paths are scored on. Each
    old cache is a copy, so no decode step can alias it."""
    prefill, decode = _raw_fns(eng)
    logits, cache = prefill(eng.params, prompt)
    tok = torch.argmax(logits, dim=-1)
    B = prompt["tokens"].shape[0]
    pos = torch.full((B,), prompt["tokens"].shape[1], dtype=torch.int64,
                     device=eng.device)
    pairs = []
    for _ in range(n_steps):
        old = _clone(cache)
        logits, cache = decode(eng.params, tok, cache, pos)
        pairs.append((old, cache))
        tok = torch.argmax(logits, dim=-1)
        pos = pos + 1
    return pairs


def _eager_loop(eng: ServingEngine, decode, logits, cache, tags, pos,
                new_tokens: int):
    """The seed engine's decode-loop data path: a decode call, then an
    eager host-synced per-leaf approximate write every token. Prefill
    happens at the caller so timers cover only the loop."""
    key = rng.PRNGKey(eng.scfg.seed + 1)
    tok = torch.argmax(logits, dim=-1)
    agg = {"energy_pj": 0.0, "bits_written": 0, "bit_errors": 0,
           "bits_total": 0}
    for _ in range(new_tokens - 1):
        key, k1 = rng.split(key)
        old = _clone(cache)
        logits, new_cache = decode(eng.params, tok, cache, pos)
        cache, a = eager_extent_cache_write(k1, old, new_cache, tags)
        for k in agg:
            agg[k] += a[k]
        tok = torch.argmax(logits, dim=-1)
        pos = pos + 1
    _sync(eng.device)
    return agg


def compare_fused_vs_eager(arch: str = "qwen2.5-3b", new_tokens: int = 8,
                           device=None):
    """Wall-clock and stats parity of the fused burst against the eager
    oracle. Returns a dict with the speedup and relative stat errors."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    prompt = _prompt(cfg, dev)
    eng = ServingEngine(cfg, ServeConfig(max_seq=32,
                                         max_new_tokens=new_tokens),
                        device=dev)
    vectors = eng.vectors_for_floor(Priority.LOW)

    # -- wall-clock: warm both paths once, then time ONLY the decode
    # loops (new_tokens - 1 decode + write + sample steps on both sides)
    eng.generate(prompt)
    B = prompt["tokens"].shape[0]
    key = rng.PRNGKey(eng.scfg.seed + 1)
    tok, cache0, key, _ = eng.prefill(eng.params, prompt, None, key,
                                      vectors)
    pos0 = torch.full((B,), prompt["tokens"].shape[1], dtype=torch.int64,
                      device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    eng.burst(eng.params, tok, cache0, pos0, key, WriteStats.zero(dev),
              zero_slot_stats(B, dev), active, vectors, n=new_tokens - 1)
    _sync(dev)
    t_fused = time.perf_counter() - t0

    prefill, decode = _raw_fns(eng)
    logits_e, cache_e = prefill(eng.params, prompt)
    tags_e = _tag_cache(cache_e)
    pos_s = pos0.clone()
    _eager_loop(eng, decode, logits_e, cache_e, tags_e, pos_s,
                new_tokens=2)  # warm
    t0 = time.perf_counter()
    _eager_loop(eng, decode, logits_e, cache_e, tags_e, pos_s, new_tokens)
    t_eager = time.perf_counter() - t0

    # -- parity on an identical write stream
    pairs = _decode_pairs(eng, prompt, n_steps=new_tokens - 1)
    tags = _tag_cache(pairs[0][0])
    e_fused = e_eager = 0.0
    err_fused = err_eager = flips = flips_eager = 0
    for i, (old, new) in enumerate(pairs):
        k = rng.fold_in(rng.PRNGKey(42), i)
        _, st = eng.plan.write(k, old, new, vectors)
        h = st.host_dict()
        e_fused += h["energy_pj"]
        err_fused += h["bit_errors"]
        flips += h["bits_written"]
        _, agg = eager_extent_cache_write(k, old, new, tags)
        e_eager += agg["energy_pj"]
        err_eager += agg["bit_errors"]
        flips_eager += agg["bits_written"]

    return {
        "arch": arch,
        "decode_wallclock_fused_s": t_fused,
        "decode_wallclock_eager_s": t_eager,
        "speedup_x": round(t_eager / max(t_fused, 1e-9), 1),
        "energy_rel_err": abs(e_fused - e_eager) / max(e_eager, 1e-9),
        "ber_fused": err_fused / max(flips, 1),
        "ber_eager": err_eager / max(flips, 1),
        "errors_rel_err": (abs(err_fused - err_eager)
                           / max(err_eager, 1)),
        "flips_fused": flips,
        "flips_eager": flips_eager,
        "errors_fused": err_fused,
        "errors_eager": err_eager,
    }


# ---------------------------------------------------------------------------
# continuous batching: mixed arrivals + lockstep bit-parity
# ---------------------------------------------------------------------------

def continuous_vs_sequential(arch: str = "qwen2.5-3b", n_requests: int = 16,
                             capacity: int = 8, prompt_len: int = 10,
                             new_tokens: int = 32, arrival_every: int = 1,
                             reps: int = 3, device=None):
    """A staggered request stream through the slot-pool scheduler against
    one monolithic ``generate()`` per request (batch 1, arrival order).
    Both sides are warmed once, then timed best-of-``reps`` with the two
    paths interleaved. Reports decode throughput for both and the
    continuous/sequential ratio."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    max_seq = prompt_len + new_tokens + 2
    scfg = ServeConfig(max_seq=max_seq, max_new_tokens=new_tokens)
    reqs = synthetic_requests(cfg, n_requests, device=dev,
                              prompt_len=prompt_len, new_tokens=new_tokens,
                              arrival_every=arrival_every, seed=3)
    total_tokens = sum(r.new_tokens for r in reqs)

    eng_c = ServingEngine(cfg, scfg, device=dev)
    report = ContinuousScheduler(eng_c, capacity=capacity).run(reqs)
    eng_s = ServingEngine(cfg, scfg, device=dev)
    eng_s.generate(reqs[0].prompt, max_new_tokens=reqs[0].new_tokens)

    t_cont = t_seq = 1e9
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        report = ContinuousScheduler(eng_c, capacity=capacity).run(reqs)
        _sync(dev)
        t_cont = min(t_cont, time.perf_counter() - t0)
        # sequential: batch 1 per request, back to back (arrival gaps
        # ignored — the most favourable sequential timing)
        t0 = time.perf_counter()
        for r in reqs:
            eng_s.generate(r.prompt, max_new_tokens=r.new_tokens)
        _sync(dev)
        t_seq = min(t_seq, time.perf_counter() - t0)

    return {
        "arch": arch,
        "requests": n_requests,
        "capacity": capacity,
        "arrival_every_steps": arrival_every,
        "total_tokens": total_tokens,
        "continuous_s": t_cont,
        "sequential_s": t_seq,
        "continuous_tok_per_s": total_tokens / max(t_cont, 1e-9),
        "sequential_tok_per_s": total_tokens / max(t_seq, 1e-9),
        "throughput_ratio_x": t_seq / max(t_cont, 1e-9),
        "bursts": report["bursts"],
        "mean_latency_steps": sum(
            r["latency_steps"] for r in report["requests"].values())
        / n_requests,
        "extent_table": report["extent_table"],
    }


def lockstep_parity(arch: str = "qwen2.5-3b", batch: int = 2,
                    new_tokens: int = 6, device=None):
    """Continuous scheduler with pool == batch, all requests admitted at
    once, against the monolithic batch path — energy, flips and errors
    must agree bit for bit under the same RNG key."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    scfg = ServeConfig(max_seq=32, max_new_tokens=new_tokens)
    reqs = synthetic_requests(cfg, batch, device=dev, prompt_len=10,
                              new_tokens=new_tokens, arrival_every=0,
                              seed=5)
    batch_prompt = {k: torch.cat([r.prompt[k] for r in reqs], dim=0)
                    for k in reqs[0].prompt}

    _, rep_m = ServingEngine(cfg, scfg, device=dev).generate(batch_prompt)
    rep_c = ContinuousScheduler(ServingEngine(cfg, scfg, device=dev),
                                capacity=batch).run(reqs)

    keys = ("energy_pj", "bits_written", "bit_errors")
    return {
        "arch": arch,
        "monolithic": {k: rep_m["total"][k] for k in keys},
        "continuous": {k: rep_c["total"][k] for k in keys},
        "bit_exact": all(rep_m["total"][k] == rep_c["total"][k]
                         for k in keys),
        "extent_table_in_report": rep_c["extent_table"],
    }


def arch_energy(arch: str, new_tokens: int, device=None) -> dict:
    """One architecture's EXTENT write energy against the basic cell, and
    its token agreement with an exact (extent off) engine."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    prompt = _prompt(cfg, dev)
    eng = ServingEngine(cfg, ServeConfig(max_seq=32,
                                         max_new_tokens=new_tokens),
                        device=dev)
    toks_a, report = eng.generate(prompt)
    tot = report["total"]
    basic = exact_baseline_energy_pj(tot["bits_total"])
    eng_x = ServingEngine(cfg, ServeConfig(max_seq=32,
                                           max_new_tokens=new_tokens,
                                           extent_enabled=False),
                          device=dev)
    toks_x, _ = eng_x.generate(prompt)
    agree = float((toks_a == toks_x).float().mean())
    return {
        "extent_energy_pj": tot["energy_pj"],
        "basic_energy_pj": basic,
        "saving_vs_basic": 1 - tot["energy_pj"] / max(basic, 1e-9),
        "write_skip_rate": tot["write_skip_rate"],
        "ber_realized": tot["ber_realized"],
        "token_agreement_vs_exact": agree,
        "int8_bits_scale": 0.5,  # kv_quant halves stored payload bits
    }


def kv_quant_rel_err(device=None) -> float:
    """The int8 path's fidelity at MID on the reference's (64, 128) bf16
    draws: mean |dequant - kv| / mean |kv|."""
    dev = resolve_device(device)
    kv = torch.from_numpy(rng.normal(rng.PRNGKey(7), (64, 128))).to(
        torch.bfloat16).to(dev)
    q, s, _ = kv_quant_store(rng.PRNGKey(8), kv, level=Priority.MID)
    x = kv.float()
    return float((kv_dequant(q, s, out_dtype=torch.float32) - x).abs().mean()
                 / x.abs().mean())


def run(archs=("qwen2.5-3b", "recurrentgemma-2b"), new_tokens: int = 8,
        device=None):
    dev = resolve_device(device)
    out = {arch: arch_energy(arch, new_tokens, dev) for arch in archs}
    out["kv_quant_rel_err"] = kv_quant_rel_err(dev)
    out["fused_vs_eager"] = compare_fused_vs_eager(new_tokens=new_tokens,
                                                   device=dev)
    out["continuous_vs_sequential"] = continuous_vs_sequential(device=dev)
    out["lockstep_parity"] = lockstep_parity(device=dev)
    return out


def bench_metrics(out) -> dict:
    """Flat energy/latency/flip metrics for the runner's BENCH_<n>.json."""
    m = {}
    for arch, d in out.items():
        if not isinstance(d, dict) or "extent_energy_pj" not in d:
            continue
        m[f"{arch}_extent_energy_pj"] = d["extent_energy_pj"]
        m[f"{arch}_saving_vs_basic"] = d["saving_vs_basic"]
        m[f"{arch}_write_skip_rate"] = d["write_skip_rate"]
        m[f"{arch}_ber_realized"] = d["ber_realized"]
        m[f"{arch}_token_agreement"] = d["token_agreement_vs_exact"]
    fe = out["fused_vs_eager"]
    m["fused_speedup_x"] = fe["speedup_x"]
    m["fused_decode_wallclock_s"] = fe["decode_wallclock_fused_s"]
    m["fused_energy_rel_err"] = fe["energy_rel_err"]
    cs = out["continuous_vs_sequential"]
    m["continuous_tok_per_s"] = cs["continuous_tok_per_s"]
    m["sequential_tok_per_s"] = cs["sequential_tok_per_s"]
    m["continuous_throughput_ratio_x"] = cs["throughput_ratio_x"]
    m["lockstep_bit_exact"] = bool(out["lockstep_parity"]["bit_exact"])
    m["kv_quant_rel_err"] = out["kv_quant_rel_err"]
    return m


def parser():
    return arg_parser(__doc__)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    print(json.dumps(run(device=args.device), indent=1, default=float))


if __name__ == "__main__":
    main()
