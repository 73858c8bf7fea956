"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device. Phases,
each printed as one JSON line:

  1. device       — the card's name and power limit (nvidia-smi);
  2. build        — compiles every kernel of src/repro_torch/csrc/ with
                    nvcc, one process per source, all started together;
  3. kernel       — the extent_write kernel against its plain PyTorch
                    twin on the card: f32/bf16/int8, ragged sizes, one
                    case above 2^24 lanes, the admission-row and
                    decode-column shapes of the main path. Stored words
                    and counts bit-exact, energy rtol 1e-5;
  4. scrub_kernel — the scrub kernel against its twin the same way, at
                    levels LOW, MID and EXACT: dense and sparse masks,
                    an all-zero mask, a case above 2^24 lanes, a whole
                    K/V leaf of the retention path and a 72-column window
                    of one. Scrubbed words, residual masks and counts
                    bit-exact, energy rtol 1e-5;
  5. reduced      — reduced qwen2.5-3b in float32 (TF32 off) serving
                    tests/fixtures/trace_smoke.jsonl through the kernels
                    and through the twins: without retention, then at
                    400 K with periodic scrubbing over whole leaves and
                    over column windows. Tokens, flips, errors and the
                    lifetime counters identical, energies rtol 1e-5; a
                    300 K run with retention on equals one with it off;
  6. full         — qwen2.5-3b at full published width (bf16, random
                    weights from a seed): first the ms per decode step at
                    batch 4 (which also warms the card up), then the main
                    path once — 8 requests through the continuous
                    scheduler, every decode burst under
                    torch.cuda.set_sync_debug_mode("error") — counting
                    the kernels' launches over that run only;
  7. retention    — the same 8 requests with retention decay at 350 K
                    (1000 s of dwell per step) and periodic whole-leaf
                    scrubbing every 8 steps, counted the same way; also
                    the ms per decode step with retention on, the decay's
                    ms per step and the ms per scrub pass;
  8. kernels      — per-kernel times against the HBM bound at the main
                    paths' shapes: the kernel's own device time
                    (torch.profiler) and the wrapper call's (CUDA
                    events), each also held bit-exactly against the twin.
                    extent_write: the admission write on the run's own
                    operands (real prefill rows over a cold slot and over
                    a freed slot's stale rows) and the decode column;
                    scrub: whole leaves of the retention run's own cache
                    and decay masks, and a dense synthetic mask.

The last line is {"ok": true, "device": {...}}. Any failure raises, so
the script exits non-zero and prints no result; it also refuses to run
without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
RTOL_ENERGY = 1e-5              # f32 energy: partials summed in another order


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_pair(shape, dtype, seed: int, device):
    """(old, new) of ``shape``: random words, with about a quarter of the
    elements left unchanged so the CMP skip path runs too."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if dtype == torch.int8:
        old = torch.randint(-128, 128, shape, generator=g, device=device,
                            dtype=torch.int8)
        new = torch.randint(-128, 128, shape, generator=g, device=device,
                            dtype=torch.int8)
    else:
        old = torch.randn(shape, generator=g, device=device).to(dtype)
        new = torch.randn(shape, generator=g, device=device).to(dtype)
    keep = torch.rand(shape, generator=g, device=device) < 0.25
    return old, torch.where(keep, old, new)


def phase_build():
    """Build every kernel from source, one nvcc per file in parallel."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build as B
    names = ("extent_write", "scrub")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda n: B.build(n, force=True), names))
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "kernels": [{"source": str(B.source(n).relative_to(ROOT)),
                       "seconds": sec}
                      for n, (_, sec) in zip(names, built)]})


def random_mask(shape, dtype, density, planes, seed, device):
    """A decay mask for a ``dtype`` tensor of ``shape``: the integer view
    of the same width, each bit of ``planes`` set with ``density``."""
    import torch
    from repro_torch.core.priority import int_type
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    m = torch.zeros(shape, dtype=torch.int64, device=device)
    for b in planes:
        hit = torch.rand(shape, generator=g, device=device) < density
        m |= hit.to(torch.int64) << b
    nbits = dtype.itemsize * 8
    return (m - ((m >> (nbits - 1)) << nbits)).to(int_type(dtype))


def check_scrub(s_u, m_u, seed, vec):
    """Kernel against twin on the same lanes (launches here are not
    counted): (largest word/count difference, energy relative error,
    re-written bits)."""
    import torch
    from repro_torch.kernels.extent_write.ref import as_u32
    from repro_torch.kernels.scrub import kernel as SK
    from repro_torch.kernels.scrub import ref as SR
    n0 = SK.scrub_cuda.launches
    a_s, a_r, a_st = SK.scrub_cuda(s_u, m_u, seed, *vec)
    b_s, b_r, b_st = SR.scrub_ref(s_u, m_u, seed, *vec)
    SK.scrub_cuda.launches = n0
    torch.cuda.synchronize()
    diff = max(int((as_u32(a_s) - as_u32(b_s)).abs().max()),
               int((as_u32(a_r) - as_u32(b_r)).abs().max()),
               *(abs(int(a_st[k]) - int(b_st[k]))
                 for k in ("flips01", "flips10", "errors")))
    e_k, e_r = float(a_st["energy_pj"]), float(b_st["energy_pj"])
    rel = abs(e_k - e_r) / max(abs(e_r), 1e-30)
    if diff or rel > RTOL_ENERGY:
        raise AssertionError(f"scrub kernel disagrees with its twin: "
                             f"diff {diff}, energy rel err {rel}")
    return diff, rel, int(b_st["flips01"]) + int(b_st["flips10"])


def phase_scrub_kernel(device):
    import torch
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    from repro_torch.kernels.scrub import kernel as SK
    from repro_torch.memory import leaf_vectors
    all32, all16, all8 = range(32), range(16), range(8)
    cases = [
        ("f32_dense", (7, 19), torch.float32, 0.3, all32),
        ("bf16_odd", (3, 5, 11), torch.bfloat16, 0.3, all16),
        ("int8_ragged", (13,), torch.int8, 0.3, all8),
        ("f32_above_2p24_sparse", ((1 << 24) + 3,), torch.float32, 1e-4,
         all32),
        ("f32_zero_mask", (1000,), torch.float32, 0.0, ()),
        # the retention path: bf16 K/V leaf, about 1% of mantissa bits
        ("bf16_leaf", (36, 4, 288, 2, 128), torch.bfloat16, 0.01,
         range(7)),
        ("bf16_window", (36, 4, 72, 2, 128), torch.bfloat16, 0.01,
         range(7)),
    ]
    worst_abs, worst_rel = 0, 0.0
    for i, (name, shape, dtype, density, planes) in enumerate(cases):
        g = torch.Generator(device=device)
        g.manual_seed(200 + i)
        if dtype == torch.int8:
            x = torch.randint(-128, 128, shape, generator=g, device=device,
                              dtype=torch.int8)
        else:
            x = torch.randn(shape, generator=g, device=device).to(dtype)
        m = random_mask(shape, dtype, density, planes, 300 + i, device)
        s_u, m_u = ops.to_lanes(x), ops.to_lanes(m)
        for level in (Priority.LOW, Priority.MID, Priority.EXACT):
            lv = leaf_vectors(dtype, level, device)
            vec = (lv.thr01, lv.thr10, lv.le01, lv.le10)
            seed = 0x2545F491 ^ (i * 7919 + int(level))
            diff, rel, rewrites = check_scrub(s_u, m_u, seed, vec)
            if name == "f32_zero_mask":
                n0 = SK.scrub_cuda.launches
                sc, res, st = SK.scrub_cuda(s_u, m_u, seed, *vec)
                SK.scrub_cuda.launches = n0
                if not (torch.equal(sc, s_u) and not res.any()
                        and float(st["energy_pj"]) == 0.0 and rewrites == 0
                        and int(st["errors"]) == 0):
                    raise AssertionError("scrub of a zero mask is not an "
                                         "identity at zero cost")
            emit({"phase": "scrub_kernel", "case": name,
                  "level": level.name, "lanes": s_u.numel(),
                  "rewrites": rewrites, "max_abs_diff": diff,
                  "energy_rel_err": rel, "ok": True})
            worst_abs, worst_rel = max(worst_abs, diff), max(worst_rel, rel)
    return worst_abs, worst_rel


def phase_kernel(device):
    import torch
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import kernel as K
    from repro_torch.kernels.extent_write import ops, ref
    from repro_torch.memory import leaf_vectors
    cases = [
        ("f32_ragged", (7, 19), torch.float32, Priority.LOW),
        ("bf16_odd", (3, 5, 11), torch.bfloat16, Priority.MID),
        ("int8_ragged", (13,), torch.int8, Priority.LOW),
        ("f32_above_2p24", ((1 << 24) + 3,), torch.float32, Priority.HIGH),
        ("bf16_decode_col", (36, 4, 1, 2, 128), torch.bfloat16,
         Priority.LOW),
        ("bf16_admission_row", (36, 1, 288, 2, 128), torch.bfloat16,
         Priority.MID),
    ]
    worst_abs = 0
    worst_rel = 0.0
    for i, (name, shape, dtype, level) in enumerate(cases):
        old, new = random_pair(shape, dtype, 100 + i, device)
        lv = leaf_vectors(dtype, level, device)
        vec = (lv.thr01, lv.thr10, lv.le01, lv.le10)
        seed = 0x9E3779B9 ^ (i * 7919)
        o_u, n_u = ops.to_lanes(old), ops.to_lanes(new)
        s_k, st_k = K.extent_write_cuda(o_u, n_u, seed, *vec)
        s_r, st_r = ref.extent_write_ref(o_u, n_u, seed, *vec)
        torch.cuda.synchronize()
        diff = int((ref.as_u32(s_k) - ref.as_u32(s_r)).abs().max())
        counts = {k: (int(st_k[k]), int(st_r[k]))
                  for k in ("flips01", "flips10", "errors")}
        e_k, e_r = float(st_k["energy_pj"]), float(st_r["energy_pj"])
        rel = abs(e_k - e_r) / max(abs(e_r), 1e-30)
        ok = (diff == 0 and all(a == b for a, b in counts.values())
              and rel <= RTOL_ENERGY)
        emit({"phase": "kernel", "case": name, "lanes": o_u.numel(),
              "stored_max_abs_diff": diff, "counts": counts,
              "energy_pj": [e_k, e_r], "energy_rel_err": rel, "ok": ok})
        if not ok:
            raise AssertionError(f"kernel disagrees with its twin: {name}")
        worst_abs = max(worst_abs, diff,
                        *(abs(a - b) for a, b in counts.values()))
        worst_rel = max(worst_rel, rel)
    return worst_abs, worst_rel


def serve_trace(cfg, params, backend, device, scrub_cols=None, **kw):
    """The fixture trace at capacity 2. ``kw`` goes to ServeConfig;
    ``scrub_cols`` (0 = whole leaves) adds periodic scrubbing every 2
    steps."""
    from repro_torch.reliability import make_scrub_policy
    from repro_torch.serve import (ContinuousScheduler, ServeConfig,
                                   ServingEngine)
    from repro_torch.workload import TraceSource, load_trace
    trace = load_trace(ROOT / "tests" / "fixtures" / "trace_smoke.jsonl")
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        backend=backend, **kw), params, device=device)
    policy = (None if scrub_cols is None else
              make_scrub_policy("periodic", 2, scrub_cols))
    return ContinuousScheduler(eng, capacity=2, scrub_policy=policy).run(
        TraceSource(trace, cfg, device))


def same_serve(rep_k, rep_r, what):
    """Kernel and twin runs serve the same tokens, flips, errors and
    lifetime counters; energies agree to RTOL_ENERGY."""
    for rid in rep_r["requests"]:
        a, b = rep_k["requests"][rid], rep_r["requests"][rid]
        for f in ("tokens", "flips", "errors"):
            if a[f] != b[f]:
                raise AssertionError(f"{what}: req {rid} {f} "
                                     f"{a[f]} != {b[f]}")
        if not math.isclose(a["energy_pj"], b["energy_pj"],
                            rel_tol=RTOL_ENERGY):
            raise AssertionError(f"{what}: req {rid} energy")
    tk, tr = rep_k["total"], rep_r["total"]
    for f in ("bits_written", "bit_errors", "bits_total"):
        if tk[f] != tr[f]:
            raise AssertionError(f"{what}: total {f}")
    if not math.isclose(tk["energy_pj"], tr["energy_pj"],
                        rel_tol=RTOL_ENERGY):
        raise AssertionError(f"{what}: total energy")
    if "lifetime" in rep_r:
        lk, lr = rep_k["lifetime"], rep_r["lifetime"]
        for f in ("retention_flips", "residual_decayed_bits",
                  "scrub_passes"):
            if lk[f] != lr[f]:
                raise AssertionError(f"{what}: lifetime {f} "
                                     f"{lk[f]} != {lr[f]}")
        for f in ("scrub_energy_pj", "lifetime_energy_pj"):
            if not math.isclose(lk[f], lr[f], rel_tol=RTOL_ENERGY):
                raise AssertionError(f"{what}: lifetime {f}")


def phase_reduced(device):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.scrub import kernel as SK
    from repro_torch.models import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2.5-3b").reduced()
    params = get_model(cfg).init(0, device)
    rep_k = serve_trace(cfg, params, "cuda", device)
    rep_r = serve_trace(cfg, params, "lanes_ref", device)
    same_serve(rep_k, rep_r, "reduced serve")
    tk = rep_k["total"]
    emit({"phase": "reduced", "tf32": False, "requests": len(rep_k[
        "requests"]), "clock_steps": rep_k["clock_steps"],
          "bursts": rep_k["bursts"], "bits_written": tk["bits_written"],
          "bit_errors": tk["bit_errors"],
          "energy_pj": [tk["energy_pj"], rep_r["total"]["energy_pj"]],
          "ok": True})
    from repro_torch.workload import load_trace
    max_seq = load_trace(ROOT / "tests" / "fixtures" /
                         "trace_smoke.jsonl").max_seq()
    for cols in (0, max_seq // 4):
        ret = dict(retention_scale=1000.0, ambient_k=400.0)
        n0 = SK.scrub_cuda.launches
        rep_k = serve_trace(cfg, params, "cuda", device, scrub_cols=cols,
                            **ret)
        launched = SK.scrub_cuda.launches - n0
        rep_r = serve_trace(cfg, params, "lanes_ref", device,
                            scrub_cols=cols, **ret)
        lt = rep_k["lifetime"]
        mode = f"cols={cols}" if cols else "whole leaves"
        same_serve(rep_k, rep_r, f"reduced serve, 400 K scrub {mode}")
        if not (lt["scrub_passes"] > 0 and lt["retention_flips"] > 0
                and launched == 2 * lt["scrub_passes"]):
            raise AssertionError(f"reduced 400 K run ({mode}): "
                                 f"{launched} scrub launches, {lt}")
        emit({"phase": "reduced", "retention": "400 K", "scrub": mode,
              "scrub_launches": launched, **{k: lt[k] for k in (
                  "retention_flips", "residual_decayed_bits",
                  "scrub_passes", "scrub_energy_pj",
                  "lifetime_energy_pj")},
              "lanes_ref_scrub_energy_pj":
                  rep_r["lifetime"]["scrub_energy_pj"], "ok": True})
    off = serve_trace(cfg, params, "cuda", device)
    on = serve_trace(cfg, params, "cuda", device, scrub_cols=0,
                     retention_scale=1000.0, ambient_k=300.0)
    if (on["requests"] != off["requests"]
            or any(on["streams"][s] != off["streams"][s]
                   for s in ("kv_prefill", "kv_decode"))
            or on["lifetime"]["retention_flips"] != 0):
        raise AssertionError("300 K with retention on differs from "
                             "retention off")
    emit({"phase": "reduced", "retention": "300 K equals off",
          "scrub_passes": on["lifetime"]["scrub_passes"], "ok": True})


#: the main path's traffic: 8 requests of 256-token prompts, 32 new
#: tokens each, arriving 4 steps apart into a pool of 4 slots
PROMPT_LEN, NEW_TOKENS, CAPACITY, N_REQ = 256, 32, 4, 8


def serve_full(eng, scrub_policy=None):
    """Drive the main path once at full width: the 8 requests through the
    continuous scheduler, every burst under
    ``set_sync_debug_mode("error")``. The kernels' launch counts are set
    to 0 just before and read just after. Returns (report, scheduler,
    wall seconds, {kernel: launches})."""
    import numpy as np
    import torch
    from repro_torch.kernels.extent_write import kernel as K
    from repro_torch.kernels.scrub import kernel as SK
    from repro_torch.serve import ContinuousScheduler, Request
    cfg = eng.cfg
    rs = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt={"tokens": torch.from_numpy(
        rs.integers(0, cfg.vocab_size, (1, PROMPT_LEN))).to(eng.device)},
        new_tokens=NEW_TOKENS, arrival=4 * i,
        app_id="chat" if i % 2 else "batch") for i in range(N_REQ)]
    sch = ContinuousScheduler(eng, capacity=CAPACITY,
                              scrub_policy=scrub_policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.extent_write_cuda.launches = SK.scrub_cuda.launches = 0
    t0 = time.perf_counter()
    rep = sch.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"extent_write": K.extent_write_cuda.launches,
                "scrub": SK.scrub_cuda.launches}
    groups = rep["pool"]["admission_groups"]
    expected = 2 * (groups + rep["decode_steps"])
    if launches["extent_write"] != expected or expected <= 0:
        raise AssertionError(f"extent_write launches {launches} != "
                             f"2 x (admission groups {groups} + decode "
                             f"steps {rep['decode_steps']}) = {expected}")
    toks = [rep["requests"][i]["tokens"] for i in range(N_REQ)]
    if any(len(t) != NEW_TOKENS for t in toks) or not all(
            0 <= x < cfg.vocab_size for t in toks for x in t):
        raise AssertionError("full-width serve: bad token output")
    tot = rep["total"]
    if not (math.isfinite(tot["energy_pj"]) and tot["energy_pj"] > 0
            and 0.0 < tot["ber_realized"] < 0.1):
        raise AssertionError(f"full-width serve: implausible ledger {tot}")
    return rep, sch, wall, launches


def phase_full(device):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    params = get_model(cfg).init(0, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in
                  _leaves(params))
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=PROMPT_LEN + NEW_TOKENS, max_new_tokens=NEW_TOKENS,
        backend="cuda"), params, device=device)
    # the step timing doubles as the warm-up (cuBLAS handles, first
    # launches); the main path below then runs exactly once, counted
    step_ms = decode_step_ms(eng, PROMPT_LEN, CAPACITY)
    rep, sch, wall, launches = serve_full(eng)
    if launches["scrub"]:
        raise AssertionError("the retention-off path launched a scrub")
    tot = rep["total"]
    emit({"phase": "full", "arch": cfg.name, "params": eng.api.num_params(),
          "param_bytes": n_bytes, "init_s": init_s,
          "requests": N_REQ, "capacity": CAPACITY, "prompt_len": PROMPT_LEN,
          "new_tokens": NEW_TOKENS, "clock_steps": rep["clock_steps"],
          "decode_steps": rep["decode_steps"], "bursts": rep["bursts"],
          "admission_groups": rep["pool"]["admission_groups"],
          "wall_s": wall, "tokens_per_s": N_REQ * NEW_TOKENS / wall,
          "decode_ms_per_step_b4": step_ms,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "kv_write_energy_pj": tot["energy_pj"],
          "ber": tot["ber_realized"],
          "write_skip_rate": tot["write_skip_rate"],
          "bursts_sync_free": True,
          "extent_write_launches": launches["extent_write"], "ok": True})
    return launches["extent_write"], eng, sch


def phase_retention(device, eng_full):
    """The launcher's documented retention example at full width:
    qwen2.5-3b at 350 K with 1000 s of dwell per decode step, periodic
    whole-leaf scrubbing every 8 steps, the same 8 requests."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.scrub import kernel as SK
    from repro_torch.reliability import make_scrub_policy
    from repro_torch.serve import ServingEngine
    eng = ServingEngine(eng_full.cfg, dataclasses.replace(
        eng_full.scfg, retention_scale=1000.0, ambient_k=350.0),
        eng_full.params, device=device)
    step_ms = decode_step_ms(eng, PROMPT_LEN, CAPACITY)
    rep, sch, wall, launches = serve_full(
        eng, make_scrub_policy("periodic", interval=8))
    peak = torch.cuda.max_memory_allocated()
    lt = rep["lifetime"]
    if not (launches["scrub"] == 2 * lt["scrub_passes"] > 0
            and lt["retention_flips"] > 0
            and lt["lifetime_energy_pj"] == (lt["write_energy_pj"]
                                             + lt["scrub_energy_pj"])
            and lt["residual_decayed_bits"] < lt["retention_flips"]):
        raise AssertionError(f"retention run: launches {launches}, "
                             f"lifetime ledger {lt}")
    # the decay of one step and one whole-leaf scrub pass over the
    # end-of-run pool (these scrub launches are not the main path's)
    key = rng.PRNGKey(5)
    rvec = eng.retention_vectors_for(Priority.LOW)
    decay_ms = cuda_ms(lambda: eng.life_plan.advance(
        key, sch.pool.cache, sch.life, rvec), iters=10, warmup=2)
    n0 = SK.scrub_cuda.launches
    vec = eng.vectors_for_floor(Priority.LOW)
    scrub_ms = cuda_ms(lambda: eng.scrub(key, sch.pool.cache, sch.life,
                                         vec), iters=10, warmup=2)
    SK.scrub_cuda.launches = n0
    emit({"phase": "retention", "arch": eng.cfg.name,
          "scrub_interval": 8, "clock_steps": rep["clock_steps"],
          "decode_steps": rep["decode_steps"], "bursts": rep["bursts"],
          "wall_s": wall, "tokens_per_s": N_REQ * NEW_TOKENS / wall,
          "decode_ms_per_step_b4": step_ms,
          "decay_ms_per_step": decay_ms, "scrub_ms_per_pass": scrub_ms,
          "peak_mem_bytes": peak, "bursts_sync_free": True,
          "launches": launches, **lt, "ok": True})
    return launches["scrub"], sch


def decode_step_ms(eng, prompt_len, batch) -> float:
    """Milliseconds per fused decode step (model + column writes) at a
    full pool, timed over one 16-step burst after a prefill and a 2-step
    warm-up burst (the setup ``repro_torch.launch.profile`` profiles)."""
    import torch
    from repro_torch.launch.profile import steady_burst
    run = steady_burst(eng, batch, prompt_len, seed=3)
    run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(16)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / 16


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def check_against_twin(o_u, n_u, seed, vec):
    """Largest difference of stored words and counts between the kernel
    and its twin on the same lanes (launches here are not counted)."""
    import torch
    from repro_torch.kernels.extent_write import kernel as K
    from repro_torch.kernels.extent_write import ref
    n0 = K.extent_write_cuda.launches
    s_k, st_k = K.extent_write_cuda(o_u, n_u, seed, *vec)
    s_r, st_r = ref.extent_write_ref(o_u, n_u, seed, *vec)
    K.extent_write_cuda.launches = n0
    torch.cuda.synchronize()
    diff = int((ref.as_u32(s_k) - ref.as_u32(s_r)).abs().max())
    for k in ("flips01", "flips10", "errors"):
        diff = max(diff, abs(int(st_k[k]) - int(st_r[k])))
    e_k, e_r = float(st_k["energy_pj"]), float(st_r["energy_pj"])
    if diff or abs(e_k - e_r) > RTOL_ENERGY * abs(e_r):
        raise AssertionError("kernel disagrees with its twin on the main "
                             "path's operands")
    return diff, int(st_r["flips01"]) + int(st_r["flips10"])


def device_ms(calls, kernel_name: str, reps: int):
    """The kernel's own device time per launch: torch.profiler's CUDA
    kernel rows whose name holds ``kernel_name``, over ``reps`` rounds of
    ``calls()`` after one warm-up round. None when the profiler shows no
    device time."""
    import torch
    from repro_torch.launch.profile import _dev_us
    calls()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            calls()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel_name in e.key
            and "CUDA" in str(getattr(e, "device_type", ""))]
    n = sum(e.count for e in rows)
    us = sum(_dev_us(e) for e in rows)
    return us / 1e3 / n if n and us > 0 else None


def time_kernel(wrapper, twin, kernel_name, args, bytes_per_lane, flips):
    """Per launch, over the argument tuples ``args``: the kernel's device
    time (profiler), the wrapper call's time (CUDA events around a loop
    of calls), the twin's, and the bound — the larger of the bytes moved
    (``bytes_per_lane``, each input read and output written once) over
    the HBM rate and one f32 energy add per flipped bit over the f32
    rate. The wrapper's launch count is restored afterwards."""
    lanes = sum(a[0].numel() for a in args)
    n0 = wrapper.launches
    iters = 200 if lanes < 1 << 20 else 50

    def run(fn):
        return lambda: [fn(*a) for a in args]

    dev = device_ms(run(wrapper), kernel_name, max(5, iters // 5))
    call_ms = cuda_ms(run(wrapper), iters) / len(args)
    plain = cuda_ms(run(twin), max(5, iters // 10)) / len(args)
    wrapper.launches = n0
    t_bytes = bytes_per_lane * lanes / HBM_BYTES_PER_S * 1e3 / len(args)
    t_ops = flips / F32_FLOPS * 1e3 / len(args)
    return {"lanes_per_launch": lanes // len(args),
            "flips_per_launch": flips / len(args),
            "ms": dev if dev is not None else call_ms,
            "ms_is": ("kernel device time (torch.profiler)"
                      if dev is not None else
                      "wrapper call (CUDA events): no profiler device time"),
            "device_ms": dev, "wrapper_ms": call_ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_writes(name, writes):
    """extent_write over a list of (old lanes, new lanes, vectors), held
    against the twin, then timed (12 bytes per lane)."""
    from repro_torch.kernels.extent_write import kernel as K
    from repro_torch.kernels.extent_write import ref
    worst, flips = 0, 0
    for o, n, vec in writes:
        d, f = check_against_twin(o, n, 1, vec)
        worst, flips = max(worst, d), flips + f
    return {"shape": name, "max_abs_err": worst, **time_kernel(
        K.extent_write_cuda, ref.extent_write_ref, "extent_write_kernel",
        [(o, n, 1, *vec) for o, n, vec in writes], 12, flips)}


def time_scrubs(name, scrubs):
    """scrub over a list of (stored lanes, mask lanes, vectors), held
    against the twin, then timed (16 bytes per lane)."""
    from repro_torch.kernels.scrub import kernel as SK
    from repro_torch.kernels.scrub import ref as SR
    worst, rel, flips = 0, 0.0, 0
    for su, mu, vec in scrubs:
        d, r, f = check_scrub(su, mu, 1, vec)
        worst, rel, flips = max(worst, d), max(rel, r), flips + f
    return {"shape": name, "max_abs_err": worst, "energy_rel_err": rel,
            **time_kernel(SK.scrub_cuda, SR.scrub_ref, "scrub_kernel",
                          [(su, mu, 1, *vec) for su, mu, vec in scrubs],
                          16, flips)}


def extent_write_entry(launches, worst_abs, worst_rel, eng, sch, device):
    """Times at the full path's shapes: an admission writes the K and V
    rows (36, 1, 288, 2, 128) bf16 of one new prompt — real prefill rows,
    zero past the prompt — over a cold slot (zeros) or over the stale rows
    a finished request of the run left there; a decode step writes one
    ring column (36, 4, 1, 2, 128) bf16 per leaf."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    from repro_torch.memory import leaf_vectors
    prompt_len = eng.scfg.max_seq - eng.scfg.max_new_tokens
    prompt = torch.from_numpy(np.random.default_rng(11).integers(
        0, eng.cfg.vocab_size, (1, prompt_len))).to(device)
    _, rows = eng.api.prefill(eng.params, {"tokens": prompt},
                              eng.scfg.max_seq)
    vecs = eng.vectors_for_floor(Priority.LOW)
    news = T.leaves(rows)
    stale = T.leaves(sch.pool.extract_rows([0]))

    def admission(olds):
        return [(ops.to_lanes(o), ops.to_lanes(n),
                 (v.thr01, v.thr10, v.le01, v.le10))
                for o, n, v in zip(olds, news, vecs) if v is not None]

    lv = leaf_vectors(torch.bfloat16, Priority.LOW, device)
    old, new = random_pair((36, 4, 1, 2, 128), torch.bfloat16, 7, device)
    row = f"admission {tuple(news[0].shape)} {str(news[0].dtype)[6:]}"
    timings = {
        "admission_stale": time_writes(f"{row} over stale rows",
                                       admission(stale)),
        "admission_cold": time_writes(
            f"{row} over zeros",
            admission([torch.zeros_like(n) for n in news])),
        "decode": time_writes(f"decode column {tuple(old.shape)} bfloat16",
                              [(ops.to_lanes(old), ops.to_lanes(new),
                                (lv.thr01, lv.thr10, lv.le01, lv.le10))]),
    }
    adm = timings["admission_stale"]
    return {
        "name": "extent_write", "route": "cuda",
        "source": "src/repro_torch/csrc/extent_write.cu",
        "replaces": "src/repro/kernels/extent_write/kernel.py:114",
        "launches": launches,
        "max_abs_err": max(worst_abs, *(t["max_abs_err"]
                                        for t in timings.values())),
        "energy_max_rel_err": worst_rel,
        "ms": adm["ms"], "plain_ms": adm["plain_ms"],
        "bound_ms": adm["bound_ms"], "bound_by": adm["bound_by"],
        "library_ms": None, "shape": adm["shape"], "at": timings}


def scrub_entry(launches, worst_abs, worst_rel, sch, device):
    """Times at the retention path's shape: a whole-leaf pass scrubs a K
    or V leaf (36, 4, 288, 2, 128) bf16 = 5,308,416 lanes. Timed on the
    run's own end-of-run cache and decay masks (sparse), and on the V
    leaf under a dense synthetic mask (a quarter of all bits)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    eng = sch.eng
    vecs = eng.vectors_for_floor(Priority.LOW)
    leaves = T.leaves(sch.pool.cache)
    own = [(ops.to_lanes(x), ops.to_lanes(m),
            (v.thr01, v.thr10, v.le01, v.le10))
           for x, m, v in zip(leaves, sch.life.masks, vecs)
           if m is not None]
    v_leaf = leaves[-1]
    dense = random_mask(tuple(v_leaf.shape), v_leaf.dtype, 0.25,
                        range(16), 9, device)
    shape = f"whole leaf {tuple(v_leaf.shape)} {str(v_leaf.dtype)[6:]}"
    timings = {
        "run_masks": time_scrubs(f"{shape}, end-of-run decay masks", own),
        "dense_mask": time_scrubs(f"{shape}, 25% of bits set",
                                  [(ops.to_lanes(v_leaf),
                                    ops.to_lanes(dense), own[-1][2])]),
    }
    run = timings["run_masks"]
    return {
        "name": "scrub", "route": "cuda",
        "source": "src/repro_torch/csrc/scrub.cu",
        "replaces": "src/repro/kernels/scrub/kernel.py:84",
        "launches": launches,
        "max_abs_err": max(worst_abs, *(t["max_abs_err"]
                                        for t in timings.values())),
        "energy_max_rel_err": max(worst_rel, *(
            t["energy_rel_err"] for t in timings.values())),
        "ms": run["ms"], "plain_ms": run["plain_ms"],
        "bound_ms": run["bound_ms"], "bound_by": run["bound_by"],
        # no single PyTorch call computes the corrective re-write
        "library_ms": None, "shape": run["shape"], "at": timings}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build()
    worst_abs, worst_rel = phase_kernel(device)
    s_abs, s_rel = phase_scrub_kernel(device)
    phase_reduced(device)
    launches, eng, sch = phase_full(device)
    s_launches, r_sch = phase_retention(device, eng)
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": [
        extent_write_entry(launches, worst_abs, worst_rel, eng, sch,
                           device),
        scrub_entry(s_launches, s_abs, s_rel, r_sch, device)]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
