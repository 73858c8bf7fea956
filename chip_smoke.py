"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device. Phases,
each printed as one JSON line:

  1. device     — the card's name and power limit (nvidia-smi);
  2. build      — compiles the extent_write kernel from
                  src/repro_torch/csrc/ with nvcc;
  3. kernel     — the kernel against its plain PyTorch twin on the card:
                  f32/bf16/int8, ragged sizes, one case above 2^24 lanes,
                  the admission-row and decode-column shapes of the main
                  path.
                  Stored words and counts bit-exact, energy rtol 1e-5;
  4. reduced    — reduced qwen2.5-3b in float32 (TF32 off) serving
                  tests/fixtures/trace_smoke.jsonl through the kernel and
                  through the twin: tokens, flips, errors identical,
                  energies rtol 1e-5;
  5. full       — qwen2.5-3b at full published width (bf16, random
                  weights from a seed): first the ms per decode step at
                  batch 4 (which also warms the card up), then the main
                  path once — 8 requests through the continuous
                  scheduler, every decode burst under
                  torch.cuda.set_sync_debug_mode("error") — counting the
                  kernel's launches over that run only;
  6. kernels    — per-kernel times (CUDA events) against the HBM bound
                  at the main path's shapes, the admission write on the
                  run's own operands (real prefill rows over a cold slot
                  and over a freed slot's stale rows), each also held
                  bit-exactly against the twin.

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


def serve_trace(cfg, params, backend, device):
    from repro_torch.serve import (ContinuousScheduler, ServeConfig,
                                   ServingEngine)
    from repro_torch.workload import TraceSource, load_trace
    trace = load_trace(ROOT / "tests" / "fixtures" / "trace_smoke.jsonl")
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        backend=backend), params, device=device)
    return ContinuousScheduler(eng, capacity=2).run(
        TraceSource(trace, cfg, device))


def phase_reduced(device):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2.5-3b").reduced()
    params = get_model(cfg).init(0, device)
    rep_k = serve_trace(cfg, params, "cuda", device)
    rep_r = serve_trace(cfg, params, "lanes_ref", device)
    for rid in rep_r["requests"]:
        a, b = rep_k["requests"][rid], rep_r["requests"][rid]
        for f in ("tokens", "flips", "errors"):
            if a[f] != b[f]:
                raise AssertionError(f"reduced serve: req {rid} {f} "
                                     f"{a[f]} != {b[f]}")
        if not math.isclose(a["energy_pj"], b["energy_pj"],
                            rel_tol=RTOL_ENERGY):
            raise AssertionError(f"reduced serve: req {rid} energy")
    tk, tr = rep_k["total"], rep_r["total"]
    for f in ("bits_written", "bit_errors", "bits_total"):
        if tk[f] != tr[f]:
            raise AssertionError(f"reduced serve: total {f}")
    if not math.isclose(tk["energy_pj"], tr["energy_pj"],
                        rel_tol=RTOL_ENERGY):
        raise AssertionError("reduced serve: total energy")
    emit({"phase": "reduced", "tf32": False, "requests": len(rep_k[
        "requests"]), "clock_steps": rep_k["clock_steps"],
          "bursts": rep_k["bursts"], "bits_written": tk["bits_written"],
          "bit_errors": tk["bit_errors"],
          "energy_pj": [tk["energy_pj"], tr["energy_pj"]], "ok": True})


def phase_full(device):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.extent_write import kernel as K
    from repro_torch.models import get_model
    from repro_torch.serve import (ContinuousScheduler, Request, ServeConfig,
                                   ServingEngine)
    cfg = get_config("qwen2.5-3b")
    prompt_len, new_tokens, capacity, n_req = 256, 32, 4, 8
    t0 = time.perf_counter()
    params = get_model(cfg).init(0, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in
                  _leaves(params))
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=prompt_len + new_tokens, max_new_tokens=new_tokens,
        backend="cuda"), params, device=device)

    def requests(seed):
        rs = np.random.default_rng(seed)
        return [Request(rid=i, prompt={"tokens": torch.from_numpy(
            rs.integers(0, cfg.vocab_size, (1, prompt_len))).to(device)},
            new_tokens=new_tokens, arrival=4 * i,
            app_id="chat" if i % 2 else "batch") for i in range(n_req)]

    # the step timing doubles as the warm-up (cuBLAS handles, first
    # launches); the main path below then runs exactly once, counted
    step_ms = decode_step_ms(eng, prompt_len, capacity)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sch = ContinuousScheduler(eng, capacity=capacity)
    reqs = requests(2)
    K.extent_write_cuda.launches = 0
    t0 = time.perf_counter()
    rep = sch.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.extent_write_cuda.launches
    groups = rep["pool"]["admission_groups"]
    expected = 2 * (groups + rep["decode_steps"])
    if launches <= 0 or launches != expected:
        raise AssertionError(f"extent_write launches {launches} != "
                             f"2 x (admission groups {groups} + decode "
                             f"steps {rep['decode_steps']}) = {expected}")
    toks = [rep["requests"][i]["tokens"] for i in range(n_req)]
    if any(len(t) != new_tokens for t in toks) or not all(
            0 <= x < cfg.vocab_size for t in toks for x in t):
        raise AssertionError("full-width serve: bad token output")
    tot = rep["total"]
    if not (math.isfinite(tot["energy_pj"]) and tot["energy_pj"] > 0
            and 0.0 < tot["ber_realized"] < 0.1):
        raise AssertionError(f"full-width serve: implausible ledger {tot}")
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "full", "arch": cfg.name, "params": eng.api.num_params(),
          "param_bytes": n_bytes, "init_s": init_s,
          "requests": n_req, "capacity": capacity, "prompt_len": prompt_len,
          "new_tokens": new_tokens, "clock_steps": rep["clock_steps"],
          "decode_steps": rep["decode_steps"], "bursts": rep["bursts"],
          "admission_groups": groups, "wall_s": wall,
          "tokens_per_s": n_req * new_tokens / wall,
          "decode_ms_per_step_b4": step_ms, "peak_mem_bytes": peak,
          "kv_write_energy_pj": tot["energy_pj"],
          "ber": tot["ber_realized"],
          "write_skip_rate": tot["write_skip_rate"],
          "bursts_sync_free": True, "extent_write_launches": launches,
          "ok": True})
    return launches, eng, sch


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


def time_writes(name, writes):
    """Kernel, twin and bound of a list of lane writes, per launch.
    ``writes`` holds (old lanes, new lanes, vectors) triples."""
    from repro_torch.kernels.extent_write import kernel as K
    from repro_torch.kernels.extent_write import ref
    lanes = sum(o.numel() for o, _, _ in writes)
    worst, flips = 0, 0
    for o, n, vec in writes:
        d, f = check_against_twin(o, n, 1, vec)
        worst, flips = max(worst, d), flips + f
    n0 = K.extent_write_cuda.launches
    iters = 200 if lanes < 1 << 20 else 50

    def run(fn):
        return lambda: [fn(o, n, 1, *vec) for o, n, vec in writes]

    ms = cuda_ms(run(K.extent_write_cuda), iters) / len(writes)
    plain = cuda_ms(run(ref.extent_write_ref), max(5, iters // 10)
                    ) / len(writes)
    K.extent_write_cuda.launches = n0
    t_bytes = 12 * lanes / HBM_BYTES_PER_S * 1e3 / len(writes)
    t_ops = flips / F32_FLOPS * 1e3 / len(writes)  # one f32 add per flip
    return {"shape": name, "lanes_per_launch": lanes // len(writes),
            "flips_per_launch": flips / len(writes), "ms": ms,
            "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": worst}


def phase_kernels_line(launches, worst_abs, worst_rel, eng, sch, device):
    """Times at the main path's shapes: an admission writes the K and V
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
    emit({"kernels": [{
        "name": "extent_write", "route": "cuda",
        "source": "src/repro_torch/csrc/extent_write.cu",
        "replaces": "src/repro/kernels/extent_write/kernel.py:114",
        "launches": launches,
        "max_abs_err": max(worst_abs, *(t["max_abs_err"]
                                        for t in timings.values())),
        "energy_max_rel_err": worst_rel,
        "ms": adm["ms"], "plain_ms": adm["plain_ms"],
        "bound_ms": adm["bound_ms"], "bound_by": adm["bound_by"],
        "library_ms": None, "shape": adm["shape"],
        "at": timings}]})


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
    from repro_torch.kernels.extent_write import kernel as K
    _, build_s = K.build(force=True)
    emit({"phase": "build", "source": str(K.SOURCE.relative_to(ROOT)),
          "seconds": build_s})
    worst_abs, worst_rel = phase_kernel(device)
    phase_reduced(device)
    launches, eng, sch = phase_full(device)
    print(nvidia_smi_line(), flush=True)
    phase_kernels_line(launches, worst_abs, worst_rel, eng, sch, device)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
