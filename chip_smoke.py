"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device. Phases,
each printed as one JSON line:

  1. device       — the card's name and power limit (nvidia-smi);
  2. build        — compiles every kernel of src/repro_torch/csrc/ (four
                    sources) with nvcc, one process per source, all
                    started together; beside them nvcc reads ptxas's
                    registers and spills of local_attention's wgmma
                    kernels and of kv_quant's (-Xptxas -v): the served
                    instances (h 256; bfloat16) must not spill; and one
                    counter-hash draw, collected as kv_quant collects it,
                    is compiled alone and its integer instructions counted
                    in SASS (cuobjdump -sass) per pipe (integer ALU, FMA),
                    which with the SM count and nvidia-smi's clocks.max.sm
                    gives the bound's integer term (printed);
  3. kernel       — the extent_write kernel against its plain PyTorch
                    twin on the card: f32/bf16/int8, ragged sizes, one
                    case above 2^24 lanes, the admission-row and
                    decode-column shapes of the main path, and the
                    admission row with every plane of every lane flipping
                    (the longest queue of flipped planes). Stored words
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
  8. local_attention_kernel
                  — the local_attention kernel against its plain PyTorch
                    version on the card, every case of att_cases():
                    recurrentgemma-2b's prefill shape (S 3072, 10 heads
                    over 1 KV head of 256, window 2048, bf16), f32 and bf16
                    GQA/MHA cases with a softcap, the wgmma route at h 64,
                    128 and 256 with B 2, S 333 and 3000, windows 100 and
                    2048, GQA 2:1 and 10:1 and the softcap on, a ragged S
                    with a head width of 80, window >= S, and the reduced
                    hybrid's shape, in f32 and in bf16; the route the C
                    dispatch takes is held against kernel.route. The plain
                    version runs in f32 on the same inputs; for bf16 its
                    result is rounded to bf16. |difference| within 2e-5
                    (f32), or within 1e-4 + 2^-7 |plain| (bf16: one unit in
                    the last place of the rounding);
  9. kv_quant_kernel
                  — the kv_quant kernel against its twin at the CPU tests'
                    shapes, on their adversarial cases (half-integer
                    quotients, an all-zero block, -1 payloads, absmax
                    below 1e-12, signed zeros, +-absmax, 1, 8191 and 8193
                    elements) and on flat views 1, 3 or 7 elements past a
                    16-byte boundary, at levels LOW, MID, HIGH, EXACT:
                    int8 payload, scales (bit for bit) and error counts
                    exact, each difference measured and printed;
 10. reduced_hybrid
                  — reduced recurrentgemma-2b in float32 (TF32 off)
                    serving a four-request hybrid trace (24-token prompts,
                    longer than its 16-key window) through the kernels and
                    through the plain versions: tokens identical, flips
                    and energy within 1.5% per request, errors within
                    three Poisson deviations (the tests' tolerances);
 11. hybrid       — recurrentgemma-2b at full published width (bf16,
                    random weights from a seed, 26 layers): 8 requests of
                    3072-token prompts (longer than the 2048-key window),
                    32 new tokens each, 4 steps apart into 4 slots, every
                    burst sync-free, then the int8 store (kv_quant) of the
                    served cache's K and V, counting the launches of every
                    kernel over that run only; the int8 store is then held
                    bit-exactly against its twin at those leaves;
 12. kernels      — per-kernel times against the card's bound at the main
                    paths' shapes: the kernel's own device time
                    (torch.profiler) and the wrapper call's (CUDA
                    events), each also held against the plain version.
                    extent_write: the admission write on the run's own
                    operands (real prefill rows over a cold slot and over
                    a freed slot's stale rows) and the decode column;
                    scrub: whole leaves of the retention run's own cache
                    and decay masks, and a dense synthetic mask;
                    local_attention: the hybrid prefill's shape, beside
                    one scaled_dot_product_attention call with a boolean
                    band mask (timed only: the port never calls it; held
                    against the f32 plain version within bf16 rounding of
                    its probabilities and its output);
                    kv_quant: the served cache's K leaf, with its draws
                    per element (set payload bits), registers and spills.
                    Each bound is the largest of the bytes moved at the
                    HBM rate, the f32 energy adds at the f32 rate and the
                    counter-hash draws (extent_write: flipped planes;
                    scrub: decayed mask bits; kv_quant: set payload bits)
                    on the integer pipes, with the terms printed.

The last line is {"ok": true, "device": {...}}. Any failure raises, so
the script exits non-zero and prints no result; it also refuses to run
without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
#: integer instructions an SM issues a clock, per pipe: the INT32 lanes
#: (Hopper white paper) take LOP3, SHF, IADD3, ISETP and the like; IMAD
#: and its forms issue to the FMA pipe, whose heavy half (16 lanes of each
#: of the 4 sub-partitions) takes them. The issue rate, 4 x 32 = 128
#: instructions a clock, never binds a mix of the two: alu + fma
#: instructions at 128 a clock take no longer than the larger at 64.
INT_LANES_PER_SM = {"alu": 64, "fma": 64}
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor cores
RTOL_ENERGY = 1e-5              # f32 energy: partials summed in another order
#: local_attention against its plain version run in float32 on the same
#: inputs, (atol, rtol). float32: the JAX package's own atol for its
#: kernel. bfloat16: both compute in float32 and round the output once to
#: bf16, so they may differ by one unit in the last place (2^-7 of the
#: value at most), plus 1e-4 for float32 rounding near 0
ATT_TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-4, 2.0 ** -7)}
#: every kernel of the port: name -> (wrapper module, wrapper instance)
KERNELS = {
    "extent_write": ("repro_torch.kernels.extent_write.kernel",
                     "extent_write_cuda"),
    "scrub": ("repro_torch.kernels.scrub.kernel", "scrub_cuda"),
    "local_attention": ("repro_torch.kernels.local_attention.kernel",
                        "local_attention_cuda"),
    "kv_quant": ("repro_torch.kernels.kv_quant.kernel", "kv_quant_cuda"),
}


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


def kernel_wrapper(name: str):
    import importlib
    mod, attr = KERNELS[name]
    return getattr(importlib.import_module(mod), attr)


def reset_launches() -> None:
    for name in KERNELS:
        kernel_wrapper(name).launches = 0


def read_launches() -> dict:
    return {name: kernel_wrapper(name).launches for name in KERNELS}


@contextlib.contextmanager
def uncounted(name: str):
    """Launches made inside (a kernel held against its plain version, a
    timing loop) do not count as the main path's."""
    w = kernel_wrapper(name)
    n0 = w.launches
    try:
        yield w
    finally:
        w.launches = n0


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


def sm_clock_max_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def draw_clocks(alu: int, fma: int):
    """SM clocks per lane that one draw of ``alu`` integer-ALU and ``fma``
    FMA-pipe instructions takes at the least, and the pipe that sets it:
    the larger of each pipe's instructions over its lanes a clock."""
    per = {"alu": alu / INT_LANES_PER_SM["alu"],
           "fma": fma / INT_LANES_PER_SM["fma"]}
    pipe = max(per, key=per.get)
    return per[pipe], pipe


@functools.lru_cache(maxsize=1)
def draw_cost() -> dict:
    """The integer side of the bound: the integer instructions of one
    counter-hash draw collected as kv_quant.cu collects it, the cheapest
    draw counter_hash.cuh offers (counted in SASS by ``build.draw_ops``,
    per pipe, and listed), and the SM clocks it takes (``draw_clocks``)
    on the card's SMs at the maximum SM clock. extent_write and scrub
    draw through uniform_bits, which costs more: their bound is the least
    the hash could cost them."""
    import torch
    from repro_torch.kernels import build as B
    ops = B.draw_ops()
    clocks, pipe = draw_clocks(ops["alu"], ops["fma"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = sm_clock_max_mhz()
    return {**ops, "ops_from": "cuobjdump -sass of counter_hash.cuh's "
            "folded draw, draw_key and collect", "sm_clocks_per_draw": clocks,
            "paced_by": pipe, "sms": sms, "sm_clock_max_mhz": mhz,
            "draws_per_s": sms * mhz * 1e6 / clocks}


def int_bound_ms(draws) -> float:
    """The least time ``draws`` counter-hash draws take on the card's
    integer pipes (``draw_cost``)."""
    return draws / draw_cost()["draws_per_s"] * 1e3


def phase_build():
    """Build every kernel from source, one nvcc per file in parallel;
    beside them, nvcc reads ptxas's registers and spills of
    local_attention's wgmma kernels and of kv_quant's (``-Xptxas -v``),
    and one counter-hash draw is compiled alone for ``draw_cost``.
    Returns the ptxas lines of the served instances (local_attention
    h 256, kv_quant bfloat16), which must not spill."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build as B
    names = tuple(KERNELS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 3) as ex:
        usage = ex.submit(B.resource_usage, "local_attention")
        q_usage = ex.submit(B.resource_usage, "kv_quant")
        draw = ex.submit(draw_cost)
        built = list(ex.map(lambda n: B.build(n, force=True), names))
        usage, notes = usage.result()
        q_usage, q_notes = q_usage.result()
        draw = draw.result()
    wgmma = {h: next(u for k, u in usage.items()
                     if f"local_attention_kernel_wgmmaILi{h}E" in k)
             for h in (64, 128, 256)}
    kvq = {dt: next(u for k, u in q_usage.items()
                    if k.startswith("_Z") and f"kv_quant_kernelI{tag}E" in k)
           for dt, tag in (("bfloat16", "13__nv_bfloat16"),
                           ("float32", "f"))}
    print(f"counter-hash draw: {draw['total']} integer instructions, "
          f"{draw['alu']} on the integer ALU ({INT_LANES_PER_SM['alu']} "
          f"lanes a clock per SM) and {draw['fma']} on the FMA pipe "
          f"({INT_LANES_PER_SM['fma']}), so {draw['sm_clocks_per_draw']:g} "
          f"SM clocks a draw, paced by the {draw['paced_by']} "
          f"({draw['ops_from']}: {draw['ops']}); {draw['sms']} SMs at "
          f"clocks.max.sm {draw['sm_clock_max_mhz']:g} MHz", flush=True)
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "kernels": [{"source": str(B.source(n).relative_to(ROOT)),
                       "seconds": sec}
                      for n, (_, sec) in zip(names, built)],
          "local_attention_wgmma_ptxas": wgmma, "ptxas_notes": notes,
          "kv_quant_ptxas": kvq, "kv_quant_ptxas_notes": q_notes,
          "draw": draw})
    for what, u in (("local_attention h 256", wgmma[256]),
                    ("kv_quant bfloat16", kvq["bfloat16"])):
        if u["spill_stores"] or u["spill_loads"]:
            raise AssertionError(f"the served {what} instance spills: {u}")
    return wgmma[256], kvq["bfloat16"]


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
    from repro_torch.kernels.scrub import ref as SR
    with uncounted("scrub") as w:
        a_s, a_r, a_st = w(s_u, m_u, seed, *vec)
    b_s, b_r, b_st = SR.scrub_ref(s_u, m_u, seed, *vec)
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
                with uncounted("scrub") as w:
                    sc, res, st = w(s_u, m_u, seed, *vec)
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
        # all 32 planes flip in every lane: the longest queue of flipped
        # planes a warp can have
        ("bf16_admission_all_flip", (36, 1, 288, 2, 128), torch.bfloat16,
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
        if name.endswith("all_flip"):
            n_u = o_u ^ -1
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
#: the hybrid path's prompts: longer than recurrentgemma-2b's window
PROMPT_LEN_HYBRID = 3072


def serve_full(eng, prompt_len, scrub_policy=None):
    """Drive a path once at full width: the 8 requests through the
    continuous scheduler, every burst under
    ``set_sync_debug_mode("error")``; checks the tokens and the ledger.
    The caller sets the launch counts to 0 just before and reads them
    just after. Returns (report, scheduler, wall seconds)."""
    import numpy as np
    import torch
    from repro_torch.serve import ContinuousScheduler, Request
    cfg = eng.cfg
    rs = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt={"tokens": torch.from_numpy(
        rs.integers(0, cfg.vocab_size, (1, prompt_len))).to(eng.device)},
        new_tokens=NEW_TOKENS, arrival=4 * i,
        app_id="chat" if i % 2 else "batch") for i in range(N_REQ)]
    sch = ContinuousScheduler(eng, capacity=CAPACITY,
                              scrub_policy=scrub_policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = sch.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = [rep["requests"][i]["tokens"] for i in range(N_REQ)]
    if any(len(t) != NEW_TOKENS for t in toks) or not all(
            0 <= x < cfg.vocab_size for t in toks for x in t):
        raise AssertionError("full-width serve: bad token output")
    tot = rep["total"]
    if not (math.isfinite(tot["energy_pj"]) and tot["energy_pj"] > 0
            and 0.0 < tot["ber_realized"] < 0.1):
        raise AssertionError(f"full-width serve: implausible ledger {tot}")
    return rep, sch, wall


def check_write_launches(launches, rep) -> None:
    """Two extent_write launches (one per K and V leaf) per admission
    group and per decode step, and none elsewhere."""
    groups = rep["pool"]["admission_groups"]
    expected = 2 * (groups + rep["decode_steps"])
    if launches["extent_write"] != expected or expected <= 0:
        raise AssertionError(f"extent_write launches {launches} != "
                             f"2 x (admission groups {groups} + decode "
                             f"steps {rep['decode_steps']}) = {expected}")


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
    reset_launches()
    rep, sch, wall = serve_full(eng, PROMPT_LEN)
    launches = read_launches()
    check_write_launches(launches, rep)
    if any(launches[k] for k in ("scrub", "local_attention", "kv_quant")):
        raise AssertionError(f"the dense retention-off path launched "
                             f"another kernel: {launches}")
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
    from repro_torch.reliability import make_scrub_policy
    from repro_torch.serve import ServingEngine
    eng = ServingEngine(eng_full.cfg, dataclasses.replace(
        eng_full.scfg, retention_scale=1000.0, ambient_k=350.0),
        eng_full.params, device=device)
    step_ms = decode_step_ms(eng, PROMPT_LEN, CAPACITY)
    reset_launches()
    rep, sch, wall = serve_full(eng, PROMPT_LEN,
                                make_scrub_policy("periodic", interval=8))
    launches = read_launches()
    check_write_launches(launches, rep)
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
    vec = eng.vectors_for_floor(Priority.LOW)
    with uncounted("scrub"):
        scrub_ms = cuda_ms(lambda: eng.scrub(key, sch.pool.cache, sch.life,
                                             vec), iters=10, warmup=2)
    emit({"phase": "retention", "arch": eng.cfg.name,
          "scrub_interval": 8, "clock_steps": rep["clock_steps"],
          "decode_steps": rep["decode_steps"], "bursts": rep["bursts"],
          "wall_s": wall, "tokens_per_s": N_REQ * NEW_TOKENS / wall,
          "decode_ms_per_step_b4": step_ms,
          "decay_ms_per_step": decay_ms, "scrub_ms_per_pass": scrub_ms,
          "peak_mem_bytes": peak, "bursts_sync_free": True,
          "launches": launches, **lt, "ok": True})
    return launches["scrub"], sch


def att_inputs(B, S, H, Kh, h, dtype, seed, device, q_scale=1.0):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=device)
               for shape in ((B, S, H, h), (B, S, Kh, h), (B, S, Kh, h)))
    return (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)


def plain_f32(q, k, v, window, softcap=0.0):
    """The kernel's plain version in float32 on the inputs as given,
    rounded to their type and returned in float32."""
    from repro_torch.kernels.local_attention import ref as LR
    out = LR.local_attention_ref(q.float(), k.float(), v.float(),
                                 window=window, softcap=softcap)
    return out.to(q.dtype).float()


def att_check(out, ref, dtype):
    """(max |out - ref|, max of |out - ref| over its tolerance)."""
    atol, rtol = ATT_TOL[str(dtype)[6:]]
    diff = (out.float() - ref).abs()
    return float(diff.max()), float((diff / (atol + rtol * ref.abs())).max())


def att_cases():
    """The local_attention kernel's on-card cases: (name, B, S, H, Kh, h,
    window, dtype, softcap, query scale). Every route and every head width
    of the wgmma route has cases; a query scale of 8 makes the logits
    large enough for the softcap to act."""
    return [
        ("hybrid_prefill", *hybrid_att_shape(), "bfloat16", 0.0, 1.0),
        ("f32_gqa_softcap", 2, 512, 8, 2, 64, 128, "float32", 50.0, 8.0),
        ("bf16_gqa_softcap", 2, 512, 8, 2, 64, 128, "bfloat16", 50.0, 8.0),
        ("bf16_mha_softcap", 1, 512, 4, 4, 128, 100, "bfloat16", 30.0, 8.0),
        # the wgmma route: ragged S (333, 3000), B 2, windows 100 and
        # 2048, GQA 2:1 and 10:1, the softcap on, at h 64, 128 and 256
        ("bf16_h64_b2_s333_gqa2", 2, 333, 4, 2, 64, 100, "bfloat16", 0.0,
         1.0),
        ("bf16_h64_s3000_gqa10_softcap", 1, 3000, 10, 1, 64, 2048,
         "bfloat16", 30.0, 8.0),
        ("bf16_h128_b2_s333_gqa2_softcap", 2, 333, 4, 2, 128, 100,
         "bfloat16", 30.0, 8.0),
        ("bf16_h128_s3000_gqa10", 1, 3000, 10, 1, 128, 2048, "bfloat16",
         0.0, 1.0),
        ("bf16_h256_b2_s333_gqa2_softcap", 2, 333, 4, 2, 256, 100,
         "bfloat16", 30.0, 8.0),
        ("bf16_h256_b2_s3000_gqa10", 2, 3000, 10, 1, 256, 2048, "bfloat16",
         0.0, 1.0),
        ("f32_ragged_h80", 1, 333, 4, 1, 80, 64, "float32", 0.0, 1.0),
        ("bf16_ragged_h80", 1, 333, 4, 1, 80, 64, "bfloat16", 0.0, 1.0),
        ("f32_window_ge_s", 1, 200, 2, 1, 32, 10_000, "float32", 0.0, 1.0),
        ("bf16_window_ge_s", 1, 200, 2, 1, 32, 10_000, "bfloat16", 0.0,
         1.0),
        ("reduced_hybrid", 2, 24, 4, 1, 16, 16, "float32", 0.0, 1.0),
        ("bf16_reduced_hybrid", 2, 24, 4, 1, 16, 16, "bfloat16", 0.0, 1.0),
    ]


def phase_local_attention_kernel(device):
    """The kernel against its plain version on the card, every case of
    ``att_cases``; the route the C dispatch takes is held against
    ``kernel.route``."""
    import torch
    from repro_torch.kernels.local_attention import kernel as LK
    from repro_torch.kernels.local_attention import ops as LO
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (name, B, S, H, Kh, h, window, dt, cap, qs) in enumerate(
            att_cases()):
        dtype = getattr(torch, dt)
        q, k, v = att_inputs(B, S, H, Kh, h, dtype, 400 + i, device, qs)
        with uncounted("local_attention") as w:
            out = LO.local_attention(q, k, v, window=window, softcap=cap)
            c_route = LK.ROUTES[w.c_route(int(dtype == torch.bfloat16), h)]
        if c_route != LK.route(dtype, h):
            raise AssertionError(f"{name}: the C dispatch takes {c_route}, "
                                 f"kernel.route says {LK.route(dtype, h)}")
        err, ratio = att_check(out, plain_f32(q, k, v, window, cap), dtype)
        atol, rtol = ATT_TOL[dt]
        ok = ratio <= 1.0
        emit({"phase": "local_attention_kernel", "case": name,
              "route": c_route,
              "shape": {"B": B, "S": S, "H": H, "Kh": Kh, "h": h},
              "window": window, "softcap": cap, "dtype": dt,
              "max_abs_err": err, "max_err_over_tol": ratio,
              "atol": atol, "rtol": rtol, "ok": ok})
        if not ok:
            raise AssertionError(f"local_attention disagrees with its "
                                 f"plain version: {name}, {err}")
        worst[dt] = max(worst[dt], err)
        del q, k, v, out
    return worst


def check_kv_quant(flat, seed, level):
    """kv_quant kernel against its twin on one flat tensor: payload,
    scales (bit for bit) and error counts equal. Returns the twin's
    summed errors and the measured differences: the largest |payload
    difference|, the number of scale words that differ and the largest
    |error count difference| per block."""
    import torch
    from repro_torch.kernels.kv_quant import kernel as QK
    from repro_torch.kernels.kv_quant import ops as QO
    from repro_torch.kernels.kv_quant import ref as QR
    thr = QO.threshold_tensor(level, flat.device)
    with uncounted("kv_quant") as w:
        q_k, s_k, e_k = w(flat, seed, thr)
    q_r, s_r, e_r = QR.kv_quant_ref(QK.pad_rows(flat), seed, thr)
    q_r = q_r.reshape(-1)[:flat.numel()]
    diff = {"payload_max_abs_diff": int(
                (q_k.int() - q_r.int()).abs().max()),
            "scale_words_differing": int(
                (s_k.view(torch.int32) != s_r.view(torch.int32)).sum()),
            "error_count_max_diff": int((e_k - e_r).abs().max())}
    if q_k.shape != q_r.shape or s_k.shape != s_r.shape or any(
            diff.values()):
        raise AssertionError(f"kv_quant disagrees with its twin at "
                             f"{flat.numel()} elements, level {level}: "
                             f"{diff}")
    return int(e_r.sum()), diff


def kv_quant_cases():
    """(name, flat float32 values, dtype) of kv_quant's adversarial cases,
    from fixed integer seeds, each value exactly representable in its
    dtype. The CPU tests hold the twin against the JAX reference on them,
    and ``kv_quant_inputs`` the kernel against the twin. Each aims at one
    edge of the kernel's arithmetic or layout: quotients x / scale on
    exact half-integers (round half to even decides), an all-zero block
    (scale from the 1e-12 clamp, no draws), a block of -1 payloads (every
    bit set: the most draws), a block whose absmax is below 1e-12, +0 and
    -0 mixed in, values at exactly +-absmax (+-127), and lengths 1, 8191
    and 8193 around one 8192-element block."""
    import numpy as np
    import torch
    from repro_torch.kernels.kv_quant.ref import BLOCK, QMAX_INV
    n_block = BLOCK[0] * BLOCK[1]

    def half_integers(rng, absmax):
        # two blocks whose quotients by the kernel's block scale are
        # exactly k + 1/2 (|k + 1/2| <= 126.5), each holding one +absmax
        s = np.float32(max(np.float32(absmax), np.float32(1e-12))) \
            * np.float32(QMAX_INV)
        k = np.arange(-127, 127, dtype=np.float32) + np.float32(0.5)
        x = k * s                                   # float32 products
        x = x[(x / s) == k]                         # quotients exactly k + 1/2
        out = rng.choice(x, size=2 * n_block).astype(np.float32)
        out[::n_block] = np.float32(absmax)
        return out

    cases = []
    # 127 / 127 is a scale of exactly 1 (bf16 holds every k + 1/2 there);
    # 3 gives an inexact scale, so the division itself lands on k + 1/2
    cases.append(("half_integers_bf16",
                  half_integers(np.random.default_rng(11), 127.0),
                  "bfloat16"))
    cases.append(("half_integers_f32",
                  half_integers(np.random.default_rng(12), 3.0), "float32"))
    cases.append(("zero_block", np.zeros(n_block, np.float32), "float32"))
    minus = np.full(n_block, -1.0, np.float32)  # q = -1: byte 0xFF
    minus[0] = 127.0                            # absmax 127, scale 1
    cases.append(("minus_one_block", minus, "bfloat16"))
    cases.append(("absmax_below_1e-12",
                  np.random.default_rng(13).uniform(
                      -9e-13, 9e-13, n_block).astype(np.float32),
                  "float32"))
    rng = np.random.default_rng(14)
    x = rng.standard_normal(n_block + 100).astype(np.float32)
    zeros = rng.random(x.size) < 0.4
    x[zeros] = np.where(rng.random(zeros.sum()) < 0.5, 0.0, -0.0)
    cases.append(("signed_zeros", x, "bfloat16"))
    rng = np.random.default_rng(15)
    x = np.clip(rng.standard_normal(n_block), -3.9, 3.9).astype(np.float32)
    edge = rng.random(n_block) < 0.25
    x[edge] = np.where(rng.random(edge.sum()) < 0.5, 4.0, -4.0)
    cases.append(("at_absmax", x, "float32"))
    for n in (1, n_block - 1, n_block + 1):
        for i, dtype in enumerate(("bfloat16", "float32")):
            x = np.random.default_rng(16 + 2 * n + i).standard_normal(
                n).astype(np.float32) * 2.0
            cases.append((f"n{n}_{dtype}", x, dtype))
    # each case rounded to its dtype and back: exact in that dtype
    return [(name, torch.from_numpy(np.ascontiguousarray(x, np.float32))
             .to(getattr(torch, dtype)).float().numpy(), dtype)
            for name, x, dtype in cases]


def kv_quant_inputs(device):
    """(name, tensor) of every kv_quant case: the CPU tests' shapes
    (random, from seeds), their adversarial cases (``kv_quant_cases``),
    and flat views that start 1, 3 or 7 elements past a 16-byte boundary
    (not aligned to a vector)."""
    import torch
    out = []
    for i, (name, shape, dtype) in enumerate([
            ("bench", (64, 128), torch.bfloat16),
            ("ragged", (3, 1000, 7), torch.float32),
            ("hybrid_att_reduced", (1, 2, 16, 1, 16), torch.float32)]):
        g = torch.Generator(device=device)
        g.manual_seed(500 + i)
        out.append((name, (torch.randn(shape, generator=g, device=device)
                           * 2).to(dtype)))
    for name, x, dtype in kv_quant_cases():
        out.append((name, torch.from_numpy(x).to(device,
                                                 getattr(torch, dtype))))
    g = torch.Generator(device=device)
    g.manual_seed(510)
    base = torch.randn((3 * 8192 + 5,), generator=g, device=device) * 2
    for dtype, offsets in ((torch.bfloat16, (1, 7)), (torch.float32, (1, 3))):
        whole = base.to(dtype)
        for off in offsets:
            out.append((f"offset{off}_{str(dtype)[6:]}", whole[off:]))
    return out


def phase_kv_quant_kernel(device):
    """The kernel against its twin on every case of ``kv_quant_inputs``
    at levels LOW, MID, HIGH and EXACT. Returns the largest |payload
    difference| (the checks raise on any)."""
    from repro_torch.core.priority import Priority
    worst = 0
    for i, (name, x) in enumerate(kv_quant_inputs(device)):
        flat = x.reshape(-1)
        for level in (Priority.LOW, Priority.MID, Priority.HIGH,
                      Priority.EXACT):
            errors, diff = check_kv_quant(flat, 0x5EED + i, level)
            worst = max(worst, diff["payload_max_abs_diff"])
            emit({"phase": "kv_quant_kernel", "case": name,
                  "shape": list(x.shape), "dtype": str(x.dtype)[6:],
                  "offset_bytes": flat.data_ptr() % 16,
                  "level": level.name, "errors": errors, **diff,
                  "ok": True})
    return worst


def hybrid_trace():
    """Four 24-token requests (longer than the reduced window of 16) over
    capacity 2, the recipe of tests/test_torch_rglru.py."""
    import numpy as np
    from repro_torch.workload import Trace, TraceEvent
    rs = np.random.default_rng(13)
    events = [TraceEvent(rid=i, arrival=a, tokens=rs.integers(0, 256, 24),
                         new_tokens=n, quality=q, app_id=app, session=i)
              for i, (a, n, q, app) in enumerate([
                  (0, 5, "low", "batch"), (1, 4, "high", "chat"),
                  (3, 6, "low", "batch"), (4, 3, "high", "chat")])]
    return Trace(events=events, vocab_size=256, family="hybrid")


@contextlib.contextmanager
def plain_local_attention():
    """Inside, the model's prefill attention runs the kernel's plain
    version, asked for by name (on the card the entry point launches the
    kernel)."""
    from repro_torch.kernels.local_attention import ops as LO
    from repro_torch.kernels.local_attention import ref as LR
    saved = LO.local_attention
    LO.local_attention = LR.local_attention_ref
    try:
        yield
    finally:
        LO.local_attention = saved


def serve_hybrid_trace(cfg, params, backend, device):
    from repro_torch.serve import (ContinuousScheduler, ServeConfig,
                                   ServingEngine)
    from repro_torch.workload import TraceSource
    trace = hybrid_trace()
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        backend=backend), params, device=device)
    return ContinuousScheduler(eng, capacity=2).run(
        TraceSource(trace, cfg, device))


def phase_reduced_hybrid(device):
    """Reduced recurrentgemma-2b through the kernels and through the plain
    versions. The attention kernel sums in its own order, so later
    layers' K/V may differ in the last bit: flips and energy are held at
    1.5% per request and errors at three Poisson deviations (the CPU
    tests' tolerances for float32 last-bit differences)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.rglru import layer_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("recurrentgemma-2b").reduced()
    params = get_model(cfg).init(0, device)
    reset_launches()
    rep_k = serve_hybrid_trace(cfg, params, "cuda", device)
    launches = read_launches()
    reset_launches()
    with plain_local_attention():
        rep_r = serve_hybrid_trace(cfg, params, "lanes_ref", device)
    if any(read_launches().values()):
        raise AssertionError("the plain run launched a kernel")
    check_write_launches(launches, rep_k)
    n_att = layer_counts(cfg)[1]
    if launches["local_attention"] != (n_att * rep_k["pool"]
                                       ["admission_groups"]):
        raise AssertionError(f"reduced hybrid: launches {launches}")
    worst = 0.0
    for rid, b in rep_r["requests"].items():
        a = rep_k["requests"][rid]
        if a["tokens"] != b["tokens"]:
            raise AssertionError(f"reduced hybrid: req {rid} tokens")
        for f in ("flips", "energy_pj"):
            rel = abs(a[f] - b[f]) / max(abs(b[f]), 1e-30)
            worst = max(worst, rel)
            if rel > 1.5e-2:
                raise AssertionError(f"reduced hybrid: req {rid} {f}")
        if abs(a["errors"] - b["errors"]) > 3 * b["errors"] ** 0.5 + 1:
            raise AssertionError(f"reduced hybrid: req {rid} errors")
    emit({"phase": "reduced_hybrid", "tf32": False,
          "requests": len(rep_k["requests"]),
          "clock_steps": rep_k["clock_steps"], "bursts": rep_k["bursts"],
          "launches": launches, "tokens_identical": True,
          "flips": [rep_k["total"]["bits_written"],
                    rep_r["total"]["bits_written"]],
          "errors": [rep_k["total"]["bit_errors"],
                     rep_r["total"]["bit_errors"]],
          "energy_pj": [rep_k["total"]["energy_pj"],
                        rep_r["total"]["energy_pj"]],
          "max_rel_diff_per_request": worst, "ok": True})


def kv_rel_err(q, s, x) -> float:
    """Mean |dequantised - x| over mean |x| (the reference benchmark's
    int8 fidelity figure)."""
    import torch
    from repro_torch.kernels.kv_quant import kv_dequant
    xf = x.float()
    return float((kv_dequant(q, s, torch.float32) - xf).abs().mean()
                 / xf.abs().mean())


def phase_hybrid(device):
    """recurrentgemma-2b at full published width: the 8 requests of
    3072-token prompts, then the int8 store of the served K and V."""
    import torch
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.kv_quant import kv_quant_store
    from repro_torch.models import get_model
    from repro_torch.models.rglru import layer_counts
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config("recurrentgemma-2b")
    t0 = time.perf_counter()
    params = get_model(cfg).init(0, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=PROMPT_LEN_HYBRID + NEW_TOKENS, max_new_tokens=NEW_TOKENS,
        backend="cuda"), params, device=device)
    # warm-up and the two step times, none of it counted
    step_ms = decode_step_ms(eng, PROMPT_LEN_HYBRID, CAPACITY)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN_HYBRID),
                           device=device)
    # the median of five timed prefills after a warm-up one: the prefill's
    # host work makes one sample noisy
    prefill_runs = []
    with uncounted("local_attention"):
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.api.prefill(params, {"tokens": prompt}, eng.scfg.max_seq)
            torch.cuda.synchronize()
            prefill_runs.append((time.perf_counter() - t0) * 1e3)
    prefill_runs = prefill_runs[1:]
    prefill_ms = sorted(prefill_runs)[2]
    reset_launches()
    rep, sch, wall = serve_full(eng, PROMPT_LEN_HYBRID)
    peak = torch.cuda.max_memory_allocated()
    served = sch.pool.cache["att"]
    stores = {name: kv_quant_store(rng.PRNGKey(8 + i), served[name],
                                   level=Priority.MID)
              for i, name in enumerate(("k", "v"))}
    torch.cuda.synchronize()
    launches = read_launches()
    check_write_launches(launches, rep)
    n_att = layer_counts(cfg)[1]
    groups = rep["pool"]["admission_groups"]
    if not (launches["local_attention"] == n_att * groups > 0
            and launches["kv_quant"] == 2 and launches["scrub"] == 0):
        raise AssertionError(f"hybrid: launches {launches}, {groups} "
                             f"admission groups")
    tot = rep["total"]
    emit({"phase": "hybrid", "arch": cfg.name,
          "params": eng.api.num_params(), "init_s": init_s,
          "requests": N_REQ, "capacity": CAPACITY,
          "prompt_len": PROMPT_LEN_HYBRID, "new_tokens": NEW_TOKENS,
          "ring_capacity": served["k"].shape[2],
          "clock_steps": rep["clock_steps"],
          "decode_steps": rep["decode_steps"], "bursts": rep["bursts"],
          "admission_groups": groups, "wall_s": wall,
          "tokens_per_s": N_REQ * NEW_TOKENS / wall,
          "decode_ms_per_step_b4": step_ms, "prefill_ms_b1": prefill_ms,
          "prefill_ms_b1_runs": prefill_runs,
          "peak_mem_bytes": peak, "kv_write_energy_pj": tot["energy_pj"],
          "ber": tot["ber_realized"],
          "write_skip_rate": tot["write_skip_rate"],
          "bursts_sync_free": True, "launches": launches,
          "int8_kv": {name: {"errors": int(st["errors"]),
                             "bytes_saved": st["bytes_saved"],
                             "rel_err_mid": kv_rel_err(q, s, served[name])}
                      for name, (q, s, st) in stores.items()},
          "ok": True})
    # the int8 store held against its twin at the served leaves
    worst = 0
    for i, name in enumerate(("k", "v")):
        seed = int(rng.bits(rng.PRNGKey(8 + i), (1,))[0])
        errors, diff = check_kv_quant(served[name].reshape(-1), seed,
                                      Priority.MID)
        worst = max(worst, diff["payload_max_abs_diff"])
        emit({"phase": "kv_quant_kernel", "case": f"served_{name}",
              "shape": list(served[name].shape), "dtype": "bfloat16",
              "level": "MID", "errors": errors, **diff,
              "rel_err_mid": kv_rel_err(*stores[name][:2], served[name]),
              "ok": True})
    return launches, sch, worst


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
    from repro_torch.kernels.extent_write import ref
    with uncounted("extent_write") as w:
        s_k, st_k = w(o_u, n_u, seed, *vec)
    s_r, st_r = ref.extent_write_ref(o_u, n_u, seed, *vec)
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


def time_calls(name, kernel_name, call, plain, reps, per=1):
    """The kernel's device time per launch (torch.profiler's kernel rows
    named ``kernel_name``), and per launch the wrapper call's and the
    plain version's (CUDA events around loops of ``call()`` and
    ``plain()``, each making ``per`` launches); launches not counted."""
    with uncounted(name):
        dev = device_ms(call, kernel_name, max(5, reps // 5))
        call_ms = cuda_ms(call, reps) / per
    return {"ms": dev if dev is not None else call_ms,
            "ms_is": ("kernel device time (torch.profiler)"
                      if dev is not None else
                      "wrapper call (CUDA events): no profiler device time"),
            "device_ms": dev, "wrapper_ms": call_ms,
            "plain_ms": cuda_ms(plain, max(3, reps // 10)) / per}


def time_kernel(name, twin, kernel_name, args, bytes_per_lane, flips):
    """``time_calls`` over the lane argument tuples ``args``, with the
    bound: the largest of the bytes moved (``bytes_per_lane``, each input
    read and output written once) over the HBM rate, one f32 energy add
    per flipped bit over the f32 rate, and one counter-hash draw per
    flipped bit on the integer pipes (``int_bound_ms``)."""
    lanes = sum(a[0].numel() for a in args)
    iters = 200 if lanes < 1 << 20 else 50

    def run(fn):
        return lambda: [fn(*a) for a in args]

    terms = {"bytes": bytes_per_lane * lanes / HBM_BYTES_PER_S * 1e3,
             "f32_energy_adds": flips / F32_FLOPS * 1e3,
             "int_draws": int_bound_ms(flips)}
    terms = {k: v / len(args) for k, v in terms.items()}
    return {"lanes_per_launch": lanes // len(args),
            "flips_per_launch": flips / len(args),
            **time_calls(name, kernel_name, run(kernel_wrapper(name)),
                         run(twin), iters, per=len(args)),
            "bound_ms": max(terms.values()), "bound_terms_ms": terms,
            "bound_by": ("bytes" if terms["bytes"] >= max(terms.values())
                         else "operations")}


def warp_flips(o_u, n_u):
    """Flipped planes of each warp step of the kernel (32 consecutive
    lanes), as flips a lane: (share of steps at 16 or more, largest)."""
    import torch
    table = torch.tensor([bin(v).count("1") for v in range(256)],
                         dtype=torch.int32, device=o_u.device)
    per_lane = table[(o_u ^ n_u).contiguous().view(torch.uint8)
                     .to(torch.int64)].view(-1, 4).sum(1)
    pad = -per_lane.numel() % 32
    steps = torch.nn.functional.pad(per_lane, (0, pad)).view(-1, 32).sum(1)
    return (float((steps >= 16 * 32).float().mean()),
            float(steps.max()) / 32)


def time_writes(name, writes):
    """extent_write over a list of (old lanes, new lanes, vectors), held
    against the twin, then timed (12 bytes per lane). ``warp_steps_16``
    is the share of the kernel's warp steps whose lanes average 16 or
    more flipped planes, the longest queues."""
    from repro_torch.kernels.extent_write import ref
    worst, flips, dense, peak = 0, 0, 0.0, 0.0
    for o, n, vec in writes:
        d, f = check_against_twin(o, n, 1, vec)
        worst, flips = max(worst, d), flips + f
        share, most = warp_flips(o, n)
        dense, peak = dense + share / len(writes), max(peak, most)
    return {"shape": name, "max_abs_err": worst, "warp_steps_16": dense,
            "warp_step_flips_per_lane_max": peak, **time_kernel(
        "extent_write", ref.extent_write_ref, "extent_write_kernel",
        [(o, n, 1, *vec) for o, n, vec in writes], 12, flips)}


def time_scrubs(name, scrubs):
    """scrub over a list of (stored lanes, mask lanes, vectors), held
    against the twin, then timed (16 bytes per lane)."""
    from repro_torch.kernels.scrub import ref as SR
    worst, rel, flips = 0, 0.0, 0
    for su, mu, vec in scrubs:
        d, r, f = check_scrub(su, mu, 1, vec)
        worst, rel, flips = max(worst, d), max(rel, r), flips + f
    return {"shape": name, "max_abs_err": worst, "energy_rel_err": rel,
            **time_kernel("scrub", SR.scrub_ref, "scrub_kernel",
                          [(su, mu, 1, *vec) for su, mu, vec in scrubs],
                          16, flips)}


def extent_write_entry(launches, worst_abs, worst_rel, eng, sch, device):
    """Times at the full path's shapes: an admission writes the K and V
    rows (36, 1, 288, 2, 128) bf16 of one new prompt — real prefill rows,
    zero past the prompt — over a cold slot (zeros) or over the stale rows
    a finished request of the run left there (and, as the worst case,
    over their complement); a decode step writes one ring column
    (36, 4, 1, 2, 128) bf16 per leaf."""
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
        # the worst case: every plane of every lane flips
        "admission_all_flip": time_writes(
            f"{row}, every bit flipped",
            [(o, o ^ -1, v) for o, _, v in admission(stale)]),
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
        "bound_terms_ms": adm["bound_terms_ms"],
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
        "bound_terms_ms": run["bound_terms_ms"],
        # no single PyTorch call computes the corrective re-write
        "library_ms": None, "shape": run["shape"], "at": timings}


def live_pairs(S, window) -> int:
    """(query, key) pairs with 0 <= i - j < window in a causal band."""
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def hybrid_att_shape():
    """(B, S, H, Kh, h, window) of one prefill of the hybrid path."""
    from repro_torch.configs import get_config
    cfg = get_config("recurrentgemma-2b")
    return (1, PROMPT_LEN_HYBRID, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.local_window)


def local_attention_entry(launches, worst, registers, device):
    """Times at the hybrid prefill's shape: B 1, S 3072, 10 query heads
    over 1 KV head of 256, window 2048, bf16. The bound is the larger of
    4 H h FLOP per live pair at the bf16 tensor-core rate and the bytes
    of q, k, v and the output at the HBM rate; ``bound_ms_split_p`` counts
    the p.v products twice, as the split p makes them. The library time
    is one scaled_dot_product_attention call with a boolean band mask
    (GQA broadcast). Kernel and library call are held against the plain
    version in float32 on the same inputs. ``registers`` is ptxas's report
    of the served instance."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.local_attention import kernel as LK
    from repro_torch.kernels.local_attention import ops as LO
    from repro_torch.kernels.local_attention import ref as LR
    B, S, H, Kh, h, W = hybrid_att_shape()
    q, k, v = att_inputs(B, S, H, Kh, h, torch.bfloat16, 7, device)
    ref = plain_f32(q, k, v, W)
    with uncounted("local_attention"):
        err, ratio = att_check(LO.local_attention(q, k, v, window=W), ref,
                               torch.bfloat16)
    if ratio > 1.0:
        raise AssertionError(f"local_attention disagrees with its plain "
                             f"version on the timed inputs: {err}")
    t = time_calls("local_attention", "local_attention_kernel",
                   lambda: LO.local_attention(q, k, v, window=W),
                   lambda: LR.local_attention_ref(q, k, v, window=W), 20)
    i = torch.arange(S, device=device)
    d = i[:, None] - i[None, :]
    band = (d >= 0) & (d < W)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                              enable_gqa=True)

    # SDPA rounds its probabilities to bf16 before p.v (a relative 2^-8
    # each), so on top of the kernel's tolerance it may differ by 2^-7 of
    # sum_j p_j |v_j| (the plain version over |v|)
    atol, rtol = ATT_TOL["bfloat16"]
    spread = LR.local_attention_ref(q.float(), k.float(), v.float().abs(),
                                    window=W)
    lib_diff = (sdpa().transpose(1, 2).float() - ref).abs()
    lib_err = float(lib_diff.max())
    lib_ratio = float((lib_diff / (atol + rtol * (ref.abs() + spread)))
                      .max())
    if lib_ratio > 1.0:
        raise AssertionError(f"band-masked SDPA differs from the plain "
                             f"version: {lib_err}")
    del ref, spread, lib_diff
    library_ms = cuda_ms(sdpa, 20)
    flops = 4 * H * h * live_pairs(S, W) * B
    n_bytes = 2 * (2 * B * S * H * h + 2 * B * S * Kh * h)
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return {
        "name": "local_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/local_attention.cu",
        "replaces": "src/repro/kernels/local_attention/kernel.py:82",
        "cuda_route": LK.route(q.dtype, h), "registers": registers,
        "launches": launches, "max_abs_err": max(err, *worst.values()),
        "max_abs_err_by_dtype": worst, "timed_inputs_max_abs_err": err,
        "timed_inputs_max_err_over_tol": ratio, **t,
        "bound_ms": max(t_ops, t_bytes),
        "bound_ms_split_p": max(t_ops * 1.5, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": n_bytes, "library_ms": library_ms,
        "library": "scaled_dot_product_attention, boolean band mask",
        "library_max_abs_diff": lib_err,
        "library_max_diff_over_tol": lib_ratio,
        "shape": f"q ({B}, {S}, {H}, {h}) k/v ({B}, {S}, {Kh}, {h}) "
                 f"bfloat16, window {W}"}


def kv_quant_entry(launches, worst, registers, sch):
    """Times at the served cache's K leaf (8, 4, 2048, 1, 256) bf16, held
    against the twin on the timed inputs first. The bound is the larger of
    its bytes (2 read and 1 written per element) at the HBM rate and its
    counter-hash draws on the integer pipes (``int_bound_ms``): one draw
    per set payload bit, counted on the twin's bytes stored with zero
    thresholds (q itself, before failures). The plain version is the twin
    on the padded float32 rows. ``worst`` is the largest |payload
    difference| the earlier checks measured; ``registers`` ptxas's line
    of the bfloat16 instance."""
    import torch
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.kv_quant import kernel as QK
    from repro_torch.kernels.kv_quant import ops as QO
    from repro_torch.kernels.kv_quant import ref as QR
    flat = sch.pool.cache["att"]["k"].reshape(-1)
    thr = QO.threshold_tensor(Priority.MID, flat.device)
    _, diff = check_kv_quant(flat, 1, Priority.MID)
    q, _, _ = QR.kv_quant_ref(QK.pad_rows(flat), 1, torch.zeros_like(thr))
    table = torch.tensor([bin(v).count("1") for v in range(256)],
                         dtype=torch.int64, device=flat.device)
    draws = int(table[q.reshape(-1).view(torch.uint8).to(torch.int64)]
                .sum())
    del q
    t = time_calls("kv_quant", "kv_quant_kernel",
                   lambda: QK.kv_quant_cuda(flat, 1, thr),
                   lambda: QR.kv_quant_ref(QK.pad_rows(flat), 1, thr), 50)
    n_bytes = flat.numel() * (flat.element_size() + 1)
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "int_draws": int_bound_ms(draws)}
    return {
        "name": "kv_quant", "route": "cuda",
        "source": "src/repro_torch/csrc/kv_quant.cu",
        "replaces": "src/repro/kernels/kv_quant/kernel.py:74",
        "launches": launches,
        "max_abs_err": max(worst, diff["payload_max_abs_diff"]),
        "timed_inputs": diff, **t,
        "bound_ms": max(terms.values()), "bound_terms_ms": terms,
        "bound_by": ("bytes" if terms["bytes"] >= terms["int_draws"]
                     else "operations"),
        "draws_per_element": draws / flat.numel(),
        "int_ops_per_draw": {k: draw_cost()[k]
                             for k in ("alu", "fma", "total")},
        "int_ops_from": draw_cost()["ops_from"],
        "sm_clocks_per_draw": draw_cost()["sm_clocks_per_draw"],
        "sm_clock_max_mhz": draw_cost()["sm_clock_max_mhz"],
        "registers": registers["registers"],
        "spill_bytes": registers["spill_stores"] + registers["spill_loads"],
        "bytes": n_bytes,
        # no single PyTorch call quantises and stores through the
        # erased-row write model
        "library_ms": None,
        "shape": f"{tuple(sch.pool.cache['att']['k'].shape)} bfloat16 = "
                 f"{flat.numel()} elements, level MID"}


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
    att_registers, q_registers = phase_build()
    worst_abs, worst_rel = phase_kernel(device)
    s_abs, s_rel = phase_scrub_kernel(device)
    att_worst = phase_local_attention_kernel(device)
    q_worst = phase_kv_quant_kernel(device)
    phase_reduced(device)
    phase_reduced_hybrid(device)
    launches, eng, sch = phase_full(device)
    s_launches, r_sch = phase_retention(device, eng)
    # the dense path's entries are timed on its own state, which is then
    # freed, so the hybrid phase's peak memory is its own
    entries = [extent_write_entry(launches, worst_abs, worst_rel, eng, sch,
                                  device),
               scrub_entry(s_launches, s_abs, s_rel, r_sch, device)]
    del eng, sch, r_sch
    gc.collect()
    torch.cuda.empty_cache()
    h_launches, h_sch, served_worst = phase_hybrid(device)
    entries += [local_attention_entry(h_launches["local_attention"],
                                      att_worst, att_registers, device),
                kv_quant_entry(h_launches["kv_quant"],
                               max(q_worst, served_worst), q_registers,
                               h_sch)]
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": entries})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
