"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device. Phases,
each printed as one JSON line:

  1. device       — the card's name and power limit (nvidia-smi);
  2. build        — compiles every kernel of src/repro_torch/csrc/ (four
                    sources) with nvcc, one process per source, all
                    started together; beside them nvcc reads ptxas's
                    registers and spills of local_attention's wgmma
                    kernels, of kv_quant's and of scrub's (-Xptxas -v):
                    the served instances (h 256; bfloat16) must not
                    spill; and one
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
                    of one, every bit of every lane set (float32 and
                    bf16), float32 at a checkpoint restore's density over
                    2^22 + 3 lanes, and lane vectors 4 bytes past a
                    16-byte boundary. Scrubbed words, residual masks and
                    counts bit-exact, energy equal (both price the same
                    per-plane counts with ref.stats_from_partials);
  5. reduced      — reduced qwen2.5-3b in float32 (TF32 off) serving
                    tests/fixtures/trace_smoke.jsonl through the kernels
                    and through the twins: without retention, then at
                    400 K with periodic scrubbing over whole leaves and
                    over column windows. Tokens, flips, errors, the
                    lifetime counters and scrub energies identical, other
                    energies rtol 1e-5; a
                    300 K run with retention on equals one with it off;
                    then wear leveling (groups of 4 columns, rotating)
                    with an endurance budget of 6, retention and windowed
                    scrubbing through the rotation: the same reports and
                    the same row-group wear through both;
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
  7a. telemetry   — the ``full`` traffic with telemetry on, beside a run
                    with it off: equal to ``full`` in tokens, flips,
                    errors, energies and extent_write launches; drains
                    equal events; every telemetry call runs under
                    set_sync_debug_mode("error") (no device read), the
                    finalize landing is one registry.land (timed); the
                    Chrome trace validates against the schema fixture;
                    tokens/s on and off;
  7b. shards      — the ``retention`` traffic on a pool split over dies:
                    shards 2 and 4 alike equal ``retention`` in every
                    count, energy and launch; shards 2 with die 1 at
                    400 K: die 1's extra die-masked scrub passes, one
                    die-masked pass on the end state through the kernel
                    equal to the twin's bit for bit (timed, its kernel
                    against the 16 B a lane bound), the decay's ms per
                    step with per-slot rows against uniform ones; and
                    without scrubbing, die 0's masks, decayed bits and
                    tokens equal the alike run's while die 1 decays more;
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
                    and decay masks, and a dense synthetic mask, each
                    with its set mask bits and the planes its live warps
                    walk, per lane;
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
 13. rng_device   — the device threefry draws (``rng.bits_t``,
                    ``uniform_t``, ``bernoulli_t``) against the host
                    numpy ones, bit for bit, on 2^20 counters and on the
                    last 2^20 counters of a full-width admission leaf's
                    42,467,328 draws; and the draws' time over that leaf;
 14. oracle       — the eager oracle on the card against the CPU's, bit
                    for bit ((37, 129) bf16, (33,) f32); at the admission
                    shape (36, 1, 288, 2, 128) bf16 (real prefill rows
                    over a stale prompt's) against the cuda backend:
                    flips identical, energy within 1e-4, BERs within 6
                    binomial sigma, both timed; then the 8 requests
                    through backend="oracle" (no kernel launches);
 15. prefix       — the 8 requests with one shared 192-token system
                    prompt, prefix cache on (chunk 8, table 256) and
                    off: at least one linked admission, energy saved,
                    kv_prefill energy lower with the cache on, two
                    extent_write launches per admission group and per
                    decode step in both;
 16. soft_errors  — the 8 requests at soft-error BER 1e-6, hardened and
                    unhardened: strikes > 0 and within 6 sigma of
                    P(strike) x the bits the hook covered; the hook's
                    ms per admission leaf;
 17. wear         — the 8 requests with the physical addressing layer on
                    (row groups of 8 ring columns, a wear checkpoint
                    every 2 steps), three times: (a) never rotating,
                    equal to ``full`` in tokens, flips, errors, stream
                    energies and extent_write launches; (b) rotating by
                    a group when the hottest gained 8: rotations, remap
                    energy in the lifetime ledger, and (a)'s wear plus
                    the migrations'; (c) (b) with an endurance budget of
                    24, retention at 350 K and 32-column scrub windows
                    every 8 steps through the rotation: worn groups,
                    stuck-at bits lost and counted in kv_decode's errors.
                    Each with its tokens/s, decode ms per step and the
                    wear checkpoints' ms; then the windowed scrub on
                    (c)'s end-of-run state: the pass (CUDA events) and
                    its kernel (torch.profiler) against the byte bound.
 18. reduced_moe  — reduced dbrx-132b (4 experts, top-2) in float32 (TF32
                    off) serving the fixture trace through the kernels
                    and through the twins, without retention and at 400 K
                    with periodic whole-leaf scrubbing: tokens, flips,
                    errors and lifetime counters identical, energies
                    rtol 1e-5;
 19. sampling     — the ``full`` traffic with ServeConfig(greedy=False),
                    temperature 1.0: two runs with one seed identical, a
                    run with another seed different in tokens, extent_write
                    launches equal to ``full``'s, bursts sync-free; one
                    sampling step's uniforms (4 x 151936) on the card
                    equal to the host numpy draws bit for bit, in float32
                    (the logits' dtype) and bfloat16; a sampling step's
                    ms beside an argmax's;
 20. workload     — the six workload presets generated for qwen2.5-3b
                    (16 events, seed 7; each trace's sha256), chat_batch
                    served at full width (capacity 4, launches counted,
                    bursts sync-free), and a synthetic stream recorded,
                    saved, reloaded and replayed: the replay's report
                    equals the original's;
 21. moe          — dbrx-132b at full published width (16 experts top-4,
                    d_ff 10752, 8 KV heads of 128, vocab 100352, bf16,
                    random weights from a seed, capacity factor 1.25), its
                    depth cut to 6 of 40 layers (41.6 GB of weights):
                    layer 0's MoE FFN against a plain per-token loop, the
                    ms per decode step at batch 4, then the ``full``
                    traffic twice (identical tokens, counts, launches and
                    dropped assignments; prefill drops counted, decode
                    never drops), and the extent_write kernel at this
                    cache's admission shape (6, 1, 288, 8, 128) bf16
                    against its twin and its byte bound.
 22. reduced_families
                  — reduced mamba2-2.7b, llava-next-mistral-7b and
                    whisper-large-v3 in float32 (TF32 off) through the
                    kernels and through the twins: mamba2 continuous on
                    the fixture trace, without retention and at 400 K
                    with whole-leaf scrubbing (no launch, no bit written,
                    MAMBA2_SCRUB_PASSES passes with no energy); llava
                    continuous on a synthetic stream the same two ways
                    (tokens, flips, errors and lifetime counters
                    identical, energies rtol 1e-5); whisper generate;
 23. ssm          — mamba2-2.7b at full published width, its depth cut to
                    SSM_LAYERS = 8 of 64 (bf16): the ``full`` traffic
                    with 1024-token prompts (4 chunks of the scan), twice
                    identical, no kernel launched, its state bytes a slot;
 24. vlm          — llava-next-mistral-7b at full published width, its
                    depth cut to VLM_LAYERS = 8 of 32: the ``full``
                    traffic with 256 text tokens behind 2880 image
                    columns (synthetic_requests' modal_seed draws), twice
                    identical; one admission write (8, 1, 3168, 8, 128)
                    bf16 against its twin,
                    its energy within the float32 summation bound
                    (``energy_rtol``), and timed;
 25. audio        — whisper-large-v3 at full published width and depth:
                    the scheduler refuses it; generate at batch 4 over
                    1500 frames, 16-token prompts, 64 new tokens, twice
                    identical, 4 launches a write; the cross cache's
                    decode columns flip nothing; the prefill's cross K/V
                    write (32, 4, 1500, 20, 64) bf16 = 122.9 M lanes and
                    a decode column against the twin and timed;
 25a. dense_windows
                  — gemma2-9b, mistral-nemo-12b and h2o-danube-1.8b, each
                    at full published width and depth (bf16, random
                    weights from seed 0), loaded alone: the ``full``
                    traffic with 6144-token prompts (past the 4096-key
                    window; max_seq 6176), twice identical, one
                    extent_write launch per cache leaf (K and V of each
                    window capacity: gemma2's 4096-row rings and 6176-row
                    global leaves) per admission group and decode step;
                    an admission write of each capacity's K leaf (the
                    wrapped ring, the global leaf) against its twin,
                    bit-exact, its energy within ``energy_rtol``, timed;
                    for the windowed two, the decode after the ring
                    wrapped against a prefill over the same tokens (the
                    first WRAP_LAYERS layers' written K/V within
                    WRAP_CACHE_RTOL, gemma2-9b's logits within
                    WRAP_LOGITS_RTOL; every layer and the logits printed
                    beside a prefill with the windows lifted); tokens/s,
                    decode ms per step at batch 4, peak memory;
 25b. scout       — llama4-scout-17b-a16e at full published width (16
                    experts top-1, d_ff 8192, 40 heads over 8 KV heads of
                    128, vocab 202048), its depth cut to SCOUT_LAYERS = 8
                    of 48 (37.4 GB of weights), as ``moe``: the plain
                    per-token loop, the ``full`` traffic twice with its
                    prefill drops counted, the admission write timed;
 26. paper        — the paper's seven results (Table 1, Figs. 2, 6, 12, 13,
                    14 and 15/16) through repro_torch.benchmarks.run's
                    functions on the card at the paper's sizes (Fig. 2 at
                    128 trajectories a current, Fig. 15 at 1000 corners
                    plus the Fig. 16 sweep at 4 x 250), each's seconds,
                    then again on the CPU in this process on the same host
                    draws, held against the card (bounds at
                    ``PAPER_SUMMARY_RTOL``; Fig. 13's MiBench mixes equal,
                    its measured streams, each device's own seeded model,
                    printed); the four kernels' launches
                    over the card's runs (none expected); monte_carlo_wer
                    at n = 1000 (host draws and the card's integration
                    timed apart); the s-LLGS Euler step's ms and its
                    kernels per step (torch.profiler); Table 1's claims.
 27. serving_bench — the serving stack's seven benchmarks
                    (kernel_bench, serving_energy, endurance_sweep,
                    prefix_reuse, workload_mixes, telemetry_overhead,
                    shard_scaling) through repro_torch.benchmarks.run's
                    functions on the card at the reference runner's sizes
                    (SERVING_BENCH_FAST), every claim each asserts held
                    but the wall-clock ones (TIMED_CLAIMS of
                    telemetry_overhead and shard_scaling: printed with
                    their timings, through the runner's MEASURES), then
                    both examples
                    (image_store_psnr, serve_approx_kv) with --device
                    cuda; one line per module with its seconds, its
                    bench_metrics and its launches per kernel; held:
                    kernel_bench's cuda write against lanes_ref at its
                    size (stored words bit-equal, counts equal, energy
                    rtol 1e-5), serving_energy's lockstep bit-exactness
                    and its fused and eager flips equal with energies
                    within ``serving_energy_rtol``; each of the four
                    kernels launched in the phase.
 28. checkpoint_reduced
                  — the reference checkpoint test's small state (w, opt.m
                    at MID, opt.v at LOW) saved through cuda, lanes_ref
                    and oracle on the card and through lanes_ref and
                    oracle on the CPU: cuda's leaf files byte-identical to
                    lanes_ref's, the card's to the CPU's; the 400 K
                    integrity restore through cuda equal to the CPU's; a
                    MemoryRegion written, aged and scrubbed through cuda
                    equal to lanes_ref's; the quickstart with --device
                    cuda;
 29. checkpoint   — qwen2.5-3b's training state at full width, depth cut to
                    CKPT_LAYERS (reduced: 619.5 M parameters, 6.2 GB a
                    save): bf16 weights and AdamW moments after one
                    update, saved through cuda asynchronously three times
                    (the second an unchanged state: every approximate leaf
                    skipped, no launch), restored with the 400 K integrity
                    pass and plainly; each save's seconds by stage
                    (snapshot, copy to the card, kernels, copy back,
                    digest, np.save, commit), bytes, energy and bit
                    errors, the decay's ms per leaf and the peak device
                    memory; held
                    against the twins: one stacked MLP moment's write and
                    integrity scrub, and compress_grads' int8 wire; at the
                    embedding's 311.2 M-lane moment the write timed, and
                    the restore's decay (CUDA events) and scrub.

 30. train_reduced — one make_train_step step of every family's reduced
                    config (qwen2.5-3b, dbrx-132b, recurrentgemma-2b,
                    mamba2-2.7b, llava-next-mistral-7b, whisper-large-v3)
                    and of the three dense windowed configurations
                    (gemma2-9b, mistral-nemo-12b, h2o-danube-1.8b)
                    on the card and on the CPU from the same parameters
                    and batch, TF32 off: loss and gradient norm within
                    TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL, the parameters
                    within ``adamw_step_bound``; make_batch at qwen's
                    vocabulary (151936, (2, 64)) on the card equal to the
                    host's token for token, the device gumbels' largest
                    difference from XLA's printed beside the margin; 4
                    microbatches against the whole batch at ACCUM_RTOL;
 31. train        — qwen2.5-3b at published width and full depth (36
                    layers, 3.09 G parameters, bf16 weights, float32
                    moments), seq 4096, batch 2, full remat, donated
                    state: TRAIN_WARMUP + TRAIN_TIMED steps, each step's
                    ms (CUDA events), its batch's draw apart, loss, grad
                    norm; tokens/s, peak memory, and 6 x active params x
                    tokens / step time as a share of the bf16 peak (for
                    reading only); at the same parameters the plain loss
                    against a 2-microbatch accumulated step's;
 32. train_launcher
                  — repro_torch.launch.train main through argv (qwen2.5-3b
                    at full width, depth cut to CKPT_LAYERS, --compress,
                    one asynchronous EXTENT save at step 2 of 3), which
                    runs as one nccl rank on the card: the save's
                    extent_write launches, one per changed moment leaf,
                    held against its report, its stage seconds; its leaf
                    files byte-identical to the one-process loop's from
                    the same seeds; that checkpoint restored with the
                    400 K integrity pass through the rank path
                    (Checkpointer.restore(dims=): one scrub launch per
                    moment leaf), every leaf and the report equal to the
                    one-process restore's; then
                    repro_torch.examples.train_lm_extent --steps 60 on
                    the card (saves, the restore at step 30, its "must
                    learn" check).
 32b. train_mesh  — the (data, model) training path on a one-rank nccl
                    group (the (1, 1) production mesh with its axis
                    subgroups, the baseline rules' MeshShards: FSDP over
                    data, the dense family's heads, mlp and vocabulary
                    tensor parallel over model): qwen2.5-3b at the train
                    phase's shapes (MESH_LAYERS of 36 layers, seq 4096,
                    batch 2, full remat) MESH_STEPS steps through
                    make_sharded_train_step against the plain steps from
                    the same seeded state and batches, every parameter
                    and moment (two int64 sums of each leaf's bits) and
                    every metric equal after each step; the collectives
                    the model-axis code issued on the model group (must
                    be > 0); each step's ms against the plain step's,
                    the group's start (its first collective builds the
                    communicator), each path's peak memory beside what
                    earlier phases left allocated, and nvidia-smi's
                    line.
 33. tools        — the port's tools on the card: repro_torch.launch.
                    dryrun.smoke_backends("cuda") (a bf16 (33,) and an
                    int8 (129,) write through every memory backend; the
                    cuda backend's stored words and flips bit-exact
                    against lanes_ref, its extent_write launches counted
                    on the ``tools`` path); the roofline of the train
                    phase's own cell (qwen2.5-3b, seq 4096, batch 2, one
                    card: repro_torch.launch.roofline's cell_flops and
                    cell_bytes over launch/hw.py's H100 rates) against the
                    train phase's measured step: model FLOPs / (peak x
                    step) and bound step / measured step; and the dry run
                    of qwen2.5-3b x train_4k on the reference's (16, 16)
                    mesh on the meta device (its FLOPs beside the
                    analytic count, per-device argument bytes, trace
                    seconds).

They run in the order build, kernel, scrub_kernel,
local_attention_kernel, kv_quant_kernel, rng_device, reduced,
reduced_hybrid, reduced_moe, reduced_families, full, retention,
telemetry, shards, oracle, prefix, soft_errors, wear, sampling,
workload, hybrid, moe, ssm, vlm, audio, dense_windows (three models),
scout (each full-width model loads after the previous one is freed),
paper, serving_bench,
checkpoint_reduced, checkpoint, train_reduced, train, train_launcher,
train_mesh, tools; then the script's seconds (``done``), nvidia-smi's
line again and the kernels line, where every entry adds its launches on
each path (``launches_by_path``: ``serving_bench``,
``checkpoint_reduced``, ``checkpoint``, ``train_reduced``, ``train``,
``train_launcher``, ``train_mesh`` and ``tools`` in all four;
extent_write's also each dense windowed model's and ``scout``),
extent_write the MoE and
vlm admission writes and the audio prefill's cross K/V and decode
column (``at.admission_moe``, ``at.admission_vlm``,
``at.admission_<arch>_<local|global>`` of the dense windowed models,
``at.admission_scout``,
``at.prefill_cross_audio``, ``at.decode_column_audio``, and
``at.kernel_bench``: the write at kernel_bench's 8 MiB, and
``at.checkpoint_embed_moment``: the write of the checkpoint's 311.2 M-lane
embedding moment) and scrub the windowed pass
(``at.window_through_rotation``), the die-masked pass (``at.die_masked``)
and the restore's scrub of that moment (``at.checkpoint_embed_moment``).

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
#: integer instructions an SM issues a clock, per pipe: the INT32 lanes
#: (Hopper white paper) take LOP3, SHF, IADD3, ISETP and the like; IMAD
#: and its forms issue to the FMA pipe, whose heavy half (16 lanes of each
#: of the 4 sub-partitions) takes them. The issue rate, 4 x 32 = 128
#: instructions a clock, never binds a mix of the two: alu + fma
#: instructions at 128 a clock take no longer than the larger at 64.
INT_LANES_PER_SM = {"alu": 64, "fma": 64}
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


def hw():
    """The card's data-sheet rates (``repro_torch.launch.hw``): HBM bytes
    a second, f32 and dense bf16 FLOP/s — what every bound divides by."""
    from repro_torch.launch import hw as H
    return H


#: the script's start: each phase line's ``at_s`` counts from it
T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
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
    on the card's SMs at the maximum SM clock. scrub draws in the folded
    form too; extent_write draws through uniform_bits, which costs more:
    its bound is the least the hash could cost it."""
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
    local_attention's wgmma kernels, of kv_quant's and of scrub's
    (``-Xptxas -v``), and one counter-hash draw is compiled alone for
    ``draw_cost``.
    Returns the ptxas lines of the served instances (local_attention
    h 256, kv_quant bfloat16), which must not spill."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build as B
    names = tuple(KERNELS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 4) as ex:
        usage = ex.submit(B.resource_usage, "local_attention")
        q_usage = ex.submit(B.resource_usage, "kv_quant")
        s_usage = ex.submit(B.resource_usage, "scrub")
        draw = ex.submit(draw_cost)
        built = list(ex.map(lambda n: B.build(n, force=True), names))
        usage, notes = usage.result()
        q_usage, q_notes = q_usage.result()
        s_usage, s_notes = s_usage.result()
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
          "scrub_ptxas": {k: u for k, u in s_usage.items()
                          if "scrub_kernel" in k},
          "scrub_ptxas_notes": s_notes, "draw": draw})
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
    counted): words, residual masks and counts exact, and the energy
    equal (both price the same per-plane counts with
    ``ref.stats_from_partials``). Returns (largest word/count difference,
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
    if diff or e_k != e_r:
        raise AssertionError(f"scrub kernel disagrees with its twin: "
                             f"diff {diff}, energy {e_k} against {e_r}")
    return diff, int(b_st["flips01"]) + int(b_st["flips10"])


def phase_scrub_kernel(device):
    import torch
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    from repro_torch.memory import leaf_vectors
    all32, all16, all8 = range(32), range(16), range(8)
    # (name, shape, dtype, mask density, planes, lanes from the second
    # on: of stored and mask, of stored alone, or neither)
    cases = [
        ("f32_dense", (7, 19), torch.float32, 0.3, all32, None),
        ("bf16_odd", (3, 5, 11), torch.bfloat16, 0.3, all16, None),
        ("int8_ragged", (13,), torch.int8, 0.3, all8, None),
        ("f32_above_2p24_sparse", ((1 << 24) + 3,), torch.float32, 1e-4,
         all32, None),
        ("f32_zero_mask", (1000,), torch.float32, 0.0, (), None),
        # the retention path: bf16 K/V leaf, about 1% of mantissa bits
        ("bf16_leaf", (36, 4, 288, 2, 128), torch.bfloat16, 0.01,
         range(7), None),
        ("bf16_window", (36, 4, 72, 2, 128), torch.bfloat16, 0.01,
         range(7), None),
        # every bit of every lane set: the longest walk
        ("f32_all_ones", (1000, 129), torch.float32, 1.0, all32, None),
        ("bf16_all_ones", (3, 1000, 37), torch.bfloat16, 1.0, all16, None),
        # a checkpoint restore's density (13.16 decayed bits a float32
        # lane), 2^22 + 3 lanes: a tail of neither 4 nor 32 lanes
        ("f32_checkpoint_density", ((1 << 22) + 3,), torch.float32,
         13.16 / 32, all32, None),
        # lane vectors starting 4 bytes past a 16-byte boundary
        ("f32_offset_4b", (40_002,), torch.float32, 0.3, all32, "both"),
        ("f32_offset_4b_stored", (40_002,), torch.float32, 0.3, all32,
         "stored"),
    ]
    worst_abs = 0
    for i, (name, shape, dtype, density, planes, offset) in enumerate(cases):
        g = torch.Generator(device=device)
        g.manual_seed(200 + i)
        if dtype == torch.int8:
            x = torch.randint(-128, 128, shape, generator=g, device=device,
                              dtype=torch.int8)
        else:
            x = torch.randn(shape, generator=g, device=device).to(dtype)
        m = random_mask(shape, dtype, density, planes, 300 + i, device)
        s_u, m_u = ops.to_lanes(x), ops.to_lanes(m)
        if offset is not None:
            s_u, m_u = s_u[1:], m_u[1:]
            if offset == "stored":
                m_u = m_u.clone()
            if not (s_u.data_ptr() % 16 == 4 and m_u.data_ptr() % 16
                    == (4 if offset == "both" else 0)):
                raise AssertionError(f"{name}: lanes not 4 bytes past a "
                                     f"16-byte boundary")
        for level in (Priority.LOW, Priority.MID, Priority.EXACT):
            lv = leaf_vectors(dtype, level, device)
            vec = (lv.thr01, lv.thr10, lv.le01, lv.le10)
            seed = 0x2545F491 ^ (i * 7919 + int(level))
            diff, rewrites = check_scrub(s_u, m_u, seed, vec)
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
                  "lead": s_u.data_ptr() // 4 % 4, "rewrites": rewrites,
                  "max_abs_diff": diff, "energy_equals_twin": True,
                  "ok": True})
            worst_abs = max(worst_abs, diff)
    return worst_abs


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


def serve_trace(cfg, params, backend, device, scrub_cols=None, wear=None,
                **kw):
    """The fixture trace at capacity 2. ``kw`` goes to ServeConfig;
    ``scrub_cols`` (0 = whole leaves) adds periodic scrubbing every 2
    steps; ``wear`` (make_wear_policy's keywords) a rotate wear policy.
    Returns (report, scheduler)."""
    from repro_torch.reliability import make_scrub_policy, make_wear_policy
    from repro_torch.serve import (ContinuousScheduler, ServeConfig,
                                   ServingEngine)
    from repro_torch.workload import TraceSource, load_trace
    trace = load_trace(ROOT / "tests" / "fixtures" / "trace_smoke.jsonl")
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
        backend=backend, **kw), params, device=device)
    policy = (None if scrub_cols is None else
              make_scrub_policy("periodic", 2, scrub_cols))
    sch = ContinuousScheduler(
        eng, capacity=2, scrub_policy=policy,
        wear_policy=None if wear is None else make_wear_policy("rotate",
                                                               **wear))
    return sch.run(TraceSource(trace, cfg, device)), sch


def same_serve(rep_k, rep_r, what):
    """Kernel and twin runs serve the same tokens, flips, errors,
    lifetime counters and scrub energy; other energies agree to
    RTOL_ENERGY."""
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
                  "scrub_passes", "scrub_energy_pj"):
            if lk[f] != lr[f]:
                raise AssertionError(f"{what}: lifetime {f} "
                                     f"{lk[f]} != {lr[f]}")
        if not math.isclose(lk["lifetime_energy_pj"],
                            lr["lifetime_energy_pj"], rel_tol=RTOL_ENERGY):
            raise AssertionError(f"{what}: lifetime energy")


def phase_reduced(device):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.scrub import kernel as SK
    from repro_torch.models import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2.5-3b").reduced()
    params = get_model(cfg).init(0, device)
    rep_k, _ = serve_trace(cfg, params, "cuda", device)
    rep_r, _ = serve_trace(cfg, params, "lanes_ref", device)
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
        rep_k, _ = serve_trace(cfg, params, "cuda", device,
                               scrub_cols=cols, **ret)
        launched = SK.scrub_cuda.launches - n0
        rep_r, _ = serve_trace(cfg, params, "lanes_ref", device,
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
    off, _ = serve_trace(cfg, params, "cuda", device)
    on, _ = serve_trace(cfg, params, "cuda", device, scrub_cols=0,
                        retention_scale=1000.0, ambient_k=300.0)
    if (on["requests"] != off["requests"]
            or any(on["streams"][s] != off["streams"][s]
                   for s in ("kv_prefill", "kv_decode"))
            or on["lifetime"]["retention_flips"] != 0):
        raise AssertionError("300 K with retention on differs from "
                             "retention off")
    emit({"phase": "reduced", "retention": "300 K equals off",
          "scrub_passes": on["lifetime"]["scrub_passes"], "ok": True})
    # wear leveling with an endurance budget, retention and windowed
    # scrubbing through the rotation: the kernels and the twins serve
    # the same report and wear the same rows
    wear_kw = dict(wear_policy="rotate", remap_group_cols=4,
                   endurance_budget=REDUCED_WEAR_BUDGET,
                   retention_scale=1000.0, ambient_k=400.0)
    rot = dict(check_interval=2, rotate_step=4, hot_row_wear=2)
    (rep_k, sch_k), (rep_r, sch_r) = (
        serve_trace(cfg, params, be, device, scrub_cols=max_seq // 4,
                    wear=rot, **wear_kw) for be in ("cuda", "lanes_ref"))
    same_serve(rep_k, rep_r, "reduced serve, wear")
    rw_k, rw_r = (s.life.row_wear().tolist() for s in (sch_k, sch_r))
    w = rep_k["wear"]
    if (rw_k != rw_r or w != rep_r["wear"] or not w["rotations"]
            or not w["worn_groups"]
            or any(rep_k["streams"][s][f] != rep_r["streams"][s][f]
                   for s in rep_r["streams"] for f in (
                       "bits_written", "bit_errors", "bits_total"))):
        raise AssertionError(f"reduced wear run: cuda {w} {rw_k}, "
                             f"lanes_ref {rep_r['wear']} {rw_r}")
    emit({"phase": "reduced", "wear": "rotate + budget + windowed scrub",
          **w, "row_wear_identical": True, "ok": True})


#: the main path's traffic: 8 requests of 256-token prompts, 32 new
#: tokens each, arriving 4 steps apart into a pool of 4 slots
PROMPT_LEN, NEW_TOKENS, CAPACITY, N_REQ = 256, 32, 4, 8
#: the hybrid path's prompts: longer than recurrentgemma-2b's window
PROMPT_LEN_HYBRID = 3072


def serve_full(eng, prompt_len, scrub_policy=None, shared=0,
               wear_policy=None, lost_bits=None, telemetry=None,
               die_ambients=None, requests=None, writes=True):
    """Drive a path once at full width: the 8 requests through the
    continuous scheduler, every burst under
    ``set_sync_debug_mode("error")``; checks the tokens and the ledger.
    ``shared`` > 0 makes the first ``shared`` tokens of every prompt one
    common system prompt (numpy, seed 1234). ``lost_bits`` (a callable
    run after the serve) counts the errors stuck-at rows booked, which
    the BER check leaves out: it holds the driver. ``telemetry`` and
    ``die_ambients`` go to the scheduler. ``requests`` (built by the
    caller, e.g. multimodal ones) replace the random-token prompts;
    ``writes=False`` (a cache of EXACT leaves only) requires a ledger of
    0 bits written. The caller sets the launch counts to 0 just before
    and reads them just after. Returns (report, scheduler, wall
    seconds)."""
    import numpy as np
    import torch
    from repro_torch.serve import ContinuousScheduler, Request
    cfg = eng.cfg
    rs = np.random.default_rng(2)
    toks = [rs.integers(0, cfg.vocab_size, (1, prompt_len))
            for _ in range(N_REQ)]
    if shared:
        head = np.random.default_rng(1234).integers(0, cfg.vocab_size,
                                                    (1, shared))
        for t in toks:
            t[:, :shared] = head
    reqs = requests if requests is not None else [
        Request(rid=i, prompt={"tokens": torch.from_numpy(t).to(
            eng.device)}, new_tokens=NEW_TOKENS, arrival=4 * i,
            app_id="chat" if i % 2 else "batch")
        for i, t in enumerate(toks)]
    sch = ContinuousScheduler(eng, capacity=CAPACITY,
                              scrub_policy=scrub_policy,
                              wear_policy=wear_policy, telemetry=telemetry,
                              die_ambients=die_ambients)
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
    if not writes:
        if tot["bits_written"] or tot["energy_pj"]:
            raise AssertionError(f"full-width serve: an EXACT cache wrote "
                                 f"bits: {tot}")
        return rep, sch, wall
    lost = lost_bits() if lost_bits is not None else 0
    if not (math.isfinite(tot["energy_pj"]) and tot["energy_pj"] > 0
            and 0.0 < (tot["bit_errors"] - lost) / tot["bits_written"]
            < 0.1):
        raise AssertionError(f"full-width serve: implausible ledger {tot}, "
                             f"{lost} bits lost to stuck-at rows")
    return rep, sch, wall


def check_write_launches(launches, rep, leaves: int = 2) -> None:
    """One extent_write launch per cache leaf (``leaves``: a K and a V
    leaf for each distinct window capacity) per admission group and per
    decode step, and none elsewhere."""
    groups = rep["pool"]["admission_groups"]
    expected = leaves * (groups + rep["decode_steps"])
    if launches["extent_write"] != expected or expected <= 0:
        raise AssertionError(f"extent_write launches {launches} != "
                             f"{leaves} x (admission groups {groups} + "
                             f"decode steps {rep['decode_steps']}) = "
                             f"{expected}")


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
    return launches["extent_write"], eng, sch, rep


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
    return launches, sch, rep


# ---------------------------------------------------------------------------
# telemetry and sharded dies
# ---------------------------------------------------------------------------

TIMELINE_SCHEMA = ROOT / "tests" / "fixtures" / "timeline.schema.json"


@contextlib.contextmanager
def telemetry_probe(tele):
    """While inside, every recording call of ``tele`` (``event``, the
    tracer's ``begin``/``complete``/``end``, the instruments' host ops
    and ``drain``) runs under ``set_sync_debug_mode("error")``, so a
    device read in any of them raises; and every ``registry.land`` (the
    finalize landing) is counted, timed and its tensors counted."""
    import torch
    from repro_torch.telemetry import registry
    out = {"land_ms": [], "landed": []}
    land = registry.land

    def timed_land(refs):
        t0 = time.perf_counter()
        landed = land(refs)
        out["land_ms"].append((time.perf_counter() - t0) * 1e3)
        out["landed"].append(len(landed))
        return landed

    def sync_free(fn):
        def call(*a, **k):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return call

    for obj, names in ((tele, ("event",)),
                       (tele.tracer, ("begin", "complete", "end")),
                       (tele.instruments, ("inc", "set", "observe",
                                           "drain"))):
        for n in names:
            setattr(obj, n, sync_free(getattr(obj, n)))
    registry.land = timed_land
    try:
        yield out
    finally:
        registry.land = land


def same_run(rep, base, fields=("requests", "streams", "total")):
    """The report sections that must be equal, bit for bit, between two
    runs of one traffic (the extent table's hit counts are left out: the
    engine's table keeps its entries across runs)."""
    return all(rep[f] == base[f] for f in fields)


def phase_telemetry(device, eng_full, full_rep, full_launches):
    """The ``full`` traffic with telemetry on, beside one run with it off:
    the on run equals ``full`` in tokens, flips, errors, energies and the
    164 extent_write launches; drains equal events; no telemetry call
    reads the device (each runs under ``set_sync_debug_mode("error")``,
    as every burst does) and finalize lands everything through one
    ``registry.land``; the Chrome trace validates against
    tests/fixtures/timeline.schema.json. Returns the on run's launches."""
    import collections
    import tempfile
    from repro_torch.telemetry import (Telemetry, validate_timeline,
                                       write_timeline)
    reset_launches()
    rep_off, _, wall_off = serve_full(eng_full, PROMPT_LEN)
    launches_off = read_launches()
    tele = Telemetry()
    with telemetry_probe(tele) as probe:
        reset_launches()
        rep, sch, wall_on = serve_full(eng_full, PROMPT_LEN, telemetry=tele)
        launches = read_launches()
    snap = rep.pop("telemetry")
    if not (same_run(rep, full_rep) and same_run(rep_off, full_rep)
            and launches == launches_off
            and launches["extent_write"] == full_launches):
        raise AssertionError(f"telemetry on differs from off or from full: "
                             f"launches {launches} / {launches_off}")
    spans = collections.Counter(s["name"] for s in snap["spans_detail"])
    roots = [s for s in snap["spans_detail"] if s["cat"] == "request"
             and s["parent"] is None]
    problems = tele.tracer.validate()
    if not (snap["metrics"]["drains"] == snap["events"] > 0
            and snap["drains_per_event"] == 1.0
            and len(probe["land_ms"]) == 1 and probe["landed"][0] > 0
            and len(roots) == N_REQ and not problems
            and spans["burst"] == rep["bursts"]):
        raise AssertionError(f"telemetry: {snap['events']} events, "
                             f"{snap['metrics']['drains']} drains, lands "
                             f"{probe}, spans {dict(spans)}, {problems}")
    with tempfile.TemporaryDirectory() as d:
        path = write_timeline(snap, Path(d) / "timeline.json")
        timeline_bytes = path.stat().st_size
        doc = json.loads(path.read_text())
    validate_timeline(doc, TIMELINE_SCHEMA)
    c = snap["metrics"]["counters"]
    emit({"phase": "telemetry", "arch": eng_full.cfg.name,
          "events": snap["events"], "drains": snap["metrics"]["drains"],
          "drains_per_event": snap["drains_per_event"],
          "spans": snap["spans"], "spans_by_name": dict(spans),
          "finalize_land_calls": len(probe["land_ms"]),
          "finalize_land_ms": probe["land_ms"][0],
          "finalize_landed_tensors": probe["landed"][0],
          "timeline_events": len(doc["traceEvents"]),
          "timeline_bytes": timeline_bytes, "timeline_valid": True,
          "serve_decode_energy_pj_total": c["serve_decode_energy_pj_total"],
          "serve_flips_total": c["serve_flips_total"],
          "tokens_per_s_on": N_REQ * NEW_TOKENS / wall_on,
          "tokens_per_s_off": N_REQ * NEW_TOKENS / wall_off,
          "wall_s_on": wall_on, "wall_s_off": wall_off,
          "launches": launches, "equals_full": True,
          "bursts_sync_free": True, "ok": True})
    return launches


#: the hot die's ambient (kelvin) over the retention run's 350 K
HOT_DIE_K = 400.0


def die_masked_lanes(sch, die, vecs):
    """The lanes a die-masked whole-leaf pass hands the kernel: each K and
    V leaf with the mask bits of every slot outside ``die`` held out."""
    import torch
    from repro_torch import tree as T
    from repro_torch.kernels.extent_write import ops
    keep = sch.mesh.slot_mask(die, sch.eng.device).reshape(1, -1, 1, 1, 1)
    return [(ops.to_lanes(x), ops.to_lanes(torch.where(
        keep, m, torch.zeros_like(m))), (v.thr01, v.thr10, v.le01, v.le10))
        for x, m, v in zip(T.leaves(sch.pool.cache), sch.life.masks, vecs)
        if m is not None]


def phase_shards(device, eng_full, ret_rep, ret_launches):
    """The ``retention`` traffic (350 K, whole-leaf scrubs every 8 steps)
    on a pool split over dies: (a) shards 2 and 4, alike: every count,
    energy and launch equals ``retention``'s 1-die run; (b) shards 2
    with die 1 at 400 K: die 1 gets an extra die-masked pass per pass;
    on the run's end state one die-masked pass through the kernel equals
    the same pass through the twin (``lanes_ref``) bit for bit, and is
    timed with its kernel against the 16 B a lane bound, and the decay's
    ms per step with per-slot threshold rows against the uniform one;
    (c) without scrubbing, shards 2 alike and with die 1 at 400 K: die
    0's decay masks, decayed bits and requests' tokens are the alike
    run's, die 1 decays more. Returns (launches by run, the die-masked
    timing entry)."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch import tree as T
    from repro_torch.core.priority import Priority, int_type
    from repro_torch.memory.plan import BATCH_AXIS
    from repro_torch.reliability import make_scrub_policy
    from repro_torch.serve import ServingEngine

    def engine(shards, **kw):
        return ServingEngine(eng_full.cfg, dataclasses.replace(
            eng_full.scfg, retention_scale=1000.0, ambient_k=350.0,
            shards=shards, **kw), eng_full.params, device=device)

    def run(eng, scrub=True, die_ambients=None):
        reset_launches()
        rep, sch, wall = serve_full(
            eng, PROMPT_LEN, make_scrub_policy("periodic", interval=8)
            if scrub else None, die_ambients=die_ambients)
        launches = read_launches()
        check_write_launches(launches, rep)
        return rep, sch, wall, launches

    def dies(rep, key):
        return [d[key] for d in rep["sharding"]["dies"]]

    runs, launches_by = {}, {}
    # (a) alike dies are the 1-die run
    for n in (2, 4):
        rep, sch, wall, launches = run(engine(n))
        lt = rep["lifetime"]
        if not (same_run(rep, ret_rep, ("requests", "streams", "total",
                                        "lifetime"))
                and launches == ret_launches
                and dies(rep, "scrub_passes") == [lt["scrub_passes"]] * n
                and sum(dies(rep, "decayed_bits"))
                == lt["residual_decayed_bits"]):
            raise AssertionError(f"shards {n} differ from 1 die: launches "
                                 f"{launches} / {ret_launches}, "
                                 f"{rep['sharding']}")
        runs[f"shards_{n}"] = {"wall_s": wall,
                               "tokens_per_s": N_REQ * NEW_TOKENS / wall,
                               "launches": launches,
                               "dies": rep["sharding"]["dies"],
                               "equals_retention": True}
        launches_by[f"shards_{n}"] = launches
        del sch
        gc.collect()
    # (b) die 1 hot, scrubbing
    eng = engine(2)
    rep, sch, wall, launches = run(eng, die_ambients={1: HOT_DIE_K})
    passes, lt = dies(rep, "scrub_passes"), rep["lifetime"]
    if not (passes[1] == 2 * passes[0] > 0
            and lt["scrub_passes"] == passes[1]
            and launches["scrub"] == 2 * lt["scrub_passes"]):
        raise AssertionError(f"hot die 1: passes {passes}, launches "
                             f"{launches}, {lt}")
    runs["hot_die_scrub"] = {"wall_s": wall,
                             "tokens_per_s": N_REQ * NEW_TOKENS / wall,
                             "launches": launches,
                             "dies": rep["sharding"]["dies"],
                             "lifetime": lt}
    launches_by["hot_die_scrub"] = launches
    # one die-masked pass on the end state, kernel against twin
    key = rng.PRNGKey(8)
    mask = sch.mesh.slot_mask(1, device)
    twin = ServingEngine(eng.cfg, dataclasses.replace(
        eng.scfg, backend="lanes_ref"), eng.params, device=device)
    vec = eng.vectors_for_floor(Priority.LOW)
    with uncounted("scrub"):
        c_k, l_k, st_k = eng.scrub(key, sch.pool.cache, sch.life, vec,
                                   slot_mask=mask)
    c_r, l_r, st_r = twin.scrub(key, sch.pool.cache, sch.life,
                                twin.vectors_for_floor(Priority.LOW),
                                slot_mask=mask)
    h_k, h_r = st_k.host_dict(), st_r.host_dict()
    out0 = [slice(None)] * 5
    out0[BATCH_AXIS] = slice(0, sch.mesh.slots_per_die)

    def bits(t):
        return t.view(int_type(t.dtype)) if t.is_floating_point() else t

    exact = (all(torch.equal(bits(a), bits(b)) for a, b in zip(
        T.leaves(c_k), T.leaves(c_r)))
        and all(torch.equal(a, b) for a, b in zip(l_k.masks, l_r.masks)
                if a is not None)
        and all(torch.equal(a[tuple(out0)], b[tuple(out0)])
                for a, b in zip(l_k.masks, sch.life.masks) if a is not None)
        and all(h_k[f] == h_r[f] for f in ("flips01", "flips10",
                                           "bit_errors", "bits_total",
                                           "energy_pj")))
    if not exact:
        raise AssertionError(f"die-masked pass: kernel {h_k}, twin {h_r}")
    with uncounted("scrub"):
        pass_ms = cuda_ms(lambda: eng.scrub(key, sch.pool.cache, sch.life,
                                            vec, slot_mask=mask),
                          iters=10, warmup=2)
    leaf = T.leaves(sch.pool.cache)[-1]
    masked = time_scrubs(
        f"whole leaf {tuple(leaf.shape)} {str(leaf.dtype)[6:]}, die 1's "
        f"slots of {sch.mesh.n_dies} at {HOT_DIE_K:.0f} K (the other "
        f"die's mask held out), end-of-run decay masks",
        die_masked_lanes(sch, 1, vec))
    masked.update({"pass_ms": pass_ms, "pass_bits_rewritten":
                   h_k["bits_written"], "pass_equals_twin": True,
                   "ms_per_lane": masked["ms"] / masked["lanes_per_launch"],
                   "bound_ms_per_lane": masked["bound_ms"]
                   / masked["lanes_per_launch"]})
    # the decay with per-slot rows against the uniform thresholds
    rows = eng.retention_vectors_for_dies(Priority.LOW, (350.0, HOT_DIE_K),
                                          sch.mesh.slots_per_die)
    flat = eng.retention_vectors_for(Priority.LOW)
    decay_rows_ms = cuda_ms(lambda: eng.life_plan.advance(
        key, sch.pool.cache, sch.life, rows), iters=10, warmup=2)
    decay_uniform_ms = cuda_ms(lambda: eng.life_plan.advance(
        key, sch.pool.cache, sch.life, flat), iters=10, warmup=2)
    live = [int(r.host.any(0).sum()) if r is not None else None
            for r in rows]
    live_flat = [int((v > 0).sum()) if v is not None else None
                 for v in flat]
    del sch, twin, c_k, c_r, l_k, l_r
    gc.collect()
    # (c) no scrubbing: the decay record alone
    rep_u, sch_u, _, launches_u = run(engine(2), scrub=False)
    rep_h, sch_h, _, launches_h = run(engine(2), scrub=False,
                                      die_ambients={1: HOT_DIE_K})
    d_u, d_h = dies(rep_u, "decayed_bits"), dies(rep_h, "decayed_bits")
    die0_masks = all(torch.equal(a[tuple(out0)], b[tuple(out0)])
                     for a, b in zip(sch_h.life.masks, sch_u.life.masks)
                     if a is not None)
    die0_tokens = all(rep_h["requests"][i]["tokens"]
                      == rep_u["requests"][i]["tokens"]
                      for i in rep_u["requests"]
                      if rep_u["requests"][i]["slot"]
                      < sch_u.mesh.slots_per_die)
    if not (d_h[0] == d_u[0] and d_h[1] > d_u[1] and die0_masks
            and die0_tokens):
        raise AssertionError(f"heating die 1 moved die 0: decayed "
                             f"{d_h} against {d_u}, masks {die0_masks}, "
                             f"tokens {die0_tokens}")
    runs["no_scrub"] = {"decayed_bits_alike": d_u, "decayed_bits_hot": d_h,
                        "retention_flips_alike":
                            rep_u["lifetime"]["retention_flips"],
                        "retention_flips_hot":
                            rep_h["lifetime"]["retention_flips"],
                        "die0_masks_identical": True,
                        "die0_tokens_identical": True}
    launches_by["alike_no_scrub"] = launches_u
    launches_by["hot_die_no_scrub"] = launches_h
    del sch_u, sch_h
    gc.collect()
    emit({"phase": "shards", "arch": eng_full.cfg.name,
          "hot_die_k": HOT_DIE_K, "ambient_k": 350.0, "scrub_interval": 8,
          **runs, "die_masked_pass": masked,
          "decay_ms_per_step_rows": decay_rows_ms,
          "decay_ms_per_step_uniform": decay_uniform_ms,
          "live_planes_rows": live, "live_planes_uniform": live_flat,
          "bursts_sync_free": True, "ok": True})
    return launches_by, masked


# ---------------------------------------------------------------------------
# the oracle backend, soft errors and the prefix cache
# ---------------------------------------------------------------------------

#: draws of one full-width admission leaf: (36, 1, 288, 2, 128) bf16 x 16
ADMISSION_LEAF = (36, 1, 288, 2, 128)


def phase_rng_device(device):
    """The device threefry (``rng.bits_t``/``uniform_t``/``bernoulli_t``)
    against the host numpy draws, bit for bit, on 2^20 counters and on
    the last 2^20 counters of a full-width admission leaf's draws; and
    its time over all of that leaf's draws."""
    import numpy as np
    import torch
    from repro_torch import rng
    key = rng.fold_in(rng.PRNGKey(21), 4)
    n = 1 << 20
    host = rng.bits(key, (n,))
    got = {"bits": rng.bits_t(key, (n,), device).cpu().numpy(),
           "uniform": rng.uniform_t(key, (n,), device).cpu().numpy(),
           "bernoulli": rng.bernoulli_t(key, 0.3, (n,), device).cpu()
           .numpy()}
    want = {"bits": host.astype(np.int64),
            "uniform": rng.uniform(key, (n,)),
            "bernoulli": rng.bernoulli(key, 0.3, (n,))}
    total = int(np.prod(ADMISSION_LEAF)) * 16
    ctr = np.arange(total - n, total, dtype=np.uint32)
    y0, y1 = rng.threefry2x32(key, np.zeros_like(ctr), ctr)
    want["window"] = (y0 ^ y1).astype(np.int64)
    got["window"] = rng.counter_bits_t(key, torch.from_numpy(
        ctr.astype(np.int64)).to(device)).cpu().numpy()
    mismatched = {k: int(np.count_nonzero(
        got[k].view(np.int32) != want[k].view(np.int32))
        if k == "uniform" else np.count_nonzero(got[k] != want[k]))
        for k in want}
    if any(mismatched.values()):
        raise AssertionError(f"device threefry differs from the host's: "
                             f"{mismatched}")
    ms = cuda_ms(lambda: rng.bits_t(key, (total,), device), iters=5,
                 warmup=1)
    emit({"phase": "rng_device", "counters": n,
          "window": [total - n, total], "mismatched": mismatched,
          "bits_ms_admission_leaf": ms, "draws": total,
          "draws_per_s": total / ms * 1e3, "ok": True})


def admission_rows(eng, seed):
    """The K and V prefill rows (36, 1, 288, 2, 128) bf16 of one random
    prompt."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    prompt_len = eng.scfg.max_seq - eng.scfg.max_new_tokens
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, eng.cfg.vocab_size, (1, prompt_len))).to(eng.device)
    _, rows = eng.api.prefill(eng.params, {"tokens": prompt},
                              eng.scfg.max_seq)
    return T.leaves(rows)


def phase_oracle(device, eng_full):
    """The eager oracle on the card: bit-exact with the CPU oracle on
    small pairs; at the full admission shape, flips equal to the cuda
    backend's and BER within sampling noise of it, with both timed;
    then the 8 requests served through backend="oracle"."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch.core.priority import Priority
    from repro_torch.memory import get_backend, leaf_vectors
    from repro_torch.serve import ServingEngine
    oracle = get_backend("oracle")
    cpu = torch.device("cpu")
    small = []
    for shape, dtype, seed in (((37, 129), torch.bfloat16, 31),
                               ((33,), torch.float32, 32)):
        old, new = random_pair(shape, dtype, seed, device)
        key = rng.PRNGKey(seed)
        out = []
        for dev in (device, cpu):
            lv = leaf_vectors(dtype, Priority.LOW, dev)
            s, st = oracle.leaf_write(key, old.to(dev), new.to(dev), lv)
            out.append((s.cpu(), st.host_dict()))
        (s_d, h_d), (s_c, h_c) = out
        it = torch.int16 if dtype == torch.bfloat16 else torch.int32
        bad = int((s_d.view(it) != s_c.view(it)).sum())
        if bad or any(h_d[k] != h_c[k] for k in (
                "flips01", "flips10", "bit_errors", "latency_ns")):
            raise AssertionError(f"oracle on the card differs from the "
                                 f"CPU's at {shape}: {bad} words, "
                                 f"{h_d} vs {h_c}")
        small.append({"shape": list(shape), "dtype": str(dtype)[6:],
                      "flips": h_d["bits_written"],
                      "errors": h_d["bit_errors"],
                      "energy_pj": [h_d["energy_pj"], h_c["energy_pj"]]})
    # full-width admission: real prefill rows over a stale prompt's rows
    olds, news = admission_rows(eng_full, 12), admission_rows(eng_full, 13)
    vecs = eng_full.vectors_for_floor(Priority.LOW)
    cuda_be = get_backend("cuda")
    leaves = []
    for i, (o, n, lv) in enumerate(zip(olds, news, vecs)):
        if lv is None:
            continue
        key = rng.fold_in(rng.PRNGKey(14), i)
        _, so = oracle.leaf_write(key, o, n, lv)
        with uncounted("extent_write"):
            _, sc = cuda_be.leaf_write(key, o, n, lv)
            ho, hc = so.host_dict(), sc.host_dict()
            cuda_leaf_ms = cuda_ms(
                lambda: cuda_be.leaf_write(key, o, n, lv), 20)
        oracle_leaf_ms = cuda_ms(lambda: oracle.leaf_write(key, o, n, lv),
                                 5, warmup=1)
        flips = ho["bits_written"]
        p = (ho["bit_errors"] + hc["bit_errors"]) / (2 * flips)
        sigma = math.sqrt(2 * p * (1 - p) / flips)
        rel_e = abs(ho["energy_pj"] - hc["energy_pj"]) / hc["energy_pj"]
        if not ((ho["flips01"], ho["flips10"]) == (hc["flips01"],
                                                   hc["flips10"])
                and rel_e <= 1e-4
                and abs(ho["ber_realized"] - hc["ber_realized"])
                <= 6 * sigma):
            raise AssertionError(f"oracle and cuda disagree at the "
                                 f"admission shape: {ho} vs {hc}")
        leaves.append({"leaf": i, "shape": list(o.shape), "flips": flips,
                       "ber": [ho["ber_realized"], hc["ber_realized"]],
                       "ber_sigma": sigma, "energy_rel_diff": rel_e,
                       "oracle_ms": oracle_leaf_ms, "cuda_ms": cuda_leaf_ms})
    eng = ServingEngine(eng_full.cfg, dataclasses.replace(
        eng_full.scfg, backend="oracle"), eng_full.params, device=device)
    reset_launches()
    rep, _, wall = serve_full(eng, PROMPT_LEN)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the oracle path launched a kernel: "
                             f"{launches}")
    tot = rep["total"]
    emit({"phase": "oracle", "small": small, "admission_leaves": leaves,
          "serve": {"backend": "oracle", "requests": N_REQ,
                    "decode_steps": rep["decode_steps"],
                    "bursts": rep["bursts"], "wall_s": wall,
                    "tokens_per_s": N_REQ * NEW_TOKENS / wall,
                    "kv_write_energy_pj": tot["energy_pj"],
                    "ber": tot["ber_realized"],
                    "write_skip_rate": tot["write_skip_rate"],
                    "bursts_sync_free": True, "launches": launches},
          "ok": True})


#: the prefix phase's shared system prompt: the first 192 of 256 tokens
SHARED_PREFIX = 192
#: the soft-error phase's upset rate per stored bit
SOFT_ERROR_BER = 1e-6


def phase_prefix(device, eng_full):
    """The 8 requests with one shared 192-token system prompt, prefix
    cache on (chunk 8, table 256) and off, cuda backend."""
    import dataclasses
    from repro_torch.serve import ServingEngine
    runs = {}
    for on in (True, False):
        eng = ServingEngine(eng_full.cfg, dataclasses.replace(
            eng_full.scfg, prefix_cache=on, prefix_chunk=8,
            prefix_table_size=256), eng_full.params, device=device)
        reset_launches()
        rep, _, wall = serve_full(eng, PROMPT_LEN, shared=SHARED_PREFIX)
        launches = read_launches()
        check_write_launches(launches, rep)
        row = {"wall_s": wall, "tokens_per_s": N_REQ * NEW_TOKENS / wall,
               "kv_prefill_energy_pj": rep["streams"]["kv_prefill"][
                   "energy_pj"],
               "kv_write_energy_pj": rep["total"]["energy_pj"],
               "ber": rep["total"]["ber_realized"],
               "admission_groups": rep["pool"]["admission_groups"],
               "decode_steps": rep["decode_steps"],
               "extent_write_launches": launches["extent_write"]}
        if on:
            p = rep["prefix"]
            row.update({k: p[k] for k in (
                "hits", "misses", "hit_rate", "linked_admissions",
                "linked_cols", "cow_events", "write_energy_saved_pj",
                "cow_energy_pj", "cam_energy_pj", "net_energy_saved_pj")})
        runs["on" if on else "off"] = row
    on, off = runs["on"], runs["off"]
    if not (on["linked_admissions"] >= 1
            and on["write_energy_saved_pj"] > 0
            and on["kv_prefill_energy_pj"] < off["kv_prefill_energy_pj"]):
        raise AssertionError(f"prefix cache saved nothing: {runs}")
    emit({"phase": "prefix", "shared_prefix": SHARED_PREFIX, "chunk": 8,
          "table_size": 256, "prompt_len": PROMPT_LEN, **runs,
          "bursts_sync_free": True, "ok": True})


def strike_probability(ber: float) -> float:
    """P(uniform < f32(ber)) for the float32 draws of ``rng.uniform``:
    they are k / 2^23, so it is the count of k with k / 2^23 < f32(ber),
    over 2^23 (1.0729e-6 at ber 1e-6)."""
    import numpy as np
    p32 = float(np.float32(ber))
    return math.ceil(p32 * 2 ** 23) / 2 ** 23


def phase_soft_errors(device, eng_full):
    """The 8 requests at soft-error BER 1e-6 (``SOFT_ERROR_BER``),
    hardened and unhardened:
    strikes > 0 and within 6 sigma of P(strike) x the bits the hook
    covered (hardened: only the planes not pinned EXACT); and the hook's
    ms per full-width admission leaf."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch import tree as T
    from repro_torch.core.approx_store import soft_error_strikes
    from repro_torch.core.priority import Priority, bitplane_priorities
    from repro_torch.serve import ServingEngine
    ber = SOFT_ERROR_BER
    p = strike_probability(ber)
    leaf = torch.randn(ADMISSION_LEAF, device=device).to(torch.bfloat16)
    runs = {}
    for hardened in (True, False):
        eng = ServingEngine(eng_full.cfg, dataclasses.replace(
            eng_full.scfg, soft_error_ber=ber,
            soft_error_hardened=hardened), eng_full.params, device=device)
        reset_launches()
        rep, sch, wall = serve_full(eng, PROMPT_LEN)
        launches = read_launches()
        check_write_launches(launches, rep)
        # the hook covers every admitted row of each K/V leaf, and every
        # decode step's gathered column of all slots, on the planes the
        # driver leaves strikable
        covered = 0
        for (_, x), lvl, ax in zip(T.flatten(sch.pool.cache),
                                   eng.plan.leaf_levels,
                                   eng.plan.leaf_seq_axis):
            if lvl is None:
                continue
            codes = bitplane_priorities(x.dtype, Priority.LOW)
            planes = (int((codes != int(Priority.EXACT)).sum())
                      if hardened else codes.size)
            covered += planes * (
                rep["pool"]["admissions"] * x.numel() // CAPACITY
                + rep["decode_steps"] * x.numel() // x.shape[ax])
        want = p * covered
        sigma = math.sqrt(covered * p * (1 - p))
        strikes = rep["total"]["soft_strikes"]
        mode = "hardened" if hardened else "unhardened"
        if not (strikes > 0 and abs(strikes - want) <= 6 * sigma):
            raise AssertionError(f"soft errors ({mode}): {strikes} "
                                 f"strikes, expected {want} +- {sigma}")
        key = rng.PRNGKey(40)
        hook_ms = cuda_ms(lambda: soft_error_strikes(key, leaf, ber,
                                                     hardened), 5, warmup=1)
        runs[mode] = {
            "strikes": strikes, "covered_bits": covered,
            "expected": want, "sigma": sigma, "planes": planes,
            "tokens_per_s": N_REQ * NEW_TOKENS / wall, "wall_s": wall,
            "ber": rep["total"]["ber_realized"],
            "hook_ms_admission_leaf": hook_ms,
            "extent_write_launches": launches["extent_write"]}
    emit({"phase": "soft_errors", "soft_error_ber": ber,
          "strike_probability": p, **runs, "bursts_sync_free": True,
          "ok": True})


# ---------------------------------------------------------------------------
# physical addressing, endurance wear and wear leveling
# ---------------------------------------------------------------------------

#: the wear phase's row groups (ring columns), the steps between wear
#: checkpoints and the hot-row wear that arms a rotation (one group)
WEAR_GROUP_COLS, WEAR_CHECK, WEAR_HOT = 8, 2, 8
#: an endurance budget (writes + scrubs a row group survives) that the
#: hottest groups exhaust before the full-width run ends: 32 of the 144
#: groups of each K/V leaf. A scrub pass or a migration adds 8 to each
#: group it covers (one per column per slot), beside the 8 decode writes
#: a request makes in each group it sweeps, so the run's hottest group
#: reaches 36 and a budget of 12 would wear out 56 of each leaf's 144
WEAR_BUDGET = 24
#: the failure run's scrub window (ring columns a pass)
WEAR_SCRUB_COLS = 32
#: the reduced wear run's budget (fixture trace, groups of 4 columns)
REDUCED_WEAR_BUDGET = 6


@contextlib.contextmanager
def wear_probes():
    """Record, while inside, the host ms of every wear checkpoint that
    read the device (``ContinuousScheduler._maybe_wear_check``; it waits
    for the queued burst) and the bits every stuck-at gate lost
    (``memory.plan._stuck_gate``'s count, kept on the device)."""
    from repro_torch.memory import plan as P
    from repro_torch.serve import scheduler as S
    check, gate = S.ContinuousScheduler._maybe_wear_check, P._stuck_gate
    out = {"check_ms": [], "lost": []}

    def timed_check(self, clock):
        before = self._last_wear_check
        t0 = time.perf_counter()
        check(self, clock)
        if self._last_wear_check != before:
            out["check_ms"].append((time.perf_counter() - t0) * 1e3)

    def counted_gate(old, new, worn):
        gated, lost = gate(old, new, worn)
        out["lost"].append(lost)
        return gated, lost

    S.ContinuousScheduler._maybe_wear_check = timed_check
    P._stuck_gate = counted_gate
    try:
        yield out
    finally:
        S.ContinuousScheduler._maybe_wear_check = check
        P._stuck_gate = gate


def scrub_window_lanes(sch, cursor, cols):
    """The lanes a windowed scrub pass hands the kernel: per K and V
    leaf, the ``cols`` physical rows from ``cursor`` mapped through the
    run's shifts to logical columns, gathered, with the stuck rows'
    decayed bits held out of the mask (``reliability.scrub``'s steps)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    from repro_torch.memory import address as A
    eng = sch.eng
    plan, shifts = eng.plan, sch.addr.shifts
    worn = eng.life_plan.worn_groups(sch.life)
    out = []
    for i, (x, m, v) in enumerate(zip(T.leaves(sch.pool.cache),
                                      sch.life.masks,
                                      eng.vectors_for_floor(Priority.LOW))):
        if m is None:
            continue
        ax = plan.leaf_seq_axis[i]
        C = x.shape[ax]
        idx = A.logical_col((cursor + torch.arange(
            cols, dtype=torch.int64, device=x.device)) % C, shifts[i], C)
        wx, wm = x.index_select(ax, idx), m.index_select(ax, idx)
        if worn is not None:
            stuck = A.worn_element_mask(worn[i], shifts[i], wm.shape, ax, 1,
                                        plan.address_spec, cols=idx,
                                        n_cols=C)
            wm = torch.where(stuck, torch.zeros_like(wm), wm)
        out.append((ops.to_lanes(wx), ops.to_lanes(wm),
                    (v.thr01, v.thr10, v.le01, v.le10)))
    return out


def phase_wear(device, eng_full, full_rep, full_launches):
    """The ``full`` traffic on qwen2.5-3b at full width with the physical
    addressing layer on, three times: (a) identity — rotate with a
    hot-row level no group reaches, equal to ``full`` in tokens, flips,
    errors, stream energies and extent_write launches; (b) leveling —
    rotate by one group of 8 columns when the hottest group gained 8,
    checked every 2 steps: rotations, remap energy booked to the ledger,
    and the wear of (a) plus the migrations'; (c) failure — (b) with an endurance budget of
    24, retention at 350 K (1000 s a step) and periodic scrubbing of
    32-column windows every 8 steps through the rotation. Times the wear
    checkpoints and, on (c)'s end-of-run state, the windowed scrub pass
    and its kernel. Returns (the windowed scrub's timing entry, (c)'s
    scrub launches, the launches of the three runs)."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch.core.priority import Priority
    from repro_torch.reliability import make_scrub_policy, make_wear_policy
    from repro_torch.serve import ServingEngine
    base = dict(wear_policy="rotate", remap_group_cols=WEAR_GROUP_COLS)
    cases = {
        "identity": (base, dict(hot_row_wear=10 ** 9), None),
        "leveling": (base, dict(hot_row_wear=WEAR_HOT), None),
        "failure": (dict(base, endurance_budget=WEAR_BUDGET,
                         retention_scale=1000.0, ambient_k=350.0),
                    dict(hot_row_wear=WEAR_HOT),
                    make_scrub_policy("periodic", interval=8,
                                      cols_per_pass=WEAR_SCRUB_COLS)),
    }
    runs, reps, launches_by_run = {}, {}, {}
    for name, (scfg, pol, scrub) in cases.items():
        eng = ServingEngine(eng_full.cfg, dataclasses.replace(
            eng_full.scfg, **scfg), eng_full.params, device=device)
        step_ms = decode_step_ms(eng, PROMPT_LEN, CAPACITY)
        policy = make_wear_policy(
            "rotate", check_interval=WEAR_CHECK, rotate_step=WEAR_GROUP_COLS,
            **pol)
        with wear_probes() as probe:
            def lost_bits():
                return (int(torch.stack(probe["lost"]).sum())
                        if probe["lost"] else 0)

            reset_launches()
            rep, sch, wall = serve_full(eng, PROMPT_LEN, scrub_policy=scrub,
                                        wear_policy=policy,
                                        lost_bits=lost_bits)
            launches = read_launches()
        check_write_launches(launches, rep)
        lost = lost_bits()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sch.read_wear()
        read_ms = (time.perf_counter() - t0) * 1e3
        w, lt = rep["wear"], rep["lifetime"]
        runs[name] = {
            "wall_s": wall, "tokens_per_s": N_REQ * NEW_TOKENS / wall,
            "decode_ms_per_step_b4": step_ms,
            "wear_checks": len(probe["check_ms"]),
            "wear_check_ms_in_run": probe["check_ms"],
            "wear_check_ms_mean": (sum(probe["check_ms"])
                                   / max(1, len(probe["check_ms"]))),
            "wear_read_ms_idle": read_ms,
            "launches": launches, "lost_bits": lost, **w,
            "row_wear_total": int(sch.life.row_wear().sum()),
            "lifetime_remap_energy_pj": lt["remap_energy_pj"],
            "kv_decode": rep["streams"]["kv_decode"],
            "kv_write_energy_pj": rep["total"]["energy_pj"],
            "ber": rep["total"]["ber_realized"]}
        reps[name] = (rep, sch, eng)
        launches_by_run[name] = launches
        if name != "failure":
            del sch
            gc.collect()
    # (a) the layer on and never rotating changes nothing
    rep_a = reps["identity"][0]
    a = runs["identity"]
    same = (a["rotations"] == 0 and a["remap_energy_pj"] == 0.0
            and a["launches"]["extent_write"] == full_launches
            and all(rep_a["streams"][s] == full_rep["streams"][s]
                    for s in ("kv_prefill", "kv_decode"))
            and all(rep_a["requests"][i][f] == full_rep["requests"][i][f]
                    for i in full_rep["requests"]
                    for f in ("tokens", "flips", "errors", "energy_pj")))
    if not same:
        raise AssertionError(f"wear (a) identity differs from full: {a}")
    # (b) leveling rotates and books the remap energy; its wear is (a)'s
    # decode writes plus each rotation's migration, which re-drives one
    # group of every slot of the K and V leaves. (With two requests a
    # slot, that migration wear outweighs what the spreading saves, so
    # the peak group wear rises: reported, not gated.)
    b = runs["leveling"]
    migrated = b["rotations"] * WEAR_GROUP_COLS * CAPACITY * 2
    if not (b["rotations"] >= 1 and b["remap_energy_pj"] > 0
            and b["lifetime_remap_energy_pj"] == b["remap_energy_pj"]
            and b["row_wear_total"] == a["row_wear_total"] + migrated):
        raise AssertionError(f"wear (b) leveling: {b}, identity {a}")
    # (c) worn groups are stuck-at: the lost bits land in kv_decode's
    # errors on top of the driver's own failures
    c = runs["failure"]
    rep_c, sch_c, eng_c = reps["failure"]
    errors_b, errors_c = (r["kv_decode"]["bit_errors"] for r in (b, c))
    if not (c["worn_groups"] > 0 and c["lost_bits"] > 0
            and errors_c >= c["lost_bits"] and errors_c > errors_b
            and c["launches"]["scrub"]
            == 2 * rep_c["lifetime"]["scrub_passes"] > 0):
        raise AssertionError(f"wear (c) failure: {c}, leveling {b}")
    # the windowed scrub through the rotation on (c)'s end-of-run state:
    # the whole pass (gather, two kernel launches, scatter, the mask's
    # bookkeeping) by CUDA events, the kernel on the gathered window
    # the window is the one the run's next pass would scrub
    cursor = sch_c._scrub_cursor
    key = rng.PRNGKey(6)
    vec = eng_c.vectors_for_floor(Priority.LOW)
    with uncounted("scrub"):
        pass_ms = cuda_ms(lambda: eng_c.scrub(
            key, sch_c.pool.cache, sch_c.life, vec, cols=WEAR_SCRUB_COLS,
            cursor=cursor, shifts=sch_c.addr.shifts), iters=10, warmup=2)
    window = time_scrubs(
        f"window of {WEAR_SCRUB_COLS} ring columns from physical row "
        f"{cursor} through the rotation (shifts "
        f"{sch_c.addr.shifts.tolist()}), stuck rows held out",
        scrub_window_lanes(sch_c, cursor, WEAR_SCRUB_COLS))
    window.update({"pass_ms": pass_ms,
                   "pass_lanes": 2 * window["lanes_per_launch"],
                   "pass_ms_per_lane": pass_ms / (
                       2 * window["lanes_per_launch"]),
                   "ms_per_lane": window["ms"] / window["lanes_per_launch"],
                   "bound_ms_per_lane": window["bound_ms"]
                   / window["lanes_per_launch"]})
    for r in runs.values():
        r["kv_decode"] = {k: r["kv_decode"][k] for k in (
            "energy_pj", "bits_written", "bit_errors")}
    emit({"phase": "wear", "arch": eng_full.cfg.name,
          "group_cols": WEAR_GROUP_COLS, "check_interval": WEAR_CHECK,
          "hot_row_wear": WEAR_HOT, "endurance_budget": WEAR_BUDGET,
          "scrub_cols": WEAR_SCRUB_COLS, **runs,
          "windowed_scrub": window, "bursts_sync_free": True, "ok": True})
    return window, c["launches"]["scrub"], launches_by_run


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


# ---------------------------------------------------------------------------
# the MoE family, non-greedy sampling and generated workloads
# ---------------------------------------------------------------------------

#: dbrx-132b's depth on the card: 6 of its 40 layers (the full-width
#: weights of 6 layers are 41.6 GB of bf16; 40 would not fit one card)
MOE_LAYERS = 6
#: llama4-scout-17b-a16e's depth on one card: 8 of its 48 layers (4.15 GB
#: of bf16 weights a layer, 4.14 GB of embedding and head; 37.4 GB in all)
SCOUT_LAYERS = 8
#: the workload phase's presets: 16 events from root seed 7
WORKLOAD_EVENTS, WORKLOAD_SEED = 16, 7
#: sha256 of each preset's trace (``workload.trace.dumps``) for
#: qwen2.5-3b at those settings, as the JAX package generates it
#: (tests/test_torch_workload.py holds these against it)
PRESET_SHA256 = {
    "steady": "a16a7a5b8aa20156a13be83d9d29d85f829b6fe12dbc8132acbd9682657e0d6c",
    "diurnal": "78105670fadb70889c094362b2bb418bb964335902f401ccbee3f23a13e53e55",
    "bursty": "02873d82e4986c1d357b34e5772ee6ba952aed4e3ebdbcdf6ce197a75eb96960",
    "heavy_tail":
        "6ea8ec4ab41f6b27edfa891cdc9bda8ea3e048de40d0e1611cf8848c3ce3a11b",
    "chat_batch":
        "5910a865d61d6b3ed71cb2bd85db35dbe4b43acb9b13244246b7a8eabaca5774",
    "shared_system_prompt":
        "302c77231fde4f25d1522cd4be7b4043aef4f1746af09309e2e632af61a0315a",
}


def phase_reduced_moe(device):
    """Reduced dbrx-132b (4 experts, top-2) in float32 (TF32 off) serving
    the fixture trace through the kernels and through the twins, without
    retention and at 400 K with periodic whole-leaf scrubbing: tokens,
    flips, errors and lifetime counters identical, energies rtol 1e-5.
    Returns the kernel runs' extent_write and scrub launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("dbrx-132b").reduced()
    params = get_model(cfg).init(0, device)
    counts = {"extent_write": 0, "scrub": 0}
    for ret in ({}, dict(retention_scale=1000.0, ambient_k=400.0)):
        scrub_cols = 0 if ret else None
        n0 = read_launches()
        rep_k, _ = serve_trace(cfg, params, "cuda", device,
                               scrub_cols=scrub_cols, **ret)
        n1 = read_launches()
        rep_r, _ = serve_trace(cfg, params, "lanes_ref", device,
                               scrub_cols=scrub_cols, **ret)
        if read_launches() != n1:
            raise AssertionError("reduced moe: the twin run launched a "
                                 "kernel")
        launched = {k: n1[k] - n0[k] for k in counts}
        what = "reduced moe" + (", 400 K scrub" if ret else "")
        same_serve(rep_k, rep_r, what)
        check_write_launches(launched, rep_k)
        lt = rep_k.get("lifetime", {})
        if ret and not (lt["scrub_passes"] > 0 and lt["retention_flips"] > 0
                        and launched["scrub"] == 2 * lt["scrub_passes"]):
            raise AssertionError(f"{what}: launches {launched}, {lt}")
        for k in counts:
            counts[k] += launched[k]
        tk = rep_k["total"]
        emit({"phase": "reduced_moe", "arch": cfg.name, "tf32": False,
              "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
              "retention": "400 K, whole-leaf scrub" if ret else "off",
              "requests": len(rep_k["requests"]),
              "clock_steps": rep_k["clock_steps"],
              "bits_written": tk["bits_written"],
              "bit_errors": tk["bit_errors"],
              "energy_pj": [tk["energy_pj"], rep_r["total"]["energy_pj"]],
              "launches": launched, **{k: lt[k] for k in (
                  "retention_flips", "residual_decayed_bits",
                  "scrub_passes") if k in lt}, "ok": True})
    return counts


@contextlib.contextmanager
def moe_drops():
    """Inside, every MoE FFN call keeps its dropped-assignment count (a
    device scalar; serving discards it) in ``seen["prefill"]`` (prompt
    calls) or ``seen["decode"]``; reading them after the run is the
    only sync."""
    from repro_torch.models import moe
    saved = moe.moe_apply
    seen = {"prefill": [], "decode": []}

    def spy(p, x, cfg, *group):
        y, aux = saved(p, x, cfg, *group)
        seen["prefill" if x.shape[1] > 1 else "decode"].append(
            aux["dropped"])
        return y, aux

    moe.moe_apply = spy
    try:
        yield seen
    finally:
        moe.moe_apply = saved


def moe_dense_check(eng, device) -> float:
    """Layer 0's MoE FFN at full width on 4 decode tokens against the
    plain per-token loop (each token through its top-k experts, the bf16
    weights upcast, float32 throughout). Returns the largest difference
    over the loop's largest value; bf16 rounding of the expert products
    and of the k-term sum keeps it near 2^-8."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe
    cfg = eng.cfg
    p = {k: v[0] for k, v in eng.params["layers"]["moe"].items()}
    g = torch.Generator(device=device)
    g.manual_seed(5)
    x = torch.randn((1, 4, cfg.d_model), generator=g, device=device).to(
        torch.bfloat16)
    y, aux = moe.moe_apply(p, x, cfg)
    xf = x[0].float()
    probs = torch.softmax(xf @ p["router"].float(), dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token)
    gates = gates / gates.sum(-1, keepdim=True)
    ref = torch.zeros((4, cfg.d_model), device=device)
    for t, e in enumerate(idx.tolist()):
        for j, ej in enumerate(e):
            h = (F.silu(xf[t] @ p["wi_gate"][ej].float())
                 * (xf[t] @ p["wi_up"][ej].float()))
            ref[t] += gates[t, j] * (h @ p["wo"][ej].float())
    err = float((y[0].float() - ref).abs().max() / ref.abs().max())
    if int(aux["dropped"]) or not err < 2.0 ** -5:
        raise AssertionError(f"moe at full width: {err} against the plain "
                             f"loop, {int(aux['dropped'])} dropped")
    return err


def moe_serving(device, arch: str, layers: int, phase: str):
    """``arch`` at full published width, its depth cut to ``layers``
    (bf16, random weights from seed 0): layer 0's MoE FFN against the
    plain per-token loop, the ms per decode step at batch 4, the
    ``full`` traffic twice, identical in tokens, counts, launches and
    dropped assignments (counted at the prefills; a decode step drops
    none), and the admission write at this cache's shape against the
    twin, timed; one ``phase`` line. Returns the extent_write launches
    of one run and the admission write's timing."""
    import dataclasses
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    from repro_torch.models import get_model, moe
    from repro_torch.serve import ServeConfig, ServingEngine
    published = get_config(arch)
    cfg = dataclasses.replace(published, num_layers=layers)
    t0 = time.perf_counter()
    params = get_model(cfg).init(0, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=PROMPT_LEN + NEW_TOKENS, max_new_tokens=NEW_TOKENS,
        backend="cuda"), params, device=device)
    dense_err = moe_dense_check(eng, device)
    step_ms = decode_step_ms(eng, PROMPT_LEN, CAPACITY)
    runs = []
    for _ in range(2):
        with moe_drops() as seen:
            reset_launches()
            rep, sch, wall = serve_full(eng, PROMPT_LEN)
            launches = read_launches()
        check_write_launches(launches, rep)
        no_launch_but(launches, "extent_write", phase)
        drops = {k: [int(d) for d in torch.stack(v).tolist()]
                 for k, v in seen.items()}
        runs.append((rep, wall, launches, drops))
    (rep, wall, launches, drops), again = runs
    if not (same_run(again[0], rep) and again[2] == launches
            and again[3] == drops):
        raise AssertionError(f"{phase}: two runs of one traffic differ")
    if any(drops["decode"]):
        raise AssertionError(f"{phase}: a decode step dropped an "
                             f"assignment")
    groups = rep["pool"]["admission_groups"]
    if len(drops["prefill"]) != layers * groups:
        raise AssertionError(f"{phase}: {len(drops['prefill'])} prefill "
                             f"MoE calls for {groups} admission groups")
    peak = torch.cuda.max_memory_allocated()
    # the admission write at this cache's shape (layers, 1, 288, 8, 128)
    vecs = eng.vectors_for_floor(Priority.LOW)
    news = admission_rows(eng, 11)
    stale = T.leaves(sch.pool.extract_rows([0]))
    adm = time_writes(
        f"{phase} admission {tuple(news[0].shape)} over stale rows",
        [(ops.to_lanes(o), ops.to_lanes(n),
          (v.thr01, v.thr10, v.le01, v.le10))
         for o, n, v in zip(stale, news, vecs) if v is not None])
    tot = rep["total"]
    emit({"phase": phase, "arch": cfg.name, "layers": layers,
          "layers_published": published.num_layers,
          "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
          "capacity_factor": cfg.capacity_factor,
          "params": eng.api.num_params(),
          "active_params_per_token": eng.api.active_params_per_token(),
          "param_bytes": n_bytes, "init_s": init_s,
          "requests": N_REQ, "capacity": CAPACITY, "prompt_len": PROMPT_LEN,
          "new_tokens": NEW_TOKENS, "clock_steps": rep["clock_steps"],
          "decode_steps": rep["decode_steps"], "bursts": rep["bursts"],
          "admission_groups": groups, "wall_s": [wall, again[1]],
          "tokens_per_s": N_REQ * NEW_TOKENS / wall,
          "decode_ms_per_step_b4": step_ms, "peak_mem_bytes": peak,
          "expert_capacity_prompt": moe.capacity_for(cfg, PROMPT_LEN),
          "prefill_dropped_total": sum(drops["prefill"]),
          "prefill_dropped_per_layer_call": drops["prefill"],
          "decode_dropped_total": 0,
          "dense_loop_max_rel_err": dense_err,
          "kv_write_energy_pj": tot["energy_pj"],
          "ber": tot["ber_realized"], "bursts_sync_free": True,
          "two_runs_identical": True,
          "extent_write_launches": launches["extent_write"],
          "admission_write": adm, "ok": True})
    return launches["extent_write"], adm


def phase_moe(device):
    """dbrx-132b at full published width (d_model 6144, 48 heads over 8 KV
    heads of 128, 16 experts top-4, d_ff 10752, vocab 100352, capacity
    factor 1.25), MOE_LAYERS of its 40 layers, through ``moe_serving``."""
    return moe_serving(device, "dbrx-132b", MOE_LAYERS, "moe")


def phase_scout(device):
    """llama4-scout-17b-a16e at full published width (d_model 5120, 40
    heads over 8 KV heads of 128, 16 experts top-1, d_ff 8192, vocab
    202048, capacity factor 1.25), SCOUT_LAYERS of its 48 layers, through
    ``moe_serving``: top-1 routing at full width."""
    return moe_serving(device, "llama4-scout-17b-a16e", SCOUT_LAYERS,
                       "scout")


#: the ssm phase's prompts: four chunks of mamba2's 256-token scan
PROMPT_LEN_SSM = 1024
#: the depths of the ssm and vlm phases: 8 of mamba2-2.7b's 64 layers and
#: of llava-next-mistral-7b's 32, so that the script's run time leaves
#: room for the dense windowed models at full depth (both steps are
#: host-bound and their layers repeat)
SSM_LAYERS, VLM_LAYERS = 8, 8
#: the vlm phase's text prompts, each behind its 2880 image columns
PROMPT_LEN_VLM = 256
#: the audio phase: whisper's 30-second window of frames (the reference's
#: recipes use 24), 16-token prompts, 64 new tokens, a batch of 4
AUDIO_FRAMES, AUDIO_PROMPT, AUDIO_NEW, AUDIO_BATCH = 1500, 16, 64, 4
#: scrub passes the reference's scheduler reports for reduced mamba2-2.7b
#: on the fixture trace at 400 K with a periodic pass every 2 steps
#: (tests/test_torch_ssm.py holds the reference to it)
MAMBA2_SCRUB_PASSES = 5
#: the reduced families' retention case
RETENTION_400K = dict(retention_scale=1000.0, ambient_k=400.0)


def serve_stream(cfg, params, backend, device, requests, max_seq, scrub,
                 **kw):
    """``requests`` at capacity 2 (``scrub``: a whole-leaf pass every 2
    steps); ``kw`` goes to ServeConfig. Returns the report."""
    from repro_torch.reliability import make_scrub_policy
    from repro_torch.serve import (ContinuousScheduler, ServeConfig,
                                   ServingEngine)
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=max_seq, max_new_tokens=max(r.new_tokens for r in requests),
        backend=backend, **kw), params, device=device)
    policy = make_scrub_policy("periodic", 2, 0) if scrub else None
    return ContinuousScheduler(eng, capacity=2,
                               scrub_policy=policy).run(requests)


def kernel_and_twin(serve, what):
    """``serve(backend)`` through the kernels, then through the twins
    (which must launch nothing): (kernel report, twin report, the kernel
    run's launches)."""
    n0 = read_launches()
    rep_k = serve("cuda")
    n1 = read_launches()
    rep_r = serve("lanes_ref")
    if read_launches() != n1:
        raise AssertionError(f"{what}: the twin run launched a kernel")
    return rep_k, rep_r, {k: n1[k] - n0[k] for k in n1}


def phase_reduced_families(device):
    """Reduced mamba2-2.7b, llava-next-mistral-7b and whisper-large-v3 in
    float32 (TF32 off) through the kernels and through the twins: mamba2
    continuous on the fixture trace without retention and at 400 K with
    whole-leaf scrubbing (no launch, no bit written, the reference's
    scrub passes), llava continuous on a synthetic stream the same two
    ways (tokens, flips, errors, lifetime counters identical), whisper
    ``generate``. Returns the kernel runs' extent_write and scrub
    launches."""
    import numpy as np
    import torch
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import (ServeConfig, ServingEngine,
                                   synthetic_requests)
    from repro_torch.serve.scheduler import modal_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts = {"extent_write": 0, "scrub": 0}

    def lifetime(rep):
        lt = rep.get("lifetime", {})
        return {k: lt[k] for k in ("retention_flips",
                                   "residual_decayed_bits",
                                   "scrub_passes") if k in lt}

    cfg = get_config("mamba2-2.7b").reduced()
    params = get_model(cfg).init(0, device)
    for ret in ({}, RETENTION_400K):
        what = "reduced mamba2" + (", 400 K scrub" if ret else "")
        rep_k, rep_r, launched = kernel_and_twin(
            lambda b: serve_trace(cfg, params, b, device,
                                  scrub_cols=0 if ret else None, **ret)[0],
            what)
        same_serve(rep_k, rep_r, what)
        tk, lt = rep_k["total"], lifetime(rep_k)
        if any(launched.values()) or tk["bits_written"] or tk["energy_pj"]:
            raise AssertionError(f"{what}: an EXACT cache wrote: "
                                 f"{launched}, {tk}")
        if ret and not (lt["scrub_passes"] == MAMBA2_SCRUB_PASSES
                        and lt["retention_flips"] == 0
                        and lt["residual_decayed_bits"] == 0
                        and rep_k["lifetime"]["scrub_energy_pj"] == 0.0):
            raise AssertionError(f"{what}: {rep_k['lifetime']}")
        emit({"phase": "reduced_families", "arch": cfg.name,
              "tf32": False, "path": "continuous, fixture trace",
              "retention": "400 K, whole-leaf scrub" if ret else "off",
              "requests": len(rep_k["requests"]),
              "clock_steps": rep_k["clock_steps"],
              "bits_written": tk["bits_written"],
              "energy_pj": tk["energy_pj"], "launches": launched,
              **lt, "ok": True})

    cfg = get_config("llava-next-mistral-7b").reduced()
    params = get_model(cfg).init(0, device)
    reqs = synthetic_requests(cfg, 3, device=device, prompt_len=12,
                              new_tokens=4, arrival_every=1)
    max_seq = 12 + 4 + cfg.num_image_tokens
    for ret in ({}, RETENTION_400K):
        what = "reduced llava" + (", 400 K scrub" if ret else "")
        rep_k, rep_r, launched = kernel_and_twin(
            lambda b: serve_stream(cfg, params, b, device, reqs, max_seq,
                                   bool(ret), **ret), what)
        same_serve(rep_k, rep_r, what)
        check_write_launches(launched, rep_k)
        lt = lifetime(rep_k)
        if ret and not (lt["scrub_passes"] > 0 and lt["retention_flips"] > 0
                        and launched["scrub"] == 2 * lt["scrub_passes"]):
            raise AssertionError(f"{what}: launches {launched}, {lt}")
        for k in counts:
            counts[k] += launched[k]
        tk = rep_k["total"]
        emit({"phase": "reduced_families", "arch": cfg.name,
              "tf32": False, "path": "continuous, synthetic stream",
              "retention": "400 K, whole-leaf scrub" if ret else "off",
              "requests": len(rep_k["requests"]),
              "clock_steps": rep_k["clock_steps"],
              "bits_written": tk["bits_written"],
              "bit_errors": tk["bit_errors"],
              "energy_pj": [tk["energy_pj"], rep_r["total"]["energy_pj"]],
              "launches": launched, **lt, "ok": True})

    cfg = get_config("whisper-large-v3").reduced()
    params = get_model(cfg).init(0, device)
    batch = {"tokens": torch.from_numpy(rng.randint(
        rng.PRNGKey(0), (2, 12), 0, cfg.vocab_size).astype(np.int64)).to(
        device), **modal_leaves(cfg, 1, device, batch=2)}

    def generate(backend):
        eng = ServingEngine(cfg, ServeConfig(max_seq=12 + 5,
                                             max_new_tokens=5,
                                             backend=backend),
                            params, device=device)
        return eng.generate(batch)

    (tok_k, rep_k), (tok_r, rep_r), launched = kernel_and_twin(
        generate, "reduced whisper")
    for s, r in rep_r["streams"].items():
        k = rep_k["streams"][s]
        if any(k[f] != r[f] for f in ("bits_written", "bits_total",
                                       "bit_errors")) or not math.isclose(
                k["energy_pj"], r["energy_pj"], rel_tol=RTOL_ENERGY):
            raise AssertionError(f"reduced whisper: stream {s} differs")
    # four leaves (self and cross K and V) at the prefill and each step
    if not torch.equal(tok_k, tok_r) or launched["extent_write"] != 4 * 5 \
            or launched["scrub"]:
        raise AssertionError(f"reduced whisper: launches {launched}")
    counts["extent_write"] += launched["extent_write"]
    tk = rep_k["total"]
    emit({"phase": "reduced_families", "arch": cfg.name, "tf32": False,
          "path": "generate, batch 2, 24 frames",
          "bits_written": tk["bits_written"], "bit_errors": tk["bit_errors"],
          "energy_pj": [tk["energy_pj"], rep_r["total"]["energy_pj"]],
          "launches": launched, "ok": True})
    return counts


def load_full(arch, device, layers=None):
    """The published config at full width and depth (``layers``: its
    depth cut to that many layers), random bf16 weights from seed 0:
    (cfg, params, init seconds, weight bytes)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    params = get_model(cfg).init(0, device)
    torch.cuda.synchronize()
    return (cfg, params, time.perf_counter() - t0,
            sum(p.numel() * p.element_size() for p in _leaves(params)))


def no_launch_but(launches, kernel: str, what: str) -> None:
    if any(v for k, v in launches.items() if k != kernel):
        raise AssertionError(f"{what} launched another kernel: {launches}")


def phase_ssm(device):
    """mamba2-2.7b at full published width (d_model 2560, 80 heads of 64,
    state 128, conv 4, chunk 256, vocab 50280, bf16), SSM_LAYERS of its
    64 layers: the ``full`` traffic with 1024-token prompts, twice. The
    recurrent state and conv leaves are pinned EXACT, so no kernel
    launches and no bit is written. Returns the launches of one run (all
    0)."""
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg, params, init_s, n_bytes = load_full("mamba2-2.7b", device,
                                             SSM_LAYERS)
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=PROMPT_LEN_SSM + NEW_TOKENS, max_new_tokens=NEW_TOKENS,
        backend="cuda"), params, device=device)
    step_ms = decode_step_ms(eng, PROMPT_LEN_SSM, CAPACITY)
    runs = []
    for _ in range(2):
        reset_launches()
        rep, _, wall = serve_full(eng, PROMPT_LEN_SSM, writes=False)
        launches = read_launches()
        if any(launches.values()):
            raise AssertionError(f"ssm launched a kernel: {launches}")
        runs.append((rep, wall))
    (rep, wall), again = runs
    if not same_run(again[0], rep):
        raise AssertionError("ssm: two runs of one traffic differ")
    slot = eng.api.init_cache(1, 1, "meta")
    state_bytes = {k: v.numel() * v.element_size() for k, v in slot.items()}
    emit({"phase": "ssm", "arch": cfg.name, "layers": cfg.num_layers,
          "layers_published": 64,
          "params": eng.api.num_params(), "param_bytes": n_bytes,
          "init_s": init_s, "requests": N_REQ, "capacity": CAPACITY,
          "prompt_len": PROMPT_LEN_SSM, "chunks_per_prompt":
          PROMPT_LEN_SSM // cfg.ssm_chunk, "new_tokens": NEW_TOKENS,
          "clock_steps": rep["clock_steps"],
          "decode_steps": rep["decode_steps"], "bursts": rep["bursts"],
          "wall_s": [wall, again[1]],
          "tokens_per_s": N_REQ * NEW_TOKENS / wall,
          "decode_ms_per_step_b4": step_ms,
          "state_bytes_per_slot": state_bytes,
          "bits_written": rep["total"]["bits_written"],
          "bursts_sync_free": True, "two_runs_identical": True,
          "extent_write_launches": launches["extent_write"], "ok": True})
    return launches


def phase_vlm(device):
    """llava-next-mistral-7b at full published width (d_model 4096, 32
    heads over 8 KV heads of 128, d_ff 14336, vocab 32000, 2880 image
    tokens of 1024, bf16), VLM_LAYERS of its 32 layers: the ``full``
    traffic with 256-token text prompts behind their image columns
    (max_seq 3168), the embeddings drawn by ``synthetic_requests`` from
    each request's modal_seed, twice; then one admission write (8, 1,
    3168, 8, 128) bf16 held against the twin and timed. Returns the
    launches of one run and the write's timing."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    from repro_torch.serve import (ServeConfig, ServingEngine,
                                   synthetic_requests)
    cfg, params, init_s, n_bytes = load_full("llava-next-mistral-7b", device,
                                             VLM_LAYERS)
    max_seq = cfg.num_image_tokens + PROMPT_LEN_VLM + NEW_TOKENS
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=max_seq, max_new_tokens=NEW_TOKENS, backend="cuda"), params,
        device=device)
    t0 = time.perf_counter()
    reqs = synthetic_requests(cfg, N_REQ, device=device,
                              prompt_len=PROMPT_LEN_VLM,
                              new_tokens=NEW_TOKENS, arrival_every=4,
                              app_ids=("batch", "chat"))
    draw_s = time.perf_counter() - t0
    step_ms = decode_step_ms(eng, PROMPT_LEN_VLM, CAPACITY, extra={
        "image_embeds": torch.cat([r.prompt["image_embeds"]
                                   for r in reqs[:CAPACITY]])})
    runs = []
    for _ in range(2):
        reset_launches()
        rep, sch, wall = serve_full(eng, PROMPT_LEN_VLM, requests=reqs)
        launches = read_launches()
        check_write_launches(launches, rep)
        no_launch_but(launches, "extent_write", "vlm")
        runs.append((rep, sch, wall, launches))
    (rep, sch, wall, launches), again = runs[0], runs[1]
    if not (same_run(again[0], rep) and again[3] == launches):
        raise AssertionError("vlm: two runs of one traffic differ")
    peak = torch.cuda.max_memory_allocated()
    vecs = eng.vectors_for_floor(Priority.LOW)
    news = T.leaves(eng.api.prefill(params, reqs[0].prompt, max_seq)[1])
    stale = T.leaves(sch.pool.extract_rows([0]))
    adm = time_writes(
        f"vlm admission {tuple(news[0].shape)} {str(news[0].dtype)[6:]} "
        f"over stale rows",
        [(ops.to_lanes(o), ops.to_lanes(n),
          (v.thr01, v.thr10, v.le01, v.le10))
         for o, n, v in zip(stale, news, vecs)], derived_rtol=True)
    tot = rep["total"]
    emit({"phase": "vlm", "arch": cfg.name, "layers": cfg.num_layers,
          "layers_published": 32,
          "params": eng.api.num_params(), "param_bytes": n_bytes,
          "init_s": init_s, "requests": N_REQ, "capacity": CAPACITY,
          "prompt_len": PROMPT_LEN_VLM,
          "image_tokens": cfg.num_image_tokens, "max_seq": max_seq,
          "new_tokens": NEW_TOKENS, "modal_draw_s": draw_s,
          "clock_steps": rep["clock_steps"],
          "decode_steps": rep["decode_steps"], "bursts": rep["bursts"],
          "admission_groups": rep["pool"]["admission_groups"],
          "wall_s": [wall, again[2]],
          "tokens_per_s": N_REQ * NEW_TOKENS / wall,
          "decode_ms_per_step_b4": step_ms, "peak_mem_bytes": peak,
          "kv_write_energy_pj": tot["energy_pj"],
          "ber": tot["ber_realized"], "bursts_sync_free": True,
          "two_runs_identical": True,
          "extent_write_launches": launches["extent_write"],
          "admission_write": adm, "ok": True})
    return launches["extent_write"], adm


def phase_audio(device):
    """whisper-large-v3 at full published width and depth (32 encoder and
    32 decoder layers, d_model 1280, 20 heads of 64, d_ff 5120, vocab
    51866, bf16): the scheduler refuses the engine; ``generate`` at batch
    4 over 1500 frames (normal draws off PRNGKey(1), the launcher's
    recipe), 16-token prompts and 64 new tokens, twice. Four
    extent_write launches at the prefill and at each step; the decode
    columns of the unchanged cross cache flip nothing. The prefill
    write's cross K/V (32, 4, 1500, 20, 64) bf16 and a decode step's self
    K column are held against the twin and timed. Returns the launches
    of one run and the timings."""
    import numpy as np
    import torch
    from repro_torch import rng
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    from repro_torch.serve import (ContinuousScheduler, ServeConfig,
                                   ServingEngine)
    from repro_torch.serve.scheduler import modal_leaves
    cfg, params, init_s, n_bytes = load_full("whisper-large-v3", device)
    max_seq = AUDIO_PROMPT + AUDIO_NEW

    def engine():
        return ServingEngine(cfg, ServeConfig(
            max_seq=max_seq, max_new_tokens=AUDIO_NEW, backend="cuda"),
            params, device=device)

    try:
        ContinuousScheduler(engine(), capacity=CAPACITY)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("audio: the scheduler took an audio engine")
    t0 = time.perf_counter()
    frames = modal_leaves(cfg, 1, device, batch=AUDIO_BATCH,
                          frames=AUDIO_FRAMES)
    draw_s = time.perf_counter() - t0
    batch = {"tokens": torch.from_numpy(rng.randint(
        rng.PRNGKey(0), (AUDIO_BATCH, AUDIO_PROMPT), 0,
        cfg.vocab_size).astype(np.int64)).to(device), **frames}
    eng = engine()
    step_ms = decode_step_ms(eng, AUDIO_PROMPT, AUDIO_BATCH, extra=frames)
    runs = []
    for _ in range(2):
        eng = engine()   # a fresh meter: each report is one run's
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, rep = eng.generate(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if launches["extent_write"] != 4 * AUDIO_NEW:
            raise AssertionError(f"audio: {launches} launches, not 4 leaves "
                                 f"x {AUDIO_NEW} writes")
        no_launch_but(launches, "extent_write", "audio")
        runs.append((toks, rep, wall))
    (toks, rep, wall), again = runs
    if not (torch.equal(toks, again[0])
            and same_run(again[1], rep, ("streams", "total"))):
        raise AssertionError("audio: two runs differ")
    if not (toks.shape == (AUDIO_BATCH, AUDIO_NEW)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
        raise AssertionError("audio: bad token output")
    peak = torch.cuda.max_memory_allocated()
    # one prefill and one decode step off the run's path: the decode
    # column of the cross leaves (unchanged) flips nothing
    vecs = eng.vectors_for_floor(Priority.LOW)
    with uncounted("extent_write"):
        tok, cache, key, _ = eng.prefill(params, batch, None,
                                         rng.PRNGKey(5), vecs)
        pos = torch.full((AUDIO_BATCH,), AUDIO_PROMPT, dtype=torch.int64,
                         device=device)
        new = eng.api.decode_step(params, tok, cache, pos, max_seq)[1]
        _, st = eng.plan.write_columns(
            key, cache, {"self": cache["self"], "cross": new["cross"]}, pos,
            vecs)
        cross_flips = int(st.bits_written)
    if cross_flips:
        raise AssertionError(f"audio: {cross_flips} flips in the cross "
                             f"cache's decode columns")
    # leaves in tree order: cross k, cross v, self k, self v
    _, rows = eng.api.prefill(params, batch, max_seq)
    lanes = ops.to_lanes(rows["cross"]["k"]).numel()
    if lanes >= 2 ** 32:
        raise AssertionError(f"audio: {lanes} lanes overflow the index")

    def vec4(v):
        return (v.thr01, v.thr10, v.le01, v.le10)

    pre = time_writes(
        f"audio prefill cross K/V {tuple(rows['cross']['k'].shape)} "
        f"{str(rows['cross']['k'].dtype)[6:]} over zeros",
        [(ops.to_lanes(torch.zeros_like(n)), ops.to_lanes(n), vec4(v))
         for n, v in zip((rows["cross"]["k"], rows["cross"]["v"]),
                         vecs[:2])], derived_rtol=True)
    col = slice(AUDIO_PROMPT, AUDIO_PROMPT + 1)
    dec = time_writes(
        f"audio decode column {tuple(cache['self']['k'][:, :, col].shape)}"
        f" {str(cache['self']['k'].dtype)[6:]}",
        [(ops.to_lanes(cache["self"][n][:, :, col]),
          ops.to_lanes(new["self"][n][:, :, col]), vec4(v))
         for n, v in (("k", vecs[2]), ("v", vecs[3]))])
    tot = rep["total"]
    emit({"phase": "audio", "arch": cfg.name, "layers": cfg.num_layers,
          "encoder_layers": cfg.num_encoder_layers,
          "params": eng.api.num_params(), "param_bytes": n_bytes,
          "init_s": init_s, "batch": AUDIO_BATCH, "frames": AUDIO_FRAMES,
          "prompt_len": AUDIO_PROMPT, "new_tokens": AUDIO_NEW,
          "modal_draw_s": draw_s, "wall_s": [wall, again[2]],
          "tokens_per_s": AUDIO_BATCH * AUDIO_NEW / wall,
          "decode_ms_per_step_b4": step_ms, "peak_mem_bytes": peak,
          "kv_write_energy_pj": tot["energy_pj"],
          "ber": tot["ber_realized"], "cross_lanes_per_leaf": lanes,
          "cross_decode_column_flips": cross_flips,
          "scheduler_refusal": refusal, "bursts_sync_free": True,
          "two_runs_identical": True,
          "extent_write_launches": launches["extent_write"],
          "prefill_cross_write": pre, "decode_column_write": dec,
          "ok": True})
    return launches["extent_write"], {"prefill_cross": pre,
                                      "decode_column": dec}


#: the dense windowed phase, each at full published width and depth:
#: gemma2-9b (a 4096-key window on alternate layers, softcaps 50 and 30,
#: post-norms, gelu), mistral-nemo-12b (no window) and h2o-danube-1.8b (a
#: 4096-key window on every layer, heads of 80)
DENSE_WINDOW_ARCHS = ("gemma2-9b", "mistral-nemo-12b", "h2o-danube-1.8b")
#: their prompts: past the 4096-key window, so every windowed leaf's
#: ring wraps at the prefill and again under the decode writes
PROMPT_LEN_WINDOWS = 6144
#: the windowed models' decode after the ring wrapped (NEW_TOKENS steps
#: from a PROMPT_LEN_WINDOWS-token prompt) against one prefill over the
#: same tokens, bf16. Held: the K and V the decode wrote in the first
#: WRAP_LAYERS layers, each layer's largest difference as a fraction of
#: its largest prefill value (layer 0's is the projection alone; layer
#: 1's reads layer 0's attention over the wrapped ring), within
#: WRAP_CACHE_RTOL; and gemma2-9b's last logits, as a fraction of the
#: largest, within WRAP_LOGITS_RTOL. The logits of a stack without
#: post-norms are not held: with random weights such a stack amplifies
#: the decode's and the prefill's different rounding about 45x a layer
#: (h2o-danube-1.8b in float32 on the CPU, window 64: 6.0e-6 at 2
#: layers, 0.31 at 8, 0.73 at 12), so at 24 layers its logits differ
#: wholly either way; they are printed. Bounds at about three times the
#: largest measured on the H100 (80GB HBM3, 700 W): layers 0-1 5.4e-3
#: (gemma2-9b's layer 1; h2o-danube-1.8b's 3.7e-3), gemma2-9b's logits
#: 2.2e-2; lifting the windows moves layer 1 by 0.69 and 0.93 and
#: gemma2-9b's logits by 0.58
WRAP_LAYERS = 2
WRAP_CACHE_RTOL = 0.016
WRAP_LOGITS_RTOL = 0.066


def wrap_check(eng, device) -> dict:
    """One request through the model of ``eng`` (bf16): a prompt of
    PROMPT_LEN_WINDOWS tokens, then NEW_TOKENS decode steps fed the
    following tokens, against one prefill over all of them, and against
    a prefill with every window lifted (the difference the windows
    make). Per layer, the decode-written K/V columns' largest difference
    from the prefill's, as a fraction of the layer's largest prefill
    value; the last logits' likewise. Held as WRAP_CACHE_RTOL and
    WRAP_LOGITS_RTOL say."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import FULL_ATTENTION
    from repro_torch.models import get_model
    from repro_torch.models.transformer import cache_spec
    cfg, api, params = eng.cfg, eng.api, eng.params
    max_seq = PROMPT_LEN_WINDOWS + NEW_TOKENS
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (1, max_seq))).to(device)
    logits, cache = api.prefill(
        params, {"tokens": toks[:, :PROMPT_LEN_WINDOWS]}, max_seq)
    for i in range(PROMPT_LEN_WINDOWS, max_seq):
        logits, cache = api.decode_step(
            params, toks[:, i], cache,
            torch.full((1,), i, dtype=torch.int64, device=device), max_seq)
    lifted = get_model(dataclasses.replace(cfg, window_pattern=tuple(
        FULL_ATTENTION for _ in cfg.window_pattern)))
    spec = cache_spec(cfg, max_seq)
    plen = len(cfg.window_pattern)
    written = torch.arange(PROMPT_LEN_WINDOWS, max_seq, device=device)

    def against(model):
        ref, ref_cache = model.prefill(params, {"tokens": toks}, max_seq)
        ref_spec = cache_spec(model.cfg, max_seq)
        per_layer = []
        for layer in range(cfg.num_layers):
            name, g = f"slot{layer % plen}", layer // plen
            errs = []
            for kv in ("k", "v"):
                got = cache[name][kv][g][:, written % spec[name][0]]
                want = ref_cache[name][kv][g][
                    :, written % ref_spec[name][0]].float()
                errs.append(float((got.float() - want).abs().max())
                            / float(want.abs().max()))
            per_layer.append(max(errs))
        return (float((logits - ref).abs().max())
                / float(ref.abs().max()), per_layer)

    logits_err, layers = against(api)
    lifted_logits, lifted_layers = against(lifted)
    held_logits = cfg.use_post_norms
    out = {"decode_steps": NEW_TOKENS,
           "positions": [PROMPT_LEN_WINDOWS, max_seq - 1],
           "held_layers": WRAP_LAYERS, "cache_rtol": WRAP_CACHE_RTOL,
           "cache_rel_err_per_layer": layers,
           "unwindowed_cache_rel_err_per_layer": lifted_layers,
           "logits_rel_err": logits_err,
           "logits_held": held_logits,
           "logits_rtol": WRAP_LOGITS_RTOL if held_logits else None,
           "unwindowed_logits_rel_err": lifted_logits}
    if max(layers[:WRAP_LAYERS]) > WRAP_CACHE_RTOL or (
            held_logits and logits_err > WRAP_LOGITS_RTOL):
        raise AssertionError(f"dense_windows: {cfg.name}: decode after "
                             f"the wrap against a prefill {out}")
    return out


def phase_dense_windows(device, arch):
    """``arch`` at full published width and depth (bf16, random weights
    from seed 0): the ``full`` traffic with prompts of PROMPT_LEN_WINDOWS
    (max_seq 6176), twice, identical in tokens, flips, errors and
    launches, one extent_write launch per cache leaf (K and V of each
    window capacity) per admission group and decode step; then one
    admission write per capacity (a K leaf of a prompt over the stale
    rows of pool slot 0: a wrapped 4096-row ring, a 6176-row global
    leaf) against the twin, bit-exact with its energy inside
    ``energy_rtol``, and timed; for a windowed model ``wrap_check``.
    Returns the launches of one run and the writes' timings."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    from repro_torch.models.transformer import cache_spec
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg, params, init_s, n_bytes = load_full(arch, device)
    max_seq = PROMPT_LEN_WINDOWS + NEW_TOKENS
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=max_seq, max_new_tokens=NEW_TOKENS, backend="cuda"), params,
        device=device)
    spec = cache_spec(cfg, max_seq)
    pool = eng.api.init_cache(CAPACITY, max_seq, "meta")
    step_ms = decode_step_ms(eng, PROMPT_LEN_WINDOWS, CAPACITY)
    runs = []
    for _ in range(2):
        reset_launches()
        rep, sch, wall = serve_full(eng, PROMPT_LEN_WINDOWS)
        launches = read_launches()
        check_write_launches(launches, rep, 2 * len(spec))
        no_launch_but(launches, "extent_write", arch)
        runs.append((rep, wall, launches))
    (rep, wall, launches), again = runs
    if not (same_run(again[0], rep) and again[2] == launches):
        raise AssertionError(f"dense_windows: {arch}: two runs of one "
                             f"traffic differ")
    peak = torch.cuda.max_memory_allocated()
    vecs = eng.vectors_for_floor(Priority.LOW)
    news = admission_rows(eng, 11)
    stale = T.leaves(sch.pool.extract_rows([0]))
    del sch
    writes = {}
    for (path, _), o, n, v in zip(T.flatten(pool), stale, news, vecs):
        if path[-1] != "k":
            continue
        kind = "local" if spec[path[0]][0] < max_seq else "global"
        writes[kind] = time_writes(
            f"{arch} admission, {kind} K leaf {tuple(n.shape)} bf16 over "
            f"stale rows", [(ops.to_lanes(o), ops.to_lanes(n),
                             (v.thr01, v.thr10, v.le01, v.le10))],
            derived_rtol=True)
    del stale, news
    wrap = wrap_check(eng, device) if "local" in writes else None
    tot = rep["total"]
    emit({"phase": "dense_windows", "arch": cfg.name,
          "layers": cfg.num_layers, "head_dim": cfg.head_dim,
          "window_pattern": list(cfg.window_pattern),
          "cache_leaves": {k: {"capacity": c, "window": w}
                           for k, (c, w) in spec.items()},
          "params": eng.api.num_params(), "param_bytes": n_bytes,
          "init_s": init_s, "kv_pool_bytes": sum(
              x.numel() * x.element_size() for x in T.leaves(pool)),
          "requests": N_REQ, "capacity": CAPACITY,
          "prompt_len": PROMPT_LEN_WINDOWS, "max_seq": max_seq,
          "new_tokens": NEW_TOKENS, "clock_steps": rep["clock_steps"],
          "decode_steps": rep["decode_steps"], "bursts": rep["bursts"],
          "admission_groups": rep["pool"]["admission_groups"],
          "wall_s": [wall, again[1]],
          "tokens_per_s": N_REQ * NEW_TOKENS / wall,
          "decode_ms_per_step_b4": step_ms, "peak_mem_bytes": peak,
          "kv_write_energy_pj": tot["energy_pj"],
          "ber": tot["ber_realized"], "bursts_sync_free": True,
          "two_runs_identical": True,
          "extent_write_launches": launches["extent_write"],
          "admission_writes": writes, "wrap": wrap, "ok": True})
    return launches["extent_write"], writes


def phase_sampling(device, eng_full, full_launches):
    """The ``full`` traffic with ``greedy=False`` at temperature 1.0: two
    runs with one seed identical, a run with another ``ServeConfig.seed``
    different in tokens, the extent_write launches equal to ``full``'s,
    every burst sync-free; one sampling step's uniform draws (4 x vocab)
    on the card equal to the host's, bit for bit, in float32 (the logits'
    dtype) and in bfloat16. Returns the extent_write launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import rng
    from repro_torch.serve import ServingEngine
    vocab = eng_full.cfg.vocab_size
    key = rng.fold_in(rng.PRNGKey(9), 3)
    tiny = float(np.finfo(np.float32).tiny)
    draws = {}
    for name in ("float32", "bfloat16"):
        dev = rng.uniform_t(key, (CAPACITY, vocab), device,
                            getattr(torch, name), minval=tiny)
        host = rng.uniform(key, (CAPACITY, vocab), name, minval=tiny)
        if not np.array_equal(dev.float().cpu().numpy().view(np.int32),
                              host.view(np.int32)):
            raise AssertionError(f"sampling: {name} uniforms on the card "
                                 f"differ from the host's")
        g_dev = rng.gumbel_t(key, (CAPACITY, vocab), device,
                             getattr(torch, name)).float().cpu().numpy()
        g_host = rng.gumbel(key, (CAPACITY, vocab), name)
        draws[name] = {"uniform_identical": True,
                       "gumbel_differing": int((g_dev != g_host).sum()),
                       "gumbel_max_abs_diff": float(
                           np.abs(g_dev - g_host).max())}
    logits = torch.randn((CAPACITY, vocab), device=device)
    sample_ms = cuda_ms(lambda: rng.categorical_t(key, logits), iters=50)
    argmax_ms = cuda_ms(lambda: torch.argmax(logits, dim=-1), iters=50)

    def engine(**kw):
        return ServingEngine(eng_full.cfg, dataclasses.replace(
            eng_full.scfg, greedy=False, temperature=1.0, **kw),
            eng_full.params, device=device)

    runs = []
    for eng in (engine(), engine(), engine(seed=1)):
        reset_launches()
        rep, _, wall = serve_full(eng, PROMPT_LEN)
        runs.append((rep, wall, read_launches()))
    (rep, wall, launches), (rep2, _, launches2), (rep3, _, _) = runs

    def toks(r):
        return [r["requests"][i]["tokens"] for i in range(N_REQ)]

    if not (same_run(rep2, rep) and launches2 == launches):
        raise AssertionError("sampling: two runs with one seed differ")
    if toks(rep3) == toks(rep):
        raise AssertionError("sampling: another seed gave the same tokens")
    if launches["extent_write"] != full_launches:
        raise AssertionError(f"sampling: {launches} extent_write launches "
                             f"against full's {full_launches}")
    tot = rep["total"]
    emit({"phase": "sampling", "arch": eng_full.cfg.name, "greedy": False,
          "temperature": 1.0, "logits_dtype": "float32",
          "requests": N_REQ, "clock_steps": rep["clock_steps"],
          "decode_steps": rep["decode_steps"], "wall_s": wall,
          "tokens_per_s": N_REQ * NEW_TOKENS / wall,
          "sample_ms_per_step_b4": sample_ms,
          "argmax_ms_per_step_b4": argmax_ms, "draws": draws,
          "two_runs_identical": True, "other_seed_tokens_differ": True,
          "kv_write_energy_pj": tot["energy_pj"],
          "ber": tot["ber_realized"], "bursts_sync_free": True,
          "extent_write_launches": launches["extent_write"], "ok": True})
    return launches["extent_write"]


def phase_workload(device, eng_full):
    """The six presets generated for qwen2.5-3b (sha256 of each trace,
    held against the reference's, PRESET_SHA256);
    ``chat_batch`` served at full width through the scheduler (capacity
    4, launches counted); a synthetic stream recorded, saved, reloaded and
    replayed: the replay's report equals the original's. Returns the
    extent_write launches of the chat_batch run."""
    import dataclasses
    import hashlib
    import tempfile
    import torch
    from repro_torch.serve import (ContinuousScheduler, ServingEngine,
                                   synthetic_requests)
    from repro_torch.workload import (PRESETS, TraceSource, load_trace,
                                      make_workload, pressure_score,
                                      record_requests, save_trace)
    from repro_torch.workload.trace import dumps
    cfg = eng_full.cfg
    t0 = time.perf_counter()
    traces = {name: make_workload(name, cfg, WORKLOAD_EVENTS,
                                  seed=WORKLOAD_SEED) for name in PRESETS}
    gen_s = time.perf_counter() - t0
    digests = {name: hashlib.sha256(dumps(t).encode()).hexdigest()
               for name, t in traces.items()}
    if cfg.name == "qwen2.5-3b" and digests != PRESET_SHA256:
        raise AssertionError(f"workload: generated traces differ from the "
                             f"reference's: {digests}")

    def engine(max_seq, new_tokens):
        return ServingEngine(cfg, dataclasses.replace(
            eng_full.scfg, max_seq=max_seq, max_new_tokens=new_tokens),
            eng_full.params, device=device)

    def serve(trace_or_reqs, eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = ContinuousScheduler(eng, capacity=CAPACITY).run(trace_or_reqs)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    chat = traces["chat_batch"]
    reset_launches()
    rep, wall = serve(TraceSource(chat, cfg, device),
                      engine(chat.max_seq(), chat.max_new_tokens()))
    launches = read_launches()
    check_write_launches(launches, rep)
    tokens = sum(e.new_tokens for e in chat.events)
    if sum(len(r["tokens"]) for r in rep["requests"].values()) != tokens:
        raise AssertionError("workload: chat_batch served the wrong count")
    # a synthetic stream, recorded and replayed
    reqs = synthetic_requests(cfg, N_REQ, device=device, prompt_len=64,
                              new_tokens=8, arrival_every=2,
                              app_ids=("chat", "batch"))
    rec = record_requests(reqs, cfg, meta={"source": "synthetic"})
    base, _ = serve(reqs, engine(72, 8))
    with tempfile.TemporaryDirectory() as d:
        loaded = load_trace(save_trace(rec, Path(d) / "stream.jsonl"))
    replay, _ = serve(TraceSource(loaded, cfg, device),
                      engine(loaded.max_seq(), loaded.max_new_tokens()))
    if not (dumps(loaded) == dumps(rec) and replay == base):
        raise AssertionError("workload: the replayed stream's report "
                             "differs from the original's")
    emit({"phase": "workload", "arch": cfg.name, "events": WORKLOAD_EVENTS,
          "seed": WORKLOAD_SEED, "generate_s": gen_s,
          "sha256": digests,
          "pressure": {n: pressure_score(t) for n, t in traces.items()},
          "chat_batch": {"requests": len(chat.events),
                         "clock_steps": rep["clock_steps"],
                         "decode_steps": rep["decode_steps"],
                         "bursts": rep["bursts"], "wall_s": wall,
                         "tokens_per_s": tokens / wall,
                         "kv_write_energy_pj": rep["total"]["energy_pj"],
                         "ber": rep["total"]["ber_realized"],
                         "launches": launches},
          "replay_equals_original": True, "bursts_sync_free": True,
          "ok": True})
    return launches["extent_write"]


def decode_step_ms(eng, prompt_len, batch, extra=None) -> float:
    """Milliseconds per fused decode step (model + column writes) at a
    full pool, timed over one 16-step burst after a prefill and a 2-step
    warm-up burst (the setup ``repro_torch.launch.profile`` profiles).
    ``extra``: the prompts' multimodal leaves."""
    import torch
    from repro_torch.launch.profile import steady_burst
    run = steady_burst(eng, batch, prompt_len, seed=3, extra=extra)
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


def check_against_twin(o_u, n_u, seed, vec, rtol=RTOL_ENERGY):
    """Largest difference of stored words and counts between the kernel
    and its twin on the same lanes (launches here are not counted), the
    flips, and the energies' relative difference (at most ``rtol``)."""
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
    rel = abs(e_k - e_r) / abs(e_r) if e_r else abs(e_k)
    if diff or rel > rtol:
        raise AssertionError("kernel disagrees with its twin on the main "
                             "path's operands")
    return diff, int(st_r["flips01"]) + int(st_r["flips10"]), rel


def energy_rtol(lanes: int, peak: float) -> float:
    """The largest relative error float32 summation can put on a write's
    energy, every term positive: recursive summation errs by at most
    (depth) x 2^-24 of the sum, where depth counts the additions a term
    passes through. In the kernel a thread adds the energies of the
    flipped planes it takes in sequence, at most ceil(``peak``) a warp
    step (``peak``: the most flipped planes a lane of any warp step
    averages, ``warp_flips``) over its grid-stride steps; then a warp
    tree (5 levels), a block tree (3) and the sum of the per-block
    partials (bounded as ``grid`` additions in sequence). The twin sums
    in float64, exact here, and rounds once (1 more). This is
    extent_write's bound; scrub's energy equals its twin's."""
    from repro_torch.kernels import build as B
    threads = kernel_wrapper("extent_write")._threads
    grid = max(1, min(B.MAX_GRID, -(-lanes // threads)))
    steps = -(-lanes // (grid * threads))
    return (steps * math.ceil(peak) + 5 + 3 + grid + 1) * 2.0 ** -24


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

    terms = {"bytes": bytes_per_lane * lanes / hw().HBM_BW * 1e3,
             "f32_energy_adds": flips / hw().PEAK_FLOPS_F32 * 1e3,
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


def time_writes(name, writes, derived_rtol=False):
    """extent_write over a list of (old lanes, new lanes, vectors), held
    against the twin, then timed (12 bytes per lane). ``warp_steps_16``
    is the share of the kernel's warp steps whose lanes average 16 or
    more flipped planes, the longest queues. With ``derived_rtol`` the
    energies agree within ``energy_rtol`` of each write (printed with
    the difference found) instead of RTOL_ENERGY."""
    from repro_torch.kernels.extent_write import ref
    worst, flips, dense, peak = 0, 0, 0.0, 0.0
    extra = {"energy_rel_err": 0.0, "energy_rtol": 0.0} if derived_rtol \
        else {}
    for o, n, vec in writes:
        share, most = warp_flips(o, n)
        rtol = RTOL_ENERGY
        if derived_rtol:
            rtol = energy_rtol(o.numel(), most)
            extra["energy_rtol"] = max(extra["energy_rtol"], rtol)
        d, f, rel = check_against_twin(o, n, 1, vec, rtol)
        worst, flips = max(worst, d), flips + f
        if derived_rtol:
            extra["energy_rel_err"] = max(extra["energy_rel_err"], rel)
        dense, peak = dense + share / len(writes), max(peak, most)
    return {"shape": name, "max_abs_err": worst, "warp_steps_16": dense,
            "warp_step_flips_per_lane_max": peak, **extra, **time_kernel(
        "extent_write", ref.extent_write_ref, "extent_write_kernel",
        [(o, n, 1, *vec) for o, n, vec in writes], 12, flips)}


def walked_planes(s_u, m_u) -> int:
    """The draws the scrub kernel makes on (stored, mask) lanes. A warp
    trip takes 128 x ``scrub_vecs`` lanes on the 16-byte grid of the
    stored lanes. Where its masks set more than ``scrub_sparse_bits``
    bits, it walks every set plane of their OR, drawing each of its lanes
    at each; where they set fewer, it draws those bits alone; where none,
    nothing."""
    import torch
    w = kernel_wrapper("scrub")
    w._load()
    g = 128 * w._vecs(m_u.numel())
    lead = s_u.data_ptr() // 4 % 4
    tail = -(lead + m_u.numel()) % g
    m = torch.cat([m_u.new_zeros(lead), m_u, m_u.new_zeros(tail)])
    m = m.view(-1, g)
    lanes = torch.full((m.shape[0],), g, dtype=torch.int64, device=m.device)
    lanes[0] -= lead
    lanes[-1] -= tail
    planes, bits = torch.zeros_like(lanes), torch.zeros_like(lanes)
    for b in range(32):
        hits = ((m >> b) & 1).sum(1)
        planes += hits > 0
        bits += hits
    walked = torch.where(bits > w._sparse_bits, planes * lanes, bits)
    return int(walked.sum())


def time_scrubs(name, scrubs):
    """scrub over a list of (stored lanes, mask lanes, vectors), held
    against the twin (words, residual masks and counts exact, energy
    equal), then timed (16 bytes per lane). ``mask_bits_per_lane``: the
    set mask bits, the draws the bound counts; ``walked_planes_per_lane``:
    the draws the kernel makes (``walked_planes``), both over the lanes."""
    from repro_torch.kernels.scrub import ref as SR
    worst, flips, lanes, walked = 0, 0, 0, 0
    for su, mu, vec in scrubs:
        d, f = check_scrub(su, mu, 1, vec)
        worst, flips = max(worst, d), flips + f
        lanes, walked = lanes + su.numel(), walked + walked_planes(su, mu)
    return {"shape": name, "max_abs_err": worst, "energy_equals_twin": True,
            "mask_bits_per_lane": flips / lanes,
            "walked_planes_per_lane": walked / lanes,
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
    import torch
    from repro_torch import tree as T
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    from repro_torch.memory import leaf_vectors
    vecs = eng.vectors_for_floor(Priority.LOW)
    news = admission_rows(eng, 11)
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


def scrub_entry(launches, worst_abs, sch, device):
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
        "energy_equals_twin": True,
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
    t_ops = flops / hw().PEAK_FLOPS_BF16 * 1e3
    t_bytes = n_bytes / hw().HBM_BW * 1e3
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
    terms = {"bytes": n_bytes / hw().HBM_BW * 1e3,
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


#: the paper's results (the reference runner's sizes without --fast: Fig.
#: 2 at 128 trajectories a current, Fig. 15 at 1000 corners plus the Fig.
#: 16 sweep at 4 sigmas x 250), and monte_carlo_wer at the paper's
#: n = 1000 at 300 uA (the knee of Fig. 2's curve)
PAPER_MC_WER_N = 1000
PAPER_MC_WER_UA = 300
#: the card against the CPU (same host draws): Fig. 15's summaries rtol
#: 1e-6 (the corners are the same float32 and float64 IEEE operations on
#: both, so they should be equal); Fig. 12's energies rtol 1e-5 (flips and
#: errors exact); table1, fig14 and fig6 equal (host arithmetic; so is
#: ecc.compare, which has no device path and is held against the
#: reference by the CPU tests)
PAPER_SUMMARY_RTOL = 1e-6
PAPER_ENERGY_RTOL = 1e-5


def paper_decisions_bound(n: int) -> int:
    """Switching decisions a Monte-Carlo WER of n trajectories may differ
    in between the card and the CPU: CUDA's float32 sin and cos are not
    the CPU's, so a trajectory ending within their last bits of pi/2 may
    decide the other way (measured: none of 32-128 against XLA's)."""
    return max(2, n // 200)


def paper_rel_diff(a, b, path: str = "") -> dict:
    """{path: relative difference} over the numeric leaves of two equal-
    shaped results (booleans and strings must be equal)."""
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        out = {}
        for k in a:
            out.update(paper_rel_diff(a[k], b[k], f"{path}.{k}"))
        return out
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        out = {}
        for i, (x, y) in enumerate(zip(a, b)):
            out.update(paper_rel_diff(x, y, f"{path}[{i}]"))
        return out
    if isinstance(a, (bool, str)) or a is None:
        assert a == b, (path, a, b)
        return {}
    return {path: abs(a - b) / max(abs(b), 1e-300)}


def llgs_launches(noise, i_write):
    """The s-LLGS loop on the card under torch.profiler: (kernels per
    Euler step, device-busy ms per step)."""
    import torch
    from repro_torch.core import mtj
    from repro_torch.launch.profile import _dev_us
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        mtj.integrate_llgs(noise, mtj.DEFAULT_MTJ, i_write, trajectory=False)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))]
    steps = noise.shape[1]
    return (sum(e.count for e in rows) / steps,
            sum(_dev_us(e) for e in rows) / 1e3 / steps)


def phase_paper(device):
    """The paper's seven results through the port's benchmark runner on the
    card at the paper's sizes, then on the CPU in this process on the
    same host draws, held against each other; the s-LLGS loop's and the
    variation study's times, draws apart."""
    import torch
    from repro_torch import rng
    from repro_torch.benchmarks import run as bench
    from repro_torch.core import energy_model, mtj
    cpu = torch.device("cpu")
    reset_launches()
    card, seconds = {}, {}
    for name in bench.PAPER:
        t0 = time.perf_counter()
        card[name] = bench.BENCHES[name](False, device)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    launches = read_launches()
    host = {name: bench.BENCHES[name](False, cpu) for name in bench.PAPER}
    worst = {}
    for name in ("table1", "fig14_energy", "fig6_thermal"):
        if card[name] != host[name]:
            raise AssertionError(f"paper: {name} differs between the card "
                                 f"and the CPU")
        worst[name] = 0.0
    # Fig. 12: flips and errors exact, energies to PAPER_ENERGY_RTOL
    if card["fig12_waveform"]["checks"] != host["fig12_waveform"]["checks"] \
            or not all(card["fig12_waveform"]["checks"].values()):
        raise AssertionError(f"paper: fig12 checks "
                             f"{card['fig12_waveform']['checks']}")
    e_worst = 0.0
    for a, b in zip(card["fig12_waveform"]["events"],
                    host["fig12_waveform"]["events"]):
        if (a["bits_flipped"], a["bit_errors"]) != (b["bits_flipped"],
                                                    b["bit_errors"]):
            raise AssertionError(f"paper: fig12 {a['event']}: {a} != {b}")
        for k in ("energy_pj", "latency_ns"):
            e_worst = max(e_worst, abs(a[k] - b[k]) / max(abs(b[k]), 1e-30))
    if e_worst > PAPER_ENERGY_RTOL:
        raise AssertionError(f"paper: fig12 energies {e_worst:.3g} apart")
    worst["fig12_waveform"] = e_worst
    # Fig. 15/16: every summary and claim
    diffs = paper_rel_diff(card["fig15_variation"], host["fig15_variation"])
    worst["fig15_variation"] = max(diffs.values())
    if worst["fig15_variation"] > PAPER_SUMMARY_RTOL:
        k = max(diffs, key=diffs.get)
        raise AssertionError(f"paper: fig15 {k} {diffs[k]:.3g} apart")
    # Fig. 13: the MiBench mixes equal; the measured streams are each
    # device's own (its seeded reduced model), printed
    if card["fig13_access"]["mibench"] != host["fig13_access"]["mibench"]:
        raise AssertionError("paper: fig13's MiBench mixes differ")
    fig13 = {where: {k: out["fig13_access"][k] for k in (
        "kv_decode_stream", "optimizer_moment_stream")}
        for where, out in (("card", card), ("cpu", host))}
    # Fig. 2: Monte-Carlo WERs within the decisions bound, Eq. 1 equal
    n_fig2, fig2_differ = 128, 0
    for k, v in card["fig2_switching"].items():
        if not k.startswith("I="):
            continue
        h = host["fig2_switching"][k]
        if v["eq1_wer"] != h["eq1_wer"]:
            raise AssertionError(f"paper: fig2 {k} eq1 {v} != {h}")
        fig2_differ = max(fig2_differ,
                          round(abs(v["mc_wer"] - h["mc_wer"]) * n_fig2))
    if fig2_differ > paper_decisions_bound(n_fig2) or \
            card["fig2_switching"]["monotone"] != \
            host["fig2_switching"]["monotone"]:
        raise AssertionError(f"paper: fig2 {card['fig2_switching']} "
                             f"against {host['fig2_switching']}")
    worst["fig2_decisions_of_128"] = fig2_differ
    # the s-LLGS loop: host draws apart from the card's integration
    p = mtj.DEFAULT_MTJ
    key = rng.PRNGKey(0)
    n_steps = int(10e-9 / 5e-12)
    t0 = time.perf_counter()
    fig2_noise = mtj.llgs_noise(rng.split(key, n_fig2), n_steps)
    fig2_draw_s = time.perf_counter() - t0
    fig2_int_s = {}
    for i_ua in bench.fig2_switching.CURRENTS_UA:
        t0 = time.perf_counter()
        float(mtj.monte_carlo_wer(key, p, i_ua * 1e-6, n=n_fig2,
                                  device=device, noise=fig2_noise))
        fig2_int_s[f"I={i_ua}uA"] = time.perf_counter() - t0
    n = PAPER_MC_WER_N
    i_write = PAPER_MC_WER_UA * 1e-6
    t0 = time.perf_counter()
    noise = mtj.llgs_noise(rng.split(key, n), n_steps)
    mc_draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w_card = float(mtj.monte_carlo_wer(key, p, i_write, n=n, device=device,
                                       noise=noise))
    mc_card_s = time.perf_counter() - t0
    w_cpu = float(mtj.monte_carlo_wer(key, p, i_write, n=n, device=cpu,
                                      noise=noise))
    mc_differ = round(abs(w_card - w_cpu) * n)
    if mc_differ > paper_decisions_bound(n):
        raise AssertionError(f"paper: monte_carlo_wer n={n} card {w_card} "
                             f"against CPU {w_cpu}")
    worst[f"mc_wer_decisions_of_{n}"] = mc_differ
    noise_dev = torch.from_numpy(noise).to(device)
    step_ms = cuda_ms(lambda: mtj.integrate_llgs(
        noise_dev, p, i_write, trajectory=False), iters=3, warmup=1) / n_steps
    kernels_per_step, busy_ms_per_step = llgs_launches(noise_dev, i_write)
    # the variation study: host draws apart from the card's corners
    t0 = time.perf_counter()
    z = energy_model.variation_draws(key, 1000)
    var_draw_s = time.perf_counter() - t0
    z_dev = torch.from_numpy(z).to(device)
    var_ms = cuda_ms(lambda: energy_model.variation_samples(z_dev), iters=5,
                     warmup=1)
    claims = card["table1"]["claims"]
    emit({"phase": "paper", "card_s": seconds,
          "launches": launches,
          "fig2_host_draw_s": fig2_draw_s,
          "fig2_card_integration_s": fig2_int_s,
          "llgs_ms_per_step_n1000": step_ms,
          "llgs_kernels_per_step": kernels_per_step,
          "llgs_device_busy_ms_per_step": busy_ms_per_step,
          "monte_carlo_wer_n1000": {
              "i_ua": PAPER_MC_WER_UA, "wer_card": w_card, "wer_cpu": w_cpu,
              "host_draw_s": mc_draw_s, "card_s": mc_card_s},
          "fig15_host_draw_s_n1000": var_draw_s,
          "fig15_card_corners_ms_n1000": var_ms,
          "card_vs_cpu_worst": worst,
          "decisions_bound": {"fig2": paper_decisions_bound(n_fig2),
                              "mc_wer": paper_decisions_bound(n)},
          "claims": {k: claims[k] for k in (
              "energy_saving_vs_ranjan", "latency_saving_vs_quark",
              "area_overhead_vs_cast")},
          "fig2": {k: v for k, v in card["fig2_switching"].items()
                   if k != "us_per_call"},
          "fig15_claim_approx_spread_lower":
              card["fig15_variation"]["fig15_claim_approx_spread_lower"],
          "fig15_energy_mean_pj": {
              "full": card["fig15_variation"]["fig15_full_write_energy"][
                  "mean"],
              "approx": card["fig15_variation"][
                  "fig15_approx_write_energy"]["mean"]},
          "fig14_mean_saving_vs_basic":
              card["fig14_energy"]["mean_saving_vs_basic"],
          "fig13_mibench_equal": True, "fig13_measured": fig13})
    return launches


#: the serving benchmarks at the reference runner's sizes without --fast
#: (serving_energy's recurrentgemma-2b arm, the one that drives
#: local_attention, runs only there)
SERVING_BENCH_FAST = False
#: the examples the phase runs, with their arguments besides --device
SERVING_EXAMPLES = {"image_store_psnr": [], "serve_approx_kv": []}
def serving_energy_rtol(arch: str = "qwen2.5-3b") -> float:
    """The relative difference float32 summation allows between
    serving_energy's fused write (the kernel, per leaf, at most 32 planes
    a lane: ``energy_rtol``) summed over the cache's leaves in float32,
    and the eager oracle's float64 per-plane sums rounded once a leaf:
    the kernel's bound at the largest leaf plus one rounding per leaf and
    one for the oracle."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    # serving_energy's cache: 2 prompts, max_seq 32
    leaves = list(_leaves(get_model(get_config(arch).reduced()).init_cache(
        2, 32, "meta")))
    lanes = max(x.numel() * x.element_size() // 4 for x in leaves)
    return energy_rtol(lanes, 32) + (len(leaves) + 1) * 2.0 ** -24


def phase_serving_bench(device):
    """The serving stack's seven benchmarks through
    repro_torch.benchmarks.run.BENCHES on the card (every module asserts
    its own claims), then both examples with --device cuda; one line per
    module with its seconds, bench_metrics and launches per kernel.
    Holds kernel_bench's cuda write against lanes_ref at its size,
    serving_energy's lockstep bit-exactness, its fused and eager flips
    equal and their energies within ``serving_energy_rtol``; each of the
    four kernels must launch in the phase."""
    import importlib
    import io
    import torch
    from repro_torch import memory
    from repro_torch.benchmarks import kernel_bench
    from repro_torch.benchmarks import run as bench
    from repro_torch.core.priority import Priority
    from repro_torch.kernels.extent_write import ops
    from repro_torch.memory import leaf_vectors
    reset_launches()
    outs, seconds = {}, {}
    for name in bench.SERVING:
        before = read_launches()
        timed = {}
        t0 = time.perf_counter()
        if name in bench.MEASURES:
            # wall-clock claims are printed, not held: these arms are
            # timed on the host or on short graph replays, and run to run
            # the host's speed varies by tens of percent and the card's
            # by a few, as much as the differences the claims compare
            # (PERF.md); the runner asserts them. Every other claim holds
            mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
            outs[name] = bench.MEASURES[name](SERVING_BENCH_FAST, device)
            claims = outs[name]["claims"]
            held = {k: v for k, v in claims.items()
                    if k not in mod.TIMED_CLAIMS}
            if not all(held.values()):
                raise AssertionError(f"serving_bench: {name} {held}")
            timed = {"timed_claims": {k: claims[k]
                                      for k in mod.TIMED_CLAIMS},
                     **{k: outs[name][k] for k in (
                         "sec_off", "sec_on", "burst_timing",
                         "tokens_per_s", "tokens_per_s_eager")
                        if k in outs[name]}}
        else:
            outs[name] = bench.BENCHES[name](SERVING_BENCH_FAST, device)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        metrics = bench.metrics_for(name, outs[name])
        if metrics.get("_metrics_fallback"):
            raise AssertionError(f"serving_bench: {name}.bench_metrics "
                                 f"failed")
        after = read_launches()
        emit({"phase": "serving_bench", "module": name,
              "seconds": seconds[name], "metrics": metrics, **timed,
              "launches": {k: after[k] - before[k] for k in after}})
    for name, argv in SERVING_EXAMPLES.items():
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        before = read_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(["--device", device.type, *argv])
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        after = read_launches()
        emit({"phase": "serving_bench", "example": name,
              "seconds": seconds[name],
              "stdout": buf.getvalue().splitlines(),
              "launches": {k: after[k] - before[k] for k in after}})
    launches = read_launches()
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"serving_bench: {missing} never launched")
    # kernel_bench's write: the kernel against its twin on the card
    kb = outs["kernel_bench"]
    old, new, key = kernel_bench.inputs(
        kb["tensor_mib"] * 1024 * 1024 // 2, device)
    with uncounted("extent_write"):
        s_k, st_k = memory.write(key, old, new, level=Priority.LOW,
                                 backend="cuda")
    s_r, st_r = memory.write(key, old, new, level=Priority.LOW,
                             backend="lanes_ref")
    h_k, h_r = st_k.host_dict(), st_r.host_dict()
    words_equal = bool(torch.equal(s_k.view(torch.int16),
                                   s_r.view(torch.int16)))
    kb_rel = abs(h_k["energy_pj"] - h_r["energy_pj"]) / h_r["energy_pj"]
    if not words_equal or kb_rel > RTOL_ENERGY or any(
            h_k[k] != h_r[k] for k in ("flips01", "flips10", "bit_errors")) \
            or h_k["bit_errors"] != kb["errors"]:
        raise AssertionError(f"serving_bench: kernel_bench's cuda write "
                             f"against lanes_ref: {h_k} / {h_r}")
    # serving_energy: lockstep bit-exact; fused and eager on the same
    # pairs flip the same bits, their energies within the summation bound
    se = outs["serving_energy"]
    fe = se["fused_vs_eager"]
    se_rtol = serving_energy_rtol()
    if not se["lockstep_parity"]["bit_exact"] \
            or fe["flips_fused"] != fe["flips_eager"] \
            or fe["energy_rel_err"] > se_rtol:
        raise AssertionError(f"serving_bench: serving_energy {fe} "
                             f"lockstep {se['lockstep_parity']}")
    # the kernel at kernel_bench's shape and data: device time per launch
    # against its bound (the entry's ``at.kernel_bench``)
    lv = leaf_vectors(torch.bfloat16, Priority.LOW, device)
    kb_timing = time_writes(
        f"kernel_bench ({old.numel()},) bfloat16, {kb['tensor_mib']} MiB",
        [(ops.to_lanes(old), ops.to_lanes(new),
          (lv.thr01, lv.thr10, lv.le01, lv.le10))])
    emit({"phase": "serving_bench", "seconds": seconds,
          "phase_s": sum(seconds.values()), "fast": SERVING_BENCH_FAST,
          "launches": launches, "kernel_bench_kernel": kb_timing,
          "kernel_bench_vs_twin": {
              "lanes": ops.to_lanes(old).numel(), "words_equal": True,
              "flips": h_k["bits_written"], "errors": h_k["bit_errors"],
              "energy_rel_err": kb_rel, "rtol": RTOL_ENERGY},
          "fused_vs_eager": {
              "flips": fe["flips_fused"], "errors_fused": fe["errors_fused"],
              "errors_eager": fe["errors_eager"],
              "energy_rel_err": fe["energy_rel_err"], "rtol": se_rtol,
              "speedup_x": fe["speedup_x"]},
          "lockstep_bit_exact": True, "ok": True})
    return launches, kb_timing


#: where the checkpoint phases write (under build/, which git ignores);
#: removed when they end
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
#: the restore integrity pass of both checkpoint phases: 1e5 s at 400 K
CKPT_INTEGRITY = {"ambient_k": 400.0, "dwell_s": 1e5, "scrub": True}
#: qwen2.5-3b's training state at full width, its depth cut to 4 of 36
#: layers: 619.5 M parameters, 1.24 GB of bf16 weights and 4.96 GB of
#: float32 moments a save (36 layers would copy 30.9 GB to the host and
#: the disk at every save)
CKPT_LAYERS = 4


def same_checkpoint_files(a: Path, b: Path) -> bool:
    """Two step directories hold the same files, byte for byte."""
    import filecmp
    names = sorted(p.name for p in a.iterdir())
    return names == sorted(p.name for p in b.iterdir()) and all(
        filecmp.cmp(a / n, b / n, shallow=False) for n in names)


def int_bits(x):
    """A tensor's integer view (floats by their bits), for equality."""
    from repro_torch.core.priority import int_type
    return x.view(int_type(x.dtype)) if x.dtype.is_floating_point else x


def trees_bit_equal(a, b) -> bool:
    import torch
    from repro_torch import tree as T
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(int_bits(x).cpu(),
                                           int_bits(y).cpu())
        for x, y in zip(la, lb))


def same_reports(a: dict, b: dict, what: str) -> float:
    """Reports equal in every count, energies within RTOL_ENERGY: the
    largest energy difference found."""
    worst = 0.0
    for k, v in b.items():
        if k.endswith("energy_pj"):
            rel = abs(a[k] - v) / max(abs(v), 1e-30)
            worst = max(worst, rel)
            if rel > RTOL_ENERGY:
                raise AssertionError(f"{what}: {k} {a[k]} against {v}")
        elif isinstance(v, int) and a[k] != v:
            raise AssertionError(f"{what}: {k} {a[k]} against {v}")
    return worst


def phase_checkpoint_reduced(device):
    """The reference test's small state (``w`` (32, 8), ``opt.m`` at MID,
    ``opt.v`` at LOW) saved on the card through cuda, lanes_ref and
    oracle and on the CPU through lanes_ref and oracle: cuda's files
    byte-identical to lanes_ref's, the card's lanes_ref and oracle files
    to the CPU's; the 400 K integrity restore through cuda on the card
    equal to lanes_ref's on the CPU; a MemoryRegion written, aged and
    scrubbed through cuda equal to one through lanes_ref; then the
    quickstart with --device cuda. Returns the phase's launches."""
    import io
    import shutil
    import numpy as np
    import torch
    from repro_torch import memory, rng
    from repro_torch.core.priority import Priority
    from repro_torch.examples import quickstart
    from repro_torch.reliability import RestoreIntegrity
    from repro_torch.train.checkpoint import Checkpointer

    def policy(path, leaf):
        s = str(path)
        if "'v'" in s:
            return Priority.LOW
        if "'m'" in s:
            return Priority.MID
        return Priority.EXACT

    r = np.random.default_rng(0)
    host = {k: r.standard_normal((32, 8)).astype(np.float32)
            for k in ("w", "m", "v")}

    def state(dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        return {"w": t["w"], "opt": {"m": t["m"], "v": t["v"]}}

    cpu = torch.device("cpu")
    root = CKPT_DIR / "reduced"
    shutil.rmtree(root, ignore_errors=True)
    reset_launches()
    cks = {}
    for be, dev, where in (("cuda", device, "card"),
                           ("lanes_ref", device, "card"),
                           ("oracle", device, "card"),
                           ("lanes_ref", cpu, "cpu"), ("oracle", cpu, "cpu")):
        name = f"{be}_{where}"
        cks[name] = Checkpointer(str(root / name), extent_policy=policy,
                                 extent_backend=be, device=dev)
        cks[name].save(3, state(dev))
        cks[name].wait()
    step = "step_000000003"
    for a, b in (("cuda_card", "lanes_ref_card"),
                 ("lanes_ref_card", "lanes_ref_cpu"),
                 ("oracle_card", "oracle_cpu")):
        if not same_checkpoint_files(root / a / step, root / b / step):
            raise AssertionError(f"checkpoint_reduced: {a}'s files differ "
                                 f"from {b}'s")
    integ = RestoreIntegrity(**CKPT_INTEGRITY)
    got_k, _ = cks["cuda_card"].restore(state(cpu), integrity=integ)
    got_c, _ = cks["lanes_ref_cpu"].restore(state(cpu), integrity=integ)
    rk = cks["cuda_card"].last_restore_report
    rc = cks["lanes_ref_cpu"].last_restore_report
    restore_rel = same_reports(rk, rc, "checkpoint_reduced restore")
    if not trees_bit_equal(got_k, got_c) or rk["retention_flips"] == 0:
        raise AssertionError("checkpoint_reduced: the card's integrity "
                             "restore differs from the CPU's")

    def region(backend):
        golden = {"v": torch.from_numpy(rng.normal(
            rng.PRNGKey(3), (64, 64))).to(torch.bfloat16).to(device)}
        reg = memory.MemoryRegion.create(
            {"v": torch.zeros_like(golden["v"])}, level=Priority.LOW,
            backend=backend, ambient_k=400.0, retention_scale=1e4)
        reg = reg.write(rng.PRNGKey(4), golden).age(rng.PRNGKey(5), steps=4)
        reg = reg.scrub(rng.PRNGKey(6))
        return reg.report(), reg.read()

    reg_k, data_k = region("cuda")
    n1 = read_launches()
    reg_r, data_r = region("lanes_ref")
    if read_launches() != n1:
        raise AssertionError("checkpoint_reduced: the twin region launched")
    region_rel = same_reports(reg_k, reg_r, "checkpoint_reduced region")
    if not trees_bit_equal(data_k, data_r) or reg_k["backend"] != "cuda" \
            or reg_k["scrub_energy_pj"] != reg_r["scrub_energy_pj"]:
        raise AssertionError("checkpoint_reduced: region data or scrub "
                             "energy differ")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        quickstart.main(["--device", "cuda", "--wear-policy", "rotate"])
    torch.cuda.synchronize()
    quick_s = time.perf_counter() - t0
    out = buf.getvalue()
    sweep = out.split("== 3.")[1].split("== 4.")[0]
    if "== 8." not in out or "  cuda" not in sweep:
        raise AssertionError("checkpoint_reduced: quickstart --device cuda")
    launches = read_launches()
    if not (launches["extent_write"] and launches["scrub"]):
        raise AssertionError(f"checkpoint_reduced: {launches}")
    shutil.rmtree(root)
    emit({"phase": "checkpoint_reduced",
          "saves": {k: {f: ck.last_save_report[f] for f in (
              "energy_pj", "bit_errors", "bytes", "skipped_leaves")}
              for k, ck in cks.items()},
          "files_equal": ["cuda = lanes_ref (card)",
                          "lanes_ref card = cpu", "oracle card = cpu"],
          "integrity_restore": {k: rk[k] for k in (
              "leaves_checked", "retention_flips", "scrub_energy_pj",
              "residual_decayed_bits")},
          "integrity_energy_rel_err": restore_rel,
          "region": {k: reg_k[k] for k in (
              "energy_pj", "bits_written", "bit_errors", "scrub_energy_pj",
              "retention_flips", "residual_decayed_bits")},
          "region_energy_rel_err": region_rel,
          "quickstart_s": quick_s, "quickstart_sweep": sweep.splitlines(),
          "launches": launches, "ok": True})
    return launches


def phase_checkpoint(device):
    """qwen2.5-3b's training state at full width (d_model 2048, d_ff
    11008, vocab 151936, 16 heads over 2 KV heads of 128, QKV bias), its
    depth cut to CKPT_LAYERS: the launcher's seeded bf16 weights, AdamW
    state from ``optimizer.init`` and one ``update`` on gradients from a
    seeded generator. Saved with checkpoint_policy (m at MID, v at LOW,
    weights and step EXACT) through cuda, asynchronously, keep_last 1:
    save 1; save 2 of the same state (every approximate leaf skipped, no
    launch, no energy); save 3 after a second update. Then a 400 K
    integrity restore (one scrub launch per checked leaf, weights
    bit-identical) and a plain restore (every leaf what save 3 stored).
    Held against the twins on the card: one stacked MLP moment's write
    (words, flips, errors; energy within ``energy_rtol``) and its
    integrity scrub (words, residual, counts); compress_grads over the
    second update's gradients through the cuda wire against lanes_ref.
    At the embedding's v moment (311.2 M lanes, LOW) the write is timed
    over zeros, and the restore's decay and scrub of what it stored.
    Returns (the path's launches, the write's and the scrub's timings)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch import memory, rng
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.priority import Priority, checkpoint_policy, keystr
    from repro_torch.kernels.extent_write import ops
    from repro_torch.memory import leaf_vectors, rng_streams
    from repro_torch.models import get_model
    from repro_torch.reliability import RestoreIntegrity, decay_tensor
    from repro_torch.reliability import lifetime
    from repro_torch.train import compression, optimizer
    from repro_torch.train.checkpoint import Checkpointer
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              num_layers=CKPT_LAYERS)
    t0 = time.perf_counter()
    params = get_model(cfg).init(0, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(23)

    def grads():
        return T.tree_map(lambda p: torch.randn(
            p.shape, generator=gen, device=device) * 1e-3, params)

    acfg = optimizer.AdamWConfig()
    p1, o1, _ = optimizer.update(acfg, grads(), optimizer.init(params),
                                 params)
    state = {"params": p1, "opt": o1}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flat = [(keystr(p), x) for p, x in T.flatten(state)]

    def moment_leaves(st):
        """(leaf index, path, leaf) of the leaves saved approximately."""
        return [(i, keystr(p), x) for i, (p, x) in enumerate(T.flatten(st))
                if x.dtype == torch.float32
                and checkpoint_policy((keystr(p),), x) != Priority.EXACT]

    moments = moment_leaves(state)
    n_bytes = sum(x.numel() * x.element_size() for _, x in flat)
    root = CKPT_DIR / "full"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free_disk = shutil.disk_usage(root).free
    ck = Checkpointer(str(root), keep_last=1, async_save=True,
                      extent_policy=checkpoint_policy,
                      extent_backend="cuda", device=device)
    saves = []

    def save(step, st):
        before = read_launches()
        t = time.perf_counter()
        ck.save(step, st)
        ck.wait()
        rep = {**ck.last_save_report, "wall_s": time.perf_counter() - t}
        after = read_launches()
        rep["launches"] = {k: after[k] - before[k] for k in after}
        saves.append(rep)
        return rep

    reset_launches()
    s1 = save(1, state)
    s2 = save(2, state)
    g2 = grads()
    p2, o2, _ = optimizer.update(acfg, g2, o1, p1)
    state3 = {"params": p2, "opt": o2}
    s3 = save(3, state3)
    for rep, n in ((s1, len(moments)), (s2, 0), (s3, len(moments))):
        if rep["launches"]["extent_write"] != n or rep["launches"]["scrub"]:
            raise AssertionError(f"checkpoint: save {rep['step']} launched "
                                 f"{rep['launches']}, not {n} writes")
    if s2["skipped_leaves"] != len(moments) or s2["energy_pj"] != 0.0 \
            or s1["energy_pj"] <= 0.0 or s1["skipped_leaves"]:
        raise AssertionError(f"checkpoint: delta elimination {s1} {s2}")
    like = T.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                            device="meta"), state3)
    before = read_launches()
    t = time.perf_counter()
    got_i, _ = ck.restore(like, integrity=RestoreIntegrity(**CKPT_INTEGRITY))
    torch.cuda.synchronize()
    integ_s = time.perf_counter() - t
    ri = ck.last_restore_report
    integ_launches = {k: v - before[k] for k, v in read_launches().items()}
    if ri["leaves_checked"] != len(moments) or ri["retention_flips"] <= 0 \
            or integ_launches["scrub"] != len(moments) \
            or integ_launches["extent_write"] \
            or not trees_bit_equal(got_i["params"], state3["params"]):
        raise AssertionError(f"checkpoint: integrity restore {ri} "
                             f"{integ_launches}")
    t = time.perf_counter()
    got_p, _ = ck.restore(like)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    rp = ck.last_restore_report
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # every leaf is what save 3 stored: the weights and the step as they
    # were, each moment the write of its own key (recomputed, uncounted)
    if not (trees_bit_equal(got_p["params"], p2)
            and torch.equal(got_p["opt"].step, o2.step)):
        raise AssertionError("checkpoint: plain restore of the exact leaves")
    key3 = rng.PRNGKey(ck.extent_seed + 3)
    got_flat = T.leaves(got_p)
    moments = moment_leaves(state3)
    with uncounted("extent_write"):
        for i, path, x in moments:
            s, _ = memory.write(rng.fold_in(key3, i), torch.zeros_like(x),
                                x, level=checkpoint_policy((path,), x),
                                backend="cuda")
            if not torch.equal(int_bits(s), int_bits(got_flat[i])):
                raise AssertionError(f"checkpoint: {path} restored is not "
                                     f"what save 3 stored")
    del got_flat
    # one stacked MLP moment (90.2 M lanes): the kernel against the twin
    i, path, x = next(m for m in moments if "['mlp']['wo']" in m[1]
                      and ".v" in m[1])
    level = checkpoint_policy((path,), x)
    with uncounted("extent_write"):
        s_k, st_k = memory.write(rng.fold_in(key3, i), torch.zeros_like(x),
                                 x, level=level, backend="cuda")
    s_r, st_r = memory.write(rng.fold_in(key3, i), torch.zeros_like(x), x,
                             level=level, backend="lanes_ref")
    h_k, h_r = st_k.host_dict(), st_r.host_dict()
    lanes = ops.to_lanes(x)
    rtol = energy_rtol(lanes.numel(), warp_flips(
        torch.zeros_like(lanes), lanes)[1])
    w_rel = abs(h_k["energy_pj"] - h_r["energy_pj"]) / h_r["energy_pj"]
    if not torch.equal(int_bits(s_k), int_bits(s_r)) or w_rel > rtol or any(
            h_k[k] != h_r[k] for k in ("flips01", "flips10", "bit_errors")):
        raise AssertionError(f"checkpoint: {path} write {h_k} / {h_r}")
    del s_r
    # its integrity scrub, kernel against twin (and the restore's leaf)
    rkey = rng.fold_in(rng.PRNGKey(ck.extent_seed),
                       rng_streams.CHECKPOINT_RESTORE_OFFSET + 3)
    dec, mask, _ = decay_tensor(rng.fold_in(rkey, i), s_k, level=level,
                                ambient_k=CKPT_INTEGRITY["ambient_k"],
                                dwell_s=CKPT_INTEGRITY["dwell_s"])
    lv = leaf_vectors(x.dtype, level, device)
    skey = rng.fold_in(rkey, rng_streams.RESTORE_SCRUB_OFFSET + i)
    with uncounted("scrub"):
        c_k, res_k, sst_k = memory.get_backend("cuda").leaf_scrub(
            skey, dec, mask, lv)
    c_r, res_r, sst_r = memory.get_backend("lanes_ref").leaf_scrub(
        skey, dec, mask, lv)
    sh_k, sh_r = sst_k.host_dict(), sst_r.host_dict()
    if not (torch.equal(int_bits(c_k), int_bits(c_r))
            and torch.equal(res_k, res_r)
            and torch.equal(int_bits(c_k), int_bits(T.leaves(got_i)[i]))) \
            or any(sh_k[k] != sh_r[k] for k in (
                "flips01", "flips10", "bit_errors", "energy_pj")):
        raise AssertionError(f"checkpoint: {path} scrub {sh_k} / {sh_r}")
    scrub_check = {"leaf": path, "lanes": lanes.numel(),
                   "rewritten": sh_k["bits_written"],
                   "errors": sh_k["bit_errors"],
                   "energy_pj": sh_k["energy_pj"],
                   "energy_equals_twin": True}
    write_check = {"leaf": path, "lanes": lanes.numel(),
                   "flips": h_k["bits_written"], "errors": h_k["bit_errors"],
                   "energy_rel_err": w_rel, "energy_rtol": rtol}
    del got_i, got_p, s_k, c_k, c_r, res_k, res_r, dec, mask, state, p1, o1
    gc.collect()
    torch.cuda.empty_cache()
    # the int8 gradient wire over the second update's gradients
    wire = {}
    outs = {}
    for be in ("cuda", "lanes_ref"):
        before = read_launches()
        t = time.perf_counter()
        out, ef, st = compression.compress_grads(
            g2, compression.init_state(g2), compression.CompressionConfig(
                wire_backend=be), with_stats=True)
        torch.cuda.synchronize()
        wire[be] = {"s": time.perf_counter() - t, **st.host_dict(),
                    "launches": {k: v - before[k]
                                 for k, v in read_launches().items()}}
        outs[be] = (out, ef)
    wk, wr = wire["cuda"], wire["lanes_ref"]
    if not (trees_bit_equal(*(o[0] for o in outs.values()))
            and trees_bit_equal(*(o[1] for o in outs.values()))) or any(
            wk[k] != wr[k] for k in ("flips01", "flips10", "bit_errors",
                                     "bits_total")) \
            or wk["launches"]["extent_write"] != len(T.leaves(g2)) \
            or wr["launches"]["extent_write"]:
        raise AssertionError(f"checkpoint: the cuda wire {wk} against "
                             f"lanes_ref {wr}")
    launches = {k: launches[k] + wk["launches"][k] for k in launches}
    del outs
    # the kernels at the embedding's v moment (311.2 M lanes, LOW): the
    # write over zeros, then the restore's decay and scrub of what it
    # stored
    i, path, emb = next(m for m in moments
                        if m[1] == "['opt'].v['embed']['embedding']")
    lv = leaf_vectors(emb.dtype, Priority.LOW, device)
    vec = (lv.thr01, lv.thr10, lv.le01, lv.le10)
    with uncounted("extent_write"):
        stored, _ = memory.write(rng.fold_in(key3, i), torch.zeros_like(emb),
                                 emb, level=Priority.LOW, backend="cuda")
    e_lanes = ops.to_lanes(emb)
    del p2, o2, state3, g2, emb
    gc.collect()
    torch.cuda.empty_cache()
    name = f"checkpoint embedding v moment {tuple(stored.shape)} float32"
    timing = time_writes(f"{name} over zeros, LOW",
                         [(torch.zeros_like(e_lanes), e_lanes, vec)],
                         derived_rtol=True)
    del e_lanes

    def decay():
        return decay_tensor(rng.fold_in(rkey, i), stored, level=Priority.LOW,
                            ambient_k=CKPT_INTEGRITY["ambient_k"],
                            dwell_s=CKPT_INTEGRITY["dwell_s"])

    decay_ms = cuda_ms(decay, 2, warmup=1)
    dec, mask, _ = decay()
    scrub_timing = time_scrubs(f"{name}, its 400 K restore decay mask",
                               [(ops.to_lanes(dec), ops.to_lanes(mask), vec)])
    del stored, dec, mask
    lifetime._elem_hash_base.cache_clear()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    approx_lanes = sum(x.numel() for _, _, x in moments)
    emit({"phase": "checkpoint", "arch": cfg.name,
          "layers": cfg.num_layers, "reduced": {
              "num_layers": f"{CKPT_LAYERS} of "
                            f"{get_config('qwen2.5-3b').num_layers}"},
          "params": sum(x.numel() for x in T.leaves(params)),
          "state_bytes": n_bytes, "leaves": len(flat),
          "moment_leaves": len(moments), "approx_lanes": approx_lanes,
          "init_s": init_s, "free_disk_bytes": free_disk,
          "saves": [{k: rep[k] for k in (
              "step", "wall_s", "seconds", "stage_s", "bytes", "energy_pj",
              "bit_errors", "skipped_leaves", "launches")} for rep in saves],
          "integrity_restore": {**{k: ri[k] for k in (
              "leaves_checked", "retention_flips", "scrub_energy_pj",
              "residual_decayed_bits", "stage_s")}, "wall_s": integ_s,
              "decay_ms_per_leaf": ri["stage_s"]["decay"] * 1e3
              / ri["leaves_checked"], "launches": integ_launches},
          "plain_restore": {"wall_s": plain_s, "stage_s": rp["stage_s"],
                            "bit_identical_to_save_3": True},
          "write_vs_twin": write_check, "scrub_vs_twin": scrub_check,
          "wire": {be: {k: w[k] for k in (
              "s", "bits_total", "bits_written", "bit_errors", "energy_pj",
              "launches")} for be, w in wire.items()},
          "wire_codes_equal": True, "peak_mem_bytes": peak,
          "launches": launches, "embed_moment_write": timing,
          "embed_moment_decay_ms": decay_ms,
          "embed_moment_scrub": scrub_timing, "ok": True})
    return launches, timing, scrub_timing


#: every family's reduced config of the train_reduced phase
TRAIN_FAMILIES = ("qwen2.5-3b", "dbrx-132b", "recurrentgemma-2b",
                  "mamba2-2.7b", "llava-next-mistral-7b", "whisper-large-v3",
                  "gemma2-9b", "mistral-nemo-12b", "h2o-danube-1.8b")
#: card against CPU after one train step of a reduced config, from the
#: same parameters and batch: the loss and the gradient norm relative, at
#: 3x the largest card-versus-CPU difference measured over the six
#: families (whisper-large-v3's 7.19e-6 and 1.49e-2; float32, TF32 off:
#: the random reduced stacks amplify reduction-order differences, as on
#: the CPU against the reference); the parameters are held at the derived
#: bound ``adamw_step_bound``
TRAIN_LOSS_RTOL = 2.2e-5
TRAIN_GNORM_RTOL = 4.5e-2
#: the accumulation check's loss bound on the card: the reference test's
#: float32 rtol (measured 6.4e-8)
ACCUM_RTOL = 2e-5
#: the full-width run: qwen2.5-3b at the train_4k cell's length, batch 2
TRAIN_SEQ, TRAIN_BATCH = 4096, 2
TRAIN_WARMUP, TRAIN_TIMED = 2, 4
#: bfloat16 model, 2 microbatches against the whole batch: the losses
#: at the same parameters, relative, at the reference test's float32
#: rtol (the loss is a float32 sum over rows computed alike; measured
#: 6.8e-8)
TRAIN_ACCUM_RTOL = 2e-5


def train_batch(cfg, seed: int):
    """A seeded CPU batch of ``test_models_smoke``'s shapes (B 2, S 32;
    whisper 16 decoder tokens over 32 frames; llava's labels over its
    image positions too), the next-token labels IGNOREd at the end."""
    import torch
    g = torch.Generator().manual_seed(seed)
    B, S = 2, 32
    V = cfg.vocab_size
    if cfg.family == "audio":
        return {"frames": torch.randn(B, S, cfg.d_model, generator=g),
                "tokens": torch.randint(0, V, (B, 16), generator=g),
                "labels": torch.randint(0, V, (B, 16), generator=g)}
    if cfg.family == "vlm":
        return {"image_embeds": torch.randn(B, cfg.num_image_tokens,
                                            cfg.vision_dim, generator=g),
                "tokens": torch.randint(0, V, (B, S - cfg.num_image_tokens),
                                        generator=g),
                "labels": torch.randint(0, V, (B, S), generator=g)}
    toks = torch.randint(0, V, (B, S), generator=g)
    return {"tokens": toks,
            "labels": torch.cat([toks[:, 1:], torch.full((B, 1), -1)], 1)}


def adamw_step_bound(lr: float, params) -> float:
    """The most two first AdamW steps from the same parameters can leave
    them apart, whatever their gradients: each moves an element by lr *
    g / (|g| + eps) plus the same decay term, so by less than lr either
    way; plus one float32 rounding of each result."""
    from repro_torch import tree as T
    top = max(float(x.abs().max()) for x in T.leaves(params))
    return 2.0 * lr + 2.0 * top * 2.0 ** -23


def phase_train_reduced(device):
    """One make_train_step step of every family's reduced config on the
    card and on the CPU from the same parameters and batch (TF32 off):
    loss, gradient norm and the updated parameters held against each
    other; a make_batch at qwen2.5-3b's full vocabulary (151936, shape
    (2, 64): 19.4 M draws) drawn on the card equal to the host's token
    for token; 4 microbatches against the whole batch on the card."""
    import torch
    from repro_torch import rng
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt
    from repro_torch.train.accumulate import AccumConfig, make_accum_train_step
    from repro_torch.train.train_step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    reset_launches()
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    fams = {}
    for arch in TRAIN_FAMILIES:
        api = get_model(get_config(arch).reduced())
        step = make_train_step(api, ocfg)
        p_cpu = api.init(0, cpu)
        b_cpu = train_batch(api.cfg, 1)
        out = {}
        for where, dev in (("card", device), ("cpu", cpu)):
            p = T.tree_map(lambda x: x.to(dev), p_cpu)
            b = {k: v.to(dev) for k, v in b_cpu.items()}
            t0 = time.perf_counter()
            p2, s2, m = step(p, opt.init(p), b)
            loss = float(m["loss"])
            out[where] = (T.tree_map(lambda x: x.cpu(), p2), m, loss,
                          time.perf_counter() - t0)
        pk, mk, lk, sk = out["card"]
        pc, mc, lc, sc = out["cpu"]
        lr = float(mc["lr"])
        d_param = max(float((a - b).abs().max())
                      for a, b in zip(T.leaves(pk), T.leaves(pc)))
        moved_lr = sum(int(((a - b).abs() > lr).sum())
                       for a, b in zip(T.leaves(pk), T.leaves(pc)))
        res = {"loss_card": lk, "loss_cpu": lc,
               "loss_rel": abs(lk - lc) / abs(lc),
               "grad_norm_card": float(mk["grad_norm"]),
               "grad_norm_cpu": float(mc["grad_norm"]),
               "grad_norm_rel": abs(float(mk["grad_norm"])
                                    - float(mc["grad_norm"]))
               / float(mc["grad_norm"]),
               "param_max_abs_diff": d_param,
               "param_bound": adamw_step_bound(lr, p_cpu),
               "elements_apart_by_more_than_lr": moved_lr,
               # as a fraction of each leaf's largest value
               "param_max_rel_diff": max(
                   float((a - b).abs().max() / b.abs().max().clamp_min(
                       1e-30)) for a, b in zip(T.leaves(pk), T.leaves(pc))),
               "card_s": sk, "cpu_s": sc,
               "metrics": sorted(mk)}
        if not (math.isfinite(lk) and res["loss_rel"] <= TRAIN_LOSS_RTOL
                and res["grad_norm_rel"] <= TRAIN_GNORM_RTOL
                and d_param <= res["param_bound"]
                and sorted(mk) == sorted(mc)):
            raise AssertionError(f"train_reduced: {arch} card against CPU "
                                 f"{res}")
        fams[arch] = res
    # the data pipeline at qwen2.5-3b's vocabulary, card against host
    dcfg = data_mod.DataConfig(get_config("qwen2.5-3b").vocab_size, 64, 2)
    t0 = time.perf_counter()
    card = data_mod.make_batch(dcfg, 0, device)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = data_mod.make_batch(dcfg, 0, cpu)
    host_s = time.perf_counter() - t0
    if not all(torch.equal(card[k].cpu(), host[k]) for k in card):
        raise AssertionError("train_reduced: the card's make_batch differs "
                             "from the host's")
    k1 = rng.split(rng.fold_in(rng.PRNGKey(dcfg.seed), 0))[0]
    logits = rng.xla_log(data_mod._zipf_probs(dcfg))
    _, err_card = rng.categorical_xla_t(k1, logits, (2, 64), device,
                                        with_err=True)
    _, err_host = rng.categorical_xla_t(k1, logits, (2, 64), cpu,
                                        with_err=True)
    if max(err_card, err_host) > rng.CATEGORICAL_MARGIN / 2:
        raise AssertionError(f"train_reduced: device gumbels {err_card} / "
                             f"{err_host} from XLA's")
    # accumulation on the card: 4 microbatches against the whole batch
    api = get_model(get_config("qwen2.5-3b").reduced())
    params = api.init(0, device)
    acfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = data_mod.make_batch(data_mod.DataConfig(
        api.cfg.vocab_size, 16, 8, seed=3), 0, device)
    _, _, m1 = make_train_step(api, acfg)(params, opt.init(params), batch)
    _, _, _, m4 = make_accum_train_step(api, acfg, AccumConfig(
        num_microbatches=4))(params, opt.init(params), None, batch)
    acc_rel = abs(float(m1["loss"]) - float(m4["loss"])) / float(m1["loss"])
    if acc_rel > ACCUM_RTOL:
        raise AssertionError(f"train_reduced: accumulation {acc_rel}")
    launches = read_launches()
    emit({"phase": "train_reduced", "tf32": False, "families": fams,
          "bounds": {"loss_rtol": TRAIN_LOSS_RTOL,
                     "grad_norm_rtol": TRAIN_GNORM_RTOL,
                     "params": "adamw_step_bound: 2 lr + 2 float32 ulps"},
          "make_batch_qwen_vocab": {
              "vocab": dcfg.vocab_size, "shape": [2, 64],
              "draws": 2 * 64 * dcfg.vocab_size,
              "card_equals_host": True, "card_s": card_s, "host_s": host_s,
              "device_gumbel_max_err": {"card": err_card, "host": err_host},
              "margin": rng.CATEGORICAL_MARGIN},
          "accum_4_microbatches": {"loss_full": float(m1["loss"]),
                                   "loss_accum": float(m4["loss"]),
                                   "rel": acc_rel, "rtol": ACCUM_RTOL},
          "launches": launches, "ok": True})
    return launches


def phase_train(device):
    """qwen2.5-3b at published width and full depth (36 layers, bf16
    weights, float32 moments) training at the train_4k cell's length
    (4096) with batch 2 and full remat: TRAIN_WARMUP + TRAIN_TIMED steps
    of make_train_step (donated state), each step timed by CUDA events
    and its batch's draw apart; then, at the same parameters, the plain
    step's loss against a 2-microbatch make_accum_train_step step. At
    full depth the float32 sum of squares of the seeded init's gradients
    overflows, as the reference's ``global_norm`` would: grad_norm is inf
    and the clip scale 0, so a step does all of its work but moves the
    weights by their decay only (printed as ``grad_norm_finite``)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch import hw as H
    from repro_torch.models import get_model
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt
    from repro_torch.train.accumulate import AccumConfig, make_accum_train_step
    from repro_torch.train.train_step import loss_fn, make_train_step
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    cfg = get_config("qwen2.5-3b")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(0, device)
    state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in T.leaves(params))
    ocfg = opt.AdamWConfig(warmup_steps=2, total_steps=100)
    step = make_train_step(api, ocfg, remat=True, donate=True)
    dcfg = data_mod.DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    steps = []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = data_mod.make_batch(dcfg, i, device)
        torch.cuda.synchronize()
        data_ms = (time.perf_counter() - t) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, m = step(params, state, batch)
        end.record()
        torch.cuda.synchronize()
        steps.append({"step": i, "step_ms": start.elapsed_time(end),
                      "data_ms": data_ms, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "lr": float(m["lr"]), "tokens": float(m["tokens"])})
        if not math.isfinite(steps[-1]["loss"]):
            raise AssertionError(f"train: step {i} {steps[-1]}")
    timed = steps[TRAIN_WARMUP:]
    step_ms = sorted(s["step_ms"] for s in timed)[len(timed) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated()
    # accumulation at the same parameters (the next batch)
    batch = data_mod.make_batch(dcfg, len(steps), device)
    with torch.no_grad():
        plain = float(loss_fn(api, params, batch)[0])
    acc = make_accum_train_step(api, ocfg, AccumConfig(num_microbatches=2),
                                donate=True)
    _, _, _, ma = acc(params, state, None, batch)
    accum = float(ma["loss"])
    acc_rel = abs(accum - plain) / abs(plain)
    if acc_rel > TRAIN_ACCUM_RTOL:
        raise AssertionError(f"train: accumulated loss {accum} against "
                             f"{plain}")
    peak_accum = torch.cuda.max_memory_allocated()
    launches = read_launches()
    del params, state, batch, m, ma
    gc.collect()
    torch.cuda.empty_cache()
    active = api.active_params_per_token()
    emit({"phase": "train", "arch": cfg.name, "layers": cfg.num_layers,
          "params": n_params, "param_dtype": cfg.param_dtype,
          "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "remat": "full",
          "init_s": init_s, "steps": steps,
          "step_ms_median_timed": step_ms,
          "tokens_per_s": tokens / (step_ms / 1e3),
          "data_ms_mean_timed": sum(s["data_ms"] for s in timed)
          / len(timed),
          "grad_norm_finite": all(math.isfinite(s["grad_norm"])
                                  for s in steps),
          "peak_mem_bytes": peak, "peak_mem_bytes_with_accum": peak_accum,
          "model_flops_share_of_bf16_peak_for_reading_only":
              6 * active * tokens / (step_ms / 1e3) / H.PEAK_FLOPS_BF16,
          "accum_2_microbatches": {"loss_plain": plain,
                                   "loss_accum": accum, "rel": acc_rel,
                                   "rtol": TRAIN_ACCUM_RTOL},
          "launches": launches, "ok": True})
    return launches, step_ms


def state_digest(tree) -> list:
    """Per leaf, two int64 sums of its bits on the card (plain, and each
    element weighted by its index mod 65521, plus 1): a bit-identity
    check of trees too large to keep two of."""
    import torch
    from repro_torch import tree as T
    out = []
    for x in T.leaves(tree):
        w = int_bits(x.detach()).reshape(-1)
        acc = torch.zeros(2, dtype=torch.int64, device=x.device)
        for a in range(0, w.numel(), 1 << 26):
            c = w[a:a + (1 << 26)].to(torch.int64)
            idx = torch.arange(a, a + c.numel(), device=x.device) % 65521
            acc[0] += c.sum()
            acc[1] += (c * (idx + 1)).sum()
        out.append(acc)
    return torch.stack(out).tolist()


def meta_like(tree):
    import torch
    from repro_torch import tree as T
    return T.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                            device="meta"), tree)


def launcher_replay(cfg, argv_steps: int, seq: int, batch: int, root,
                    save_at: int, device):
    """The launcher's --compress loop of this commit's parent, one
    process and no group: value_and_grad, compress_grads and a donated
    AdamW update on the whole state, the asynchronous EXTENT save at
    ``save_at``. Returns the state after the last step."""
    from repro_torch.launch import train as launch_train
    from repro_torch.memory import default_backend
    from repro_torch.models import get_model
    from repro_torch.train import compression as comp
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.train_step import value_and_grad
    api = get_model(cfg)
    params = api.init(0, device)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10,
                           total_steps=argv_steps)
    state = opt.init(params)
    ccfg = comp.CompressionConfig(enable=True)
    ef = comp.init_state(params)
    ck = Checkpointer(str(root), async_save=True,
                      extent_policy=launch_train.moments_low,
                      extent_backend=default_backend(device), device=device)
    it = data_mod.DataIterator(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch),
        device=device)
    for i in range(argv_steps):
        _, _, grads = value_and_grad(api, params, next(it), remat=True)
        grads, ef = comp.compress_grads(grads, ef, ccfg)
        params, state, _ = opt.update(ocfg, grads, state, params,
                                      donate=True)
        if i == save_at:
            ck.save(i, {"params": params, "opt": state},
                    extra=it.state_dict())
    ck.wait()
    return {"params": params, "opt": state}


def phase_train_launcher(device):
    """The port's launch/train.py main through argv: qwen2.5-3b at full
    width, depth cut to CKPT_LAYERS, --compress, an asynchronous EXTENT
    checkpoint at step 2 of 3 (seq 2048, batch 2), through the rank path
    (one nccl rank on the card, ``--mesh-shape 1x1``: the (data, model)
    path with the model axis's code running): its extent_write launches
    (one per changed moment leaf) held against its report, its stage seconds
    printed; its leaf files byte-identical to the one-process loop's
    (``launcher_replay``, uncounted). That checkpoint restored with the
    400 K integrity pass through the rank path (``Checkpointer.restore
    (dims=)`` on a one-rank group: one scrub launch per moment leaf)
    against the one-process restore (uncounted): every leaf and the
    report equal. Then repro_torch.examples.train_lm_extent --steps 60
    on the card: its saves, the restore at step 30 and its "must learn"
    check."""
    import dataclasses
    import io
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.device import (end_process_group, local_rendezvous,
                                    start_process_group)
    from repro_torch.examples import train_lm_extent
    from repro_torch.launch import train as launch_train
    from repro_torch.models import get_model
    from repro_torch.reliability import RestoreIntegrity
    from repro_torch.sharding import make_production_mesh
    from repro_torch.sharding.rules import mesh_shards, strategy_rules
    from repro_torch.train.checkpoint import Checkpointer
    root = CKPT_DIR / "launcher"
    plain_root = CKPT_DIR / "launcher_one_process"
    for d in (root, plain_root):
        shutil.rmtree(d, ignore_errors=True)

    def cut(arch):
        return dataclasses.replace(get_config(arch), num_layers=CKPT_LAYERS)

    reset_launches()
    launch_train.get_config = cut
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = launch_train.main([
                "--compress", "--ckpt-dir", str(root), "--ckpt-every", "2",
                "--steps", "3", "--seq", "2048", "--batch", "2",
                "--mesh-shape", "1x1"])
    finally:
        launch_train.get_config = get_config
    torch.cuda.synchronize()
    launcher_s = time.perf_counter() - t0
    launches = read_launches()
    rep = out["save_report"]
    # every float leaf but bfloat16 goes through the write (at its level;
    # at full width the weights are bf16, so only the moments)
    manifest = json.loads((root / "step_000000002" / "manifest.json"
                           ).read_text())
    written = [e["path"] for e in manifest["leaves"]
               if e["dtype"] in ("float16", "float32", "float64")]
    changed = len(written) - rep["skipped_leaves"]
    moments = sum(".m[" in p or ".v[" in p for p in written)
    lines = buf.getvalue().splitlines()
    if rep["step"] != 2 or launches["extent_write"] != changed \
            or rep["energy_pj"] <= 0 or not lines[-1].startswith("done: ") \
            or not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"train_launcher: {launches} against {rep}, "
                             f"{lines}")
    gc.collect()
    torch.cuda.empty_cache()
    # the one-process loop from the same seeds saves the same files
    cfg = cut("qwen2.5-3b")
    t0 = time.perf_counter()
    with uncounted("extent_write"):
        state = launcher_replay(cfg, 3, 2048, 2, plain_root, 2, device)
    replay_s = time.perf_counter() - t0
    if not same_checkpoint_files(root / "step_000000002",
                                 plain_root / "step_000000002"):
        raise AssertionError("train_launcher: the rank path's save differs "
                             "from the one-process loop's")
    like = meta_like(state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the launcher's checkpoint restored through the rank path, and by
    # one process
    integrity = RestoreIntegrity(**CKPT_INTEGRITY)
    before = read_launches()
    t0 = time.perf_counter()
    dev = start_process_group(0, 1, local_rendezvous(), device)
    try:
        mesh = make_production_mesh(shape=(1, 1), device=dev)
        api = get_model(cfg)
        shards = mesh_shards(mesh, strategy_rules(mesh, "baseline"), api)
        ck = Checkpointer(str(root), extent_policy=launch_train.moments_low,
                          extent_backend="cuda", device=dev)
        got, extra = ck.restore(like, integrity=integrity,
                                dims=shards.state_dims())
        rank_rep = ck.last_restore_report
        rank_digest = state_digest(got)
        del got
    finally:
        end_process_group()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_launches = {k: v - before[k] for k, v in read_launches().items()}
    gc.collect()
    torch.cuda.empty_cache()
    with uncounted("scrub"):
        ck1 = Checkpointer(str(root), extent_policy=launch_train.moments_low,
                           extent_backend="cuda", device=device)
        got1, extra1 = ck1.restore(like, integrity=integrity)
        one_digest = state_digest(got1)
        del got1
    one_rep = ck1.last_restore_report

    def drop_times(r):
        return {k: v for k, v in r.items() if k != "stage_s"}

    if rank_digest != one_digest or extra != extra1 \
            or drop_times(rank_rep) != drop_times(one_rep) \
            or restore_launches["scrub"] != moments \
            or rank_rep["leaves_checked"] != moments:
        raise AssertionError(f"train_launcher: rank-path restore {rank_rep} "
                             f"{restore_launches} against {one_rep}")
    launches = {k: launches[k] + restore_launches[k] for k in launches}
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(plain_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    before = read_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_lm_extent.main(["--steps", "60", "--device", "cuda",
                              "--ckpt-dir", str(root / "example")])
    torch.cuda.synchronize()
    example_s = time.perf_counter() - t0
    ex = buf.getvalue().splitlines()
    ex_launches = {k: v - before[k] for k, v in read_launches().items()}
    if ex[-1] != "OK" or "step   30 !! simulated preemption -> restore" \
            not in ex or not ex_launches["extent_write"]:
        raise AssertionError(f"train_launcher: example {ex} "
                             f"{ex_launches}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit({"phase": "train_launcher", "arch": cfg.name,
          "reduced": {"num_layers": f"{CKPT_LAYERS} of "
                                    f"{get_config('qwen2.5-3b').num_layers}"},
          "argv": "--compress --ckpt-every 2 --steps 3 --seq 2048 "
                  "--batch 2 --mesh-shape 1x1", "ranks": 1, "lines": lines,
          "seconds": launcher_s,
          "save": {k: rep[k] for k in (
              "step", "leaves", "skipped_leaves", "bytes", "energy_pj",
              "bit_errors", "seconds", "stage_s")},
          "save_equals_one_process_loop": True, "replay_s": replay_s,
          "rank_path_restore": {**drop_times(rank_rep),
                                "seconds": restore_s,
                                "equals_one_process_restore": True,
                                "launches": restore_launches},
          "save_launches": {k: launches[k] - restore_launches[k]
                            for k in launches},
          "leaves_written": changed, "moment_leaves": moments,
          "example": {"argv": "--steps 60", "seconds": example_s,
                      "lines": ex, "launches": ex_launches},
          "ok": True})
    return {k: launches[k] + ex_launches[k] for k in launches}


#: steps of each path in the train_mesh phases (batches 0, 1, ...)
MESH_STEPS = 2
#: qwen2.5-3b's depth in the train_mesh phase: 12 of 36 layers since
#: train_mesh_families carries the rank path at full depth
#: (recurrentgemma-2b's 26 layers)
MESH_LAYERS = 12


def plain_and_sharded(api, ocfg, batches, shards, device):
    """The plain ``make_train_step`` from ``api.init(0)``, then the
    one-rank ``make_sharded_train_step`` on ``shards``' slices, each
    with donated state over the same ``batches`` (full remat), the first
    path freed before the second starts. Raises unless every parameter,
    moment (``state_digest``) and metric is equal after every step.
    Returns each path's steps' ms (CUDA events) and metrics and its peak
    memory."""
    import torch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (make_sharded_train_step,
                                              make_train_step)
    out = {}
    for name in ("plain", "sharded"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if name == "plain":
            step = make_train_step(api, ocfg, remat=True, donate=True)
            params = api.init(0, device)
        else:
            step = make_sharded_train_step(api, ocfg, shards, remat=True,
                                           donate=True)
            params = api.init(0, device, keep=shards.keep)
        state = opt.init(params)
        runs = []
        for batch in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, state, m = step(params, state, batch)
            end.record()
            torch.cuda.synchronize()
            runs.append((start.elapsed_time(end),
                         state_digest((params, state)),
                         {k: float(v) for k, v in m.items()}))
        del params, state, step, m
        out[name] = {"step_ms": [r[0] for r in runs],
                     "metrics": [r[2] for r in runs],
                     "digests": [r[1] for r in runs],
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    gc.collect()
    torch.cuda.empty_cache()
    for i, (dp, ds) in enumerate(zip(out["plain"]["digests"],
                                     out["sharded"]["digests"])):
        mp, ms = out["plain"]["metrics"][i], out["sharded"]["metrics"][i]
        if ds != dp or ms != mp:
            raise AssertionError(f"{api.cfg.name}: step {i} of the one-rank "
                                 f"sharded path differs from the plain "
                                 f"step: {ms} against {mp}")
    leaves = len(out["plain"]["digests"][0])
    for path in out.values():
        del path["digests"]
    return {**out, "leaves_compared": leaves}


def phase_train_mesh(device, plain_step_ms: float):
    """The port's training over a (data, model) mesh on one nccl rank: a
    group of one on the card (``start_process_group``; its first
    collective, which builds the communicator, timed apart), the (1, 1)
    production mesh over it with its data and model subgroups, the
    baseline rules' ``MeshShards`` (the embed dimension on ``data``; the
    heads, the MLP's hidden units and the vocabulary on ``model``, whose
    tensor-parallel code runs on a group of one: its copies, row-parallel
    sums, vocabulary-parallel embedding and loss; the norm scales and kv
    projections whole), and qwen2.5-3b at MESH_LAYERS of its 36 layers
    and the train phase's shapes (seq 4096, batch 2, full remat, donated
    state) through ``make_sharded_train_step`` for MESH_STEPS steps
    against the plain ``make_train_step`` steps from the same seeded
    state over the same batches (``plain_and_sharded``: every parameter,
    moment and metric equal bit for bit after each step). The
    collectives issued on the model group (``model_collectives``; must
    be > 0), each step's ms (CUDA events) against the plain step's and
    each path's peak memory (beside what earlier phases left allocated)
    are printed with the train phase's steady step (at 36 layers)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.device import (end_process_group, local_rendezvous,
                                    start_process_group)
    from repro_torch.models import get_model
    from repro_torch.models.layers import (model_collectives,
                                           reset_model_collectives)
    from repro_torch.sharding import make_production_mesh
    from repro_torch.sharding.rules import default_rules, mesh_shards
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt
    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              num_layers=MESH_LAYERS)
    api = get_model(cfg)
    ocfg = opt.AdamWConfig(warmup_steps=2, total_steps=100)
    dcfg = data_mod.DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    held = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    dev = start_process_group(0, 1, local_rendezvous(), device)
    try:
        dist.all_reduce(torch.zeros(1, device=dev))
        torch.cuda.synchronize()
        group_s = time.perf_counter() - t0
        mesh = make_production_mesh(shape=(1, 1), device=dev)
        shards = mesh_shards(mesh, default_rules(mesh), api)
        axis = shards.model_axis
        batches = [data_mod.make_batch(dcfg, i, dev)
                   for i in range(MESH_STEPS)]
        reset_model_collectives()
        paths = plain_and_sharded(api, ocfg, batches, shards, dev)
        collectives = model_collectives()
    finally:
        end_process_group()
    phase_s = time.perf_counter() - t0
    launches = read_launches()
    if not (axis.heads and axis.mlp and axis.vocab) or collectives <= 0:
        raise AssertionError(f"train_mesh: the model-axis code did not run "
                             f"({axis}, {collectives} collectives)")
    cuts = {a: sum(getattr(c, a) is not None for c in shards.flat_dims)
            for a in ("data", "model")}
    emit({"phase": "train_mesh", "arch": cfg.name, "layers": cfg.num_layers,
          "reduced": {"num_layers": f"{MESH_LAYERS} of 36"},
          "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "remat": "full",
          "backend": "nccl", "ranks": 1, "mesh": mesh.shape,
          "rules": "baseline", "leaves_cut_on": cuts,
          "whole_leaves": len(shards.flat_dims) - sum(shards.sharded()),
          "model_axis": {"heads": axis.heads, "mlp": axis.mlp,
                         "vocab": axis.vocab},
          "model_group_collectives": collectives,
          "model_group_collectives_per_step": collectives / MESH_STEPS,
          "step_ms": paths["sharded"]["step_ms"],
          "plain_step_ms": paths["plain"]["step_ms"],
          "train_phase_step_ms": plain_step_ms,
          "group_start_s": group_s,
          "peak_mem_bytes": paths["sharded"]["peak_mem_bytes"],
          "plain_peak_mem_bytes": paths["plain"]["peak_mem_bytes"],
          "allocated_at_start_bytes": held,
          "seconds": phase_s, "metrics": paths["sharded"]["metrics"],
          "bit_identical_to_plain_steps": True,
          "leaves_compared": paths["leaves_compared"],
          "nvidia_smi": nvidia_smi_line(), "launches": launches,
          "ok": True})
    return launches


#: the train_mesh_families phase: dbrx-132b at published width and
#: DBRX_MESH_LAYERS of its 40 layers (4.49 G parameters: 53.9 GB of bf16
#: weights and gradients and float32 moments before activations) at
#: length DBRX_MESH_SEQ, batch 2, at capacity factor DBRX_MESH_CAPACITY:
#: the published 1.25 drops no assignment of the seeded weights' router
#: (measured), 1.0 drops some, so that the group's drops are compared
DBRX_MESH_LAYERS = 1
DBRX_MESH_SEQ = 4096
DBRX_MESH_CAPACITY = 1.0
#: the compressed step's wire key
MESH_WIRE_KEY = 0x31


def phase_train_mesh_families(device):
    """The other families and ``--compress`` over the data axis on one
    nccl rank, with everything earlier freed. First, the memory the
    decay's hash-base cache holds (``lifetime._elem_hash_base``, bounded
    by bytes): allocated before and after clearing it. Then one group of
    one rank and, each against the plain one-process path on the card:
    (a) recurrentgemma-2b at published width and depth (26 layers, seq
    TRAIN_SEQ, batch TRAIN_BATCH, full remat, donated state) and (b)
    dbrx-132b at DBRX_MESH_LAYERS of 40 layers (seq DBRX_MESH_SEQ; its
    MoE layer dispatches over the group, one count all-gather a layer),
    each MESH_STEPS steps over batches drawn once (``plain_and_sharded``:
    bit identity after every step, ``dropped`` among the metrics); (c)
    one ``--compress`` step of the reduced qwen2.5-3b with the device's
    wire backend (each leaf's codes gathered and written whole through
    ``extent_write``), parameters, moments, residuals, metrics and wire
    stats equal to the one-process compressed step's (whose launches do
    not count); (d) every TRAIN_FAMILIES reduced config's sharded step
    equal to its plain card step."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import rng
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.device import (end_process_group, local_rendezvous,
                                    start_process_group)
    from repro_torch.memory import default_backend
    from repro_torch.models import get_model
    from repro_torch.reliability import lifetime
    from repro_torch.sharding import make_production_mesh
    from repro_torch.sharding.rules import default_rules, mesh_shards
    from repro_torch.train import compression as comp
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (make_sharded_train_step,
                                              make_train_step,
                                              sharded_value_and_grad,
                                              value_and_grad)
    t0 = time.perf_counter()
    cache = {"allocated_before_bytes": torch.cuda.memory_allocated(),
             "cache_held_bytes": lifetime._elem_hash_base.bytes_held(),
             "cache_limit_bytes": lifetime._elem_hash_base.limit}
    lifetime._elem_hash_base.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    cache["allocated_after_clear_bytes"] = torch.cuda.memory_allocated()
    print(f"train_mesh_families: allocated {cache}", flush=True)
    ocfg = opt.AdamWConfig(warmup_steps=2, total_steps=100)
    reset_launches()
    dev = start_process_group(0, 1, local_rendezvous(), device)
    out = {}
    try:
        dist.all_reduce(torch.zeros(1, device=dev))
        mesh = make_production_mesh(shape=(1, 1), device=dev)

        def shards_of(api):
            return mesh_shards(mesh, default_rules(mesh), api)

        # (a), (b): full width
        full = (("recurrentgemma-2b", get_config("recurrentgemma-2b"),
                 TRAIN_SEQ),
                ("dbrx-132b", dataclasses.replace(
                    get_config("dbrx-132b"), num_layers=DBRX_MESH_LAYERS,
                    capacity_factor=DBRX_MESH_CAPACITY), DBRX_MESH_SEQ))
        for arch, cfg, seq in full:
            t = time.perf_counter()
            api = get_model(cfg)
            dcfg = data_mod.DataConfig(cfg.vocab_size, seq, TRAIN_BATCH)
            batches = [data_mod.make_batch(dcfg, i, dev)
                       for i in range(MESH_STEPS)]
            paths = plain_and_sharded(api, ocfg, batches, shards_of(api),
                                      dev)
            del batches
            if cfg.num_experts and not all(
                    m["dropped"] for m in paths["sharded"]["metrics"]):
                raise AssertionError(f"train_mesh_families: {arch} dropped "
                                     "no assignment")
            out[arch] = {"layers": cfg.num_layers, "seq": seq,
                         "batch": TRAIN_BATCH, "params": api.num_params(),
                         **paths, "seconds": time.perf_counter() - t}
        # (c) one --compress step through the device's wire
        t = time.perf_counter()
        api = get_model(get_config("qwen2.5-3b").reduced())
        shards = shards_of(api)
        ccfg = comp.CompressionConfig(wire_backend=default_backend(dev))
        key = rng.PRNGKey(MESH_WIRE_KEY)
        batch = {k: v.to(dev) for k, v in train_batch(api.cfg, 2).items()}

        def compressed(params, vg, dims, counted):
            ef = comp.init_state(params)
            loss, aux, grads = vg(params)
            grads, ef, st = comp.compress_grads(grads, ef, ccfg, key,
                                                with_stats=True, dims=dims)
            params, state, om = opt.update(ocfg, grads, opt.init(params),
                                           params, counted=counted)
            return ((params, state, ef), {"loss": float(loss), **{
                k: float(v) for k, v in {**aux, **om}.items()}},
                {k: float(v) for k, v in vars(st).items()})

        with uncounted("extent_write"):
            want = compressed(api.init(0, dev),
                              lambda p: value_and_grad(api, p, batch),
                              None, None)
        got = compressed(api.init(0, dev, keep=shards.keep),
                         lambda p: sharded_value_and_grad(api, p, batch,
                                                          shards),
                         shards.flat_dims, shards.counted())
        if not (all(torch.equal(a, b) for a, b in zip(T.leaves(got[0]),
                                                       T.leaves(want[0])))
                and got[1:] == want[1:]):
            raise AssertionError(f"train_mesh_families: the compressed "
                                 f"sharded step {got[1:]} against {want[1:]}")
        out["compress"] = {"arch": api.cfg.name, "wire": ccfg.wire_backend,
                           "metrics": got[1], "wire_stats": got[2],
                           "leaves": len(T.leaves(got[0][0])),
                           "seconds": time.perf_counter() - t}
        # (d) every reduced family
        t = time.perf_counter()
        red = {}
        for arch in TRAIN_FAMILIES:
            api = get_model(get_config(arch).reduced())
            batch = {k: v.to(dev) for k, v in train_batch(api.cfg,
                                                          1).items()}
            ocfg_r = opt.AdamWConfig(lr=1e-3, warmup_steps=1,
                                     total_steps=10)
            p = api.init(0, dev)
            want = make_train_step(api, ocfg_r)(p, opt.init(p), batch)
            sh = shards_of(api)
            p = api.init(0, dev, keep=sh.keep)
            got = make_sharded_train_step(api, ocfg_r, sh)(p, opt.init(p),
                                                           batch)
            gm = {k: float(v) for k, v in got[2].items()}
            if not (all(torch.equal(a, b) for a, b in zip(
                    T.leaves(got[:2]), T.leaves(want[:2])))
                    and gm == {k: float(v) for k, v in want[2].items()}):
                raise AssertionError(f"train_mesh_families: {arch}'s "
                                     f"sharded step differs on the card")
            red[arch] = gm
        out["reduced_families"] = {"steps": red,
                                   "seconds": time.perf_counter() - t}
    finally:
        end_process_group()
    launches = read_launches()
    emit({"phase": "train_mesh_families", "backend": "nccl", "ranks": 1,
          "mesh": mesh.shape, "rules": "baseline", "remat": "full",
          "hash_base_cache": cache, "reduced": {
              "dbrx-132b": {"num_layers": f"{DBRX_MESH_LAYERS} of 40",
                            "capacity_factor": f"{DBRX_MESH_CAPACITY} "
                                               "(published 1.25)"}},
          **out, "bit_identical_to_plain_steps": True,
          "seconds": time.perf_counter() - t0,
          "nvidia_smi": nvidia_smi_line(), "launches": launches,
          "ok": True})
    return launches


#: the dry run's cell (of the reference's (16, 16) table) and where its
#: record is written (removed after)
TOOLS_DRYRUN_CELL = ("qwen2.5-3b", "train_4k")
TOOLS_DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"


def phase_tools(device, train_step_ms: float):
    """The port's tools on the card. (1) dryrun.smoke_backends("cuda"):
    every memory backend writes a bf16 (33,) and an int8 (129,) leaf; the
    cuda backend's stored words and flips must equal lanes_ref's, and it
    must launch extent_write once a case. (2) The roofline of the train
    phase's cell on one card (launch/roofline.py's cell_flops and
    cell_bytes over launch/hw.py's rates) against its measured step.
    (3) dryrun.run_cell of qwen2.5-3b x train_4k on the (16, 16) mesh on
    the meta device."""
    import io
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import hw as H
    from repro_torch.launch import roofline
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        smoke = dryrun.smoke_backends(device)
    torch.cuda.synchronize()
    smoke_s = time.perf_counter() - t0
    launches = read_launches()
    cases = {}
    for label, res in smoke.items():
        cuda, twin = res["cuda"], res["lanes_ref"]
        if not (torch.equal(cuda["stored"], twin["stored"])
                and cuda["flips"] == twin["flips"]
                and cuda["errors"] == twin["errors"]):
            raise AssertionError(f"tools: cuda against lanes_ref ({label})")
        cases[label] = {n: {k: v for k, v in r.items() if k != "stored"}
                        for n, r in res.items()}
    if launches != {**{k: 0 for k in KERNELS},
                    "extent_write": len(smoke)}:
        raise AssertionError(f"tools: smoke launches {launches}")
    # the train phase's cell on one card
    cfg = get_config("qwen2.5-3b")
    cell = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    fl = roofline.cell_flops(cfg, cell)
    by = roofline.cell_bytes(cfg, cell)
    compute_s = fl["total"] / H.PEAK_FLOPS_BF16
    memory_s = by["total"] / H.HBM_BW
    bound_s = max(compute_s, memory_s)
    step_s = train_step_ms / 1e3
    # the reference's (16, 16) cell on meta
    shutil.rmtree(TOOLS_DRYRUN_DIR, ignore_errors=True)
    rec = dryrun.run_cell(*TOOLS_DRYRUN_CELL, False, TOOLS_DRYRUN_DIR)
    shutil.rmtree(TOOLS_DRYRUN_DIR, ignore_errors=True)
    if not (rec["cost"]["flops"] > 0 and rec["n_devices"] == 256):
        raise AssertionError(f"tools: dry run {rec}")
    emit({"phase": "tools",
          "smoke_backends": {"cases": cases, "lines":
                             buf.getvalue().splitlines(),
                             "seconds": smoke_s,
                             "cuda_equals_lanes_ref": True},
          "roofline_train": {
              "arch": cfg.name, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
              "chips": 1, "cell_flops": fl, "cell_bytes": by,
              "compute_s": compute_s, "memory_s": memory_s,
              "bound_step_s": bound_s,
              "bottleneck": "compute" if compute_s >= memory_s
              else "memory",
              "measured_step_s": step_s,
              "model_flops_over_peak_x_step":
                  fl["model_flops"] / (H.PEAK_FLOPS_BF16 * step_s),
              "bound_over_measured": bound_s / step_s,
              "rates": {"PEAK_FLOPS_BF16": H.PEAK_FLOPS_BF16,
                        "HBM_BW": H.HBM_BW}},
          "dryrun": {k: rec[k] for k in (
              "arch", "shape", "mesh", "n_devices", "device", "trace_s",
              "memory", "cost", "collectives")},
          "launches": launches, "ok": True})
    return launches


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
    s_abs = phase_scrub_kernel(device)
    att_worst = phase_local_attention_kernel(device)
    q_worst = phase_kv_quant_kernel(device)
    phase_rng_device(device)
    phase_reduced(device)
    phase_reduced_hybrid(device)
    rm_launches = phase_reduced_moe(device)
    rf_launches = phase_reduced_families(device)
    launches, eng, sch, full_rep = phase_full(device)
    r_launches, r_sch, ret_rep = phase_retention(device, eng)
    s_launches = r_launches["scrub"]
    # the dense path's entries are timed on its own state, which is then
    # freed, so the hybrid phase's peak memory is its own
    entries = [extent_write_entry(launches, worst_abs, worst_rel, eng, sch,
                                  device),
               scrub_entry(s_launches, s_abs, r_sch, device)]
    del sch, r_sch
    gc.collect()
    t_launches = phase_telemetry(device, eng, full_rep, launches)
    sh_launches, masked = phase_shards(device, eng, ret_rep, r_launches)
    phase_oracle(device, eng)
    phase_prefix(device, eng)
    phase_soft_errors(device, eng)
    window, w_scrub, w_launches = phase_wear(device, eng, full_rep, launches)
    smp_launches = phase_sampling(device, eng, launches)
    wl_launches = phase_workload(device, eng)
    # the wear runs' launches and the windowed scrub's times join the
    # entries of the kernels they drove
    entries[0]["launches_by_path"] = {
        "full": launches, "telemetry": t_launches["extent_write"],
        **{k: v["extent_write"] for k, v in sh_launches.items()},
        **{f"wear_{k}": v["extent_write"] for k, v in w_launches.items()},
        "reduced_moe": rm_launches["extent_write"],
        "sampling": smp_launches, "workload": wl_launches}
    entries[1]["launches_by_path"] = {
        "retention": s_launches,
        **{k: v["scrub"] for k, v in sh_launches.items()},
        "wear_failure": w_scrub, "reduced_moe": rm_launches["scrub"]}
    entries[1]["at"]["window_through_rotation"] = window
    entries[1]["at"]["die_masked"] = masked
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    h_launches, h_sch, served_worst = phase_hybrid(device)
    entries += [local_attention_entry(h_launches["local_attention"],
                                      att_worst, att_registers, device),
                kv_quant_entry(h_launches["kv_quant"],
                               max(q_worst, served_worst), q_registers,
                               h_sch)]
    # the hybrid's state goes before dbrx-132b's 41.6 GB of weights
    del h_sch
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches, moe_admission = phase_moe(device)
    entries[0]["launches_by_path"]["moe"] = moe_launches
    entries[0]["at"]["admission_moe"] = moe_admission
    # each full-width model of the three families loads alone
    full_width = {}
    for phase in (phase_ssm, phase_vlm, phase_audio):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        full_width[phase.__name__[len("phase_"):]] = phase(device)
    # the dense windowed models and scout, each alone
    dense = {}
    for arch in DENSE_WINDOW_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dense[arch] = phase_dense_windows(device, arch)
    gc.collect()
    torch.cuda.empty_cache()
    scout_launches, scout_admission = phase_scout(device)
    entries[0]["launches_by_path"].update(
        {arch: n for arch, (n, _) in dense.items()}, scout=scout_launches)
    entries[0]["at"].update(
        {f"admission_{arch}_{kind}": w for arch, (_, ws) in dense.items()
         for kind, w in ws.items()}, admission_scout=scout_admission)
    gc.collect()
    torch.cuda.empty_cache()
    phase_paper(device)
    sb_launches, kb_timing = phase_serving_bench(device)
    entries[0]["launches_by_path"].update(
        reduced_families=rf_launches["extent_write"],
        ssm=full_width["ssm"]["extent_write"], vlm=full_width["vlm"][0],
        audio=full_width["audio"][0])
    entries[0]["at"].update(
        admission_vlm=full_width["vlm"][1],
        prefill_cross_audio=full_width["audio"][1]["prefill_cross"],
        decode_column_audio=full_width["audio"][1]["decode_column"],
        kernel_bench=kb_timing)
    entries[1]["launches_by_path"].update(
        reduced_families=rf_launches["scrub"],
        ssm=full_width["ssm"]["scrub"])
    for e in entries[2:]:
        e["launches_by_path"] = {"hybrid": e["launches"]}
    for e in entries:
        e["launches_by_path"]["serving_bench"] = sb_launches[e["name"]]
    # the training state is built with everything earlier freed
    gc.collect()
    torch.cuda.empty_cache()
    cr_launches = phase_checkpoint_reduced(device)
    ck_launches, ck_timing, ck_scrub = phase_checkpoint(device)
    for e in entries:
        e["launches_by_path"].update(
            checkpoint_reduced=cr_launches[e["name"]],
            checkpoint=ck_launches[e["name"]])
    entries[0]["at"]["checkpoint_embed_moment"] = ck_timing
    entries[1]["at"]["checkpoint_embed_moment"] = ck_scrub
    # the training loop, each phase with everything earlier freed
    train_launches = {}
    for phase in (phase_train_reduced, phase_train, phase_train_launcher):
        gc.collect()
        torch.cuda.empty_cache()
        train_launches[phase.__name__[len("phase_"):]] = phase(device)
    train_launches["train"], train_step_ms = train_launches["train"]
    gc.collect()
    torch.cuda.empty_cache()
    train_launches["train_mesh"] = phase_train_mesh(device, train_step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches["train_mesh_families"] = phase_train_mesh_families(device)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches["tools"] = phase_tools(device, train_step_ms)
    for e in entries:
        e["launches_by_path"].update(
            {k: v[e["name"]] for k, v in train_launches.items()})
    emit({"phase": "done", "script_s": time.perf_counter() - T_START})
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": entries})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
