"""KV-write-pressure scoring and the monotone mix ramp (host code, a copy
of ``repro.workload.pressure``).

The Kill-Llama harness graded SPEC mixes mix1→mix7 by rising last-level-
cache MPKI — a *monotone pressure axis* — and re-ran every cache policy
across the whole ramp so a policy's win had to survive the full pressure
spectrum. Our analogue for an STT-RAM-backed KV cache is **KV write
pressure**: how many prompt tokens per serving step the stream admits,
amortized over how long each admission's columns stay resident —

    pressure = (admissions / makespan) × mean_prompt_len / mean_dwell

(admission rate × prompt length ÷ slot dwell). High pressure means the
pool churns fresh KV writes every step (admission-dominated, the regime
where write energy, wear, and prefix reuse all concentrate); low pressure
means long-dwelling decodes amortize each admission.

``build_ramp`` generates one mix per preset family with parameters spread
across that axis, then **orders the mixes by their measured score and
asserts strict monotonicity** — the ramp is sorted evidence, not a naming
convention.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

from repro_torch.workload import generators
from repro_torch.workload.trace import Trace


def pressure_score(trace: Trace) -> float:
    """Admissions × mean prompt length ÷ mean slot dwell, per step of the
    stream's makespan. Pure trace metadata — no serving run needed."""
    n = len(trace.events)
    first = trace.events[0].arrival
    last = trace.events[-1].arrival
    makespan = max(1, last - first + 1)
    mean_prompt = sum(len(e.tokens) for e in trace.events) / n
    mean_dwell = sum(e.new_tokens for e in trace.events) / n
    return (n / makespan) * mean_prompt / max(1.0, mean_dwell)


def assert_monotone(scores: Sequence[float]) -> None:
    """Strictly increasing, or the ramp is not a pressure axis."""
    for i, (a, b) in enumerate(zip(scores, scores[1:])):
        assert a < b, (
            f"pressure ramp not strictly monotone at mix{i + 1}->"
            f"mix{i + 2}: {a:.4f} >= {b:.4f}")


def order_ramp(mixes: Dict[str, Trace]) -> List[Dict[str, Any]]:
    """Order named mixes by measured KV-write pressure into mix1→mixN,
    asserting strict monotonicity. Returns [{mix, name, trace, pressure}]
    with ``mix`` the 1-based rank."""
    scored = sorted(((pressure_score(t), name, t)
                     for name, t in mixes.items()), key=lambda x: x[0])
    assert_monotone([s for s, _, _ in scored])
    return [{"mix": i + 1, "name": name, "trace": t, "pressure": s}
            for i, (s, name, t) in enumerate(scored)]


def build_ramp(cfg, seed: int = 0, n: int = 6) -> List[Dict[str, Any]]:
    """The default mixed-traffic ramp: one mix per preset family with
    parameters spread along the pressure axis — sparse steady traffic at
    the bottom, a shared-system-prompt admission flood at the top. The
    ordering is measured and asserted, never assumed."""
    mixes = {
        # long gaps, short prompts, long dwells: admission-starved
        "steady_sparse": generators.steady(
            cfg, n, seed, prompt_len=8, new_tokens=8, arrival_every=8),
        # day-curve load with a mid-stream peak
        "diurnal": generators.diurnal(
            cfg, n, seed, prompt_len=8, new_tokens=6, base_gap=6,
            peak_gap=2),
        # chat/batch disagreement: mixed shapes, mixed dwells
        "chat_batch": generators.chat_batch(
            cfg, n, seed, arrival_every=3),
        # fat-tail contexts: admission write volume concentrates
        "heavy_tail": generators.heavy_tail(
            cfg, n, seed, min_len=4, max_len=24, new_tokens=4,
            arrival_every=2),
        # two-state spikes: back-to-back admissions in the ON state
        "bursty_spikes": generators.bursty(
            cfg, n, seed, prompt_len=16, new_tokens=3, quiet_gap=4),
        # the flood: everyone arrives nearly at once with a big shared
        # prompt and barely decodes — peak admissions × prompt ÷ dwell
        "shared_prefix_flood": generators.shared_system_prompt(
            cfg, n, seed, shared_len=16, tail_len=4, new_tokens=2,
            arrival_every=1),
    }
    return order_ramp(mixes)
