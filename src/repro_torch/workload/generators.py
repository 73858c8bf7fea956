"""Deterministic trace generators for production traffic shapes.

A copy of ``repro.workload.generators`` whose draws are the port's host
threefry (``repro_torch.rng``): ``fold_in``, ``split``, ``randint`` and
the float32 ``uniform`` are bit-exact with ``jax.random``'s, so a (preset,
seed) pair gives the reference's trace byte for byte.

Every preset maps ``(cfg, n, seed, params) -> Trace`` with zero hidden
state: all randomness forks off the workload root key
``PRNGKey(seed)`` through the registered ``workload-event`` sub-stream
(``rng_streams.WORKLOAD_OFFSET + event_index``), so the same (preset,
seed) pair produces the byte-identical trace in any process on any day —
no wall clock, no global RNG, and the rng-stream-hygiene lint rule covers
the fold constants.

Prompt lengths are quantized to ``LEN_QUANTUM`` so a heavy-tailed mix
produces a handful of distinct prompt shapes (each distinct shape is one
compiled prefill executable) instead of one per request.

Presets:

  * ``steady``               — fixed-gap arrivals, fixed shapes (the
                               synthetic default as a trace);
  * ``diurnal``              — arrival gaps swept along one day-curve
                               period (load peaks mid-stream);
  * ``bursty``               — two-state modulated arrivals: an ON state
                               admits back-to-back, OFF goes quiet, with
                               seeded state transitions;
  * ``heavy_tail``           — Pareto-ish context lengths (many short
                               prompts, a fat tail of long ones);
  * ``chat_batch``           — interactive chat (short prompt, short
                               decode, HIGH hint) mixed with batch jobs
                               (long prompt, long decode, LOW hint);
  * ``shared_system_prompt`` — one system prompt shared by the whole
                               stream with unique tails: the prefix-cache
                               × wear adversarial workload (every hit
                               pins the owner's physical rows).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import rng
from repro_torch.memory import rng_streams
from repro_torch.workload.trace import Trace, TraceEvent, validate_trace

#: prompt lengths snap to multiples of this (compile-shape hygiene).
LEN_QUANTUM = 4


def _event_key(seed: int, index: int) -> np.ndarray:
    """The per-event sub-key: workload root key + the registered
    workload-event stream offset."""
    return rng.fold_in(rng.PRNGKey(seed),
                       rng_streams.WORKLOAD_OFFSET + index)


def _draw_tokens(key: np.ndarray, n: int, vocab: int) -> List[int]:
    return [int(t) for t in rng.randint(key, (n,), 0, vocab)]


def _uniform(key: np.ndarray) -> float:
    return float(rng.uniform(key, ()))


def _quantize(n: int, lo: int, hi: int) -> int:
    q = max(lo, min(hi, n))
    return max(LEN_QUANTUM, (q // LEN_QUANTUM) * LEN_QUANTUM)


def _finish(cfg, events: List[TraceEvent], preset: str, seed: int,
            params: Dict[str, Any]) -> Trace:
    events.sort(key=lambda e: (e.arrival, e.rid))
    return validate_trace(Trace(
        events=tuple(events), vocab_size=cfg.vocab_size,
        family=cfg.family,
        meta={"preset": preset, "seed": seed, "params": params}))


# ------------------------------------------------------------------ presets
def steady(cfg, n: int, seed: int, *, prompt_len: int = 8,
           new_tokens: int = 6, arrival_every: int = 4,
           quality: Optional[str] = None,
           app_id: Optional[str] = None) -> Trace:
    events = []
    for i in range(n):
        k = _event_key(seed, i)
        events.append(TraceEvent(
            rid=i, arrival=i * arrival_every,
            tokens=_draw_tokens(k, prompt_len, cfg.vocab_size),
            new_tokens=new_tokens, quality=quality, app_id=app_id,
            session=i))
    return _finish(cfg, events, "steady", seed, dict(
        prompt_len=prompt_len, new_tokens=new_tokens,
        arrival_every=arrival_every))


def diurnal(cfg, n: int, seed: int, *, prompt_len: int = 8,
            new_tokens: int = 6, base_gap: int = 4,
            peak_gap: int = 1) -> Trace:
    """One day-curve period over the stream: gaps shrink from ``base_gap``
    at the edges to ``peak_gap`` mid-stream (deterministic cosine ramp —
    the arrival *process* is the shape here, not the draws)."""
    import math
    events, arrival = [], 0
    for i in range(n):
        k = _event_key(seed, i)
        phase = math.cos(2.0 * math.pi * (i / max(1, n) - 0.5))
        gap = round(peak_gap + (base_gap - peak_gap) * (1 - phase) / 2)
        arrival += max(0, int(gap))
        events.append(TraceEvent(
            rid=i, arrival=arrival,
            tokens=_draw_tokens(k, prompt_len, cfg.vocab_size),
            new_tokens=new_tokens, session=i))
    return _finish(cfg, events, "diurnal", seed, dict(
        prompt_len=prompt_len, new_tokens=new_tokens, base_gap=base_gap,
        peak_gap=peak_gap))


def bursty(cfg, n: int, seed: int, *, prompt_len: int = 12,
           new_tokens: int = 4, quiet_gap: int = 6,
           p_enter_burst: float = 0.4, p_exit_burst: float = 0.3) -> Trace:
    """Two-state modulated arrival process: in the burst state requests
    arrive back-to-back (gap 0), in the quiet state ``quiet_gap`` apart;
    the state chain transitions on seeded per-event draws."""
    events, arrival, in_burst = [], 0, False
    for i in range(n):
        k = _event_key(seed, i)
        k_tok, k_state = rng.split(k)
        u = _uniform(k_state)
        in_burst = (u < (1.0 - p_exit_burst) if in_burst
                    else u < p_enter_burst)
        arrival += 0 if in_burst else quiet_gap
        events.append(TraceEvent(
            rid=i, arrival=arrival,
            tokens=_draw_tokens(k_tok, prompt_len, cfg.vocab_size),
            new_tokens=new_tokens, session=i))
    return _finish(cfg, events, "bursty", seed, dict(
        prompt_len=prompt_len, new_tokens=new_tokens, quiet_gap=quiet_gap,
        p_enter_burst=p_enter_burst, p_exit_burst=p_exit_burst))


def heavy_tail(cfg, n: int, seed: int, *, min_len: int = 4,
               max_len: int = 24, alpha: float = 1.2,
               new_tokens: int = 4, arrival_every: int = 2) -> Trace:
    """Long-tail context lengths via the Pareto inverse CDF
    ``min_len * (1-u)^(-1/alpha)``, clamped to [min_len, max_len] and
    quantized — most prompts are short, a fat tail is long (the mix that
    stresses admission write volume)."""
    events = []
    for i in range(n):
        k = _event_key(seed, i)
        k_tok, k_len = rng.split(k)
        u = min(_uniform(k_len), 0.999)
        plen = _quantize(int(min_len * (1.0 - u) ** (-1.0 / alpha)),
                         min_len, max_len)
        events.append(TraceEvent(
            rid=i, arrival=i * arrival_every,
            tokens=_draw_tokens(k_tok, plen, cfg.vocab_size),
            new_tokens=new_tokens, session=i))
    return _finish(cfg, events, "heavy_tail", seed, dict(
        min_len=min_len, max_len=max_len, alpha=alpha,
        new_tokens=new_tokens, arrival_every=arrival_every))


def chat_batch(cfg, n: int, seed: int, *, chat_frac: float = 0.5,
               chat_prompt: int = 8, chat_tokens: int = 8,
               batch_prompt: int = 20, batch_tokens: int = 3,
               arrival_every: int = 2) -> Trace:
    """Interactive chat traffic (short prompts, longer decodes, HIGH
    quality hints) interleaved with batch jobs (long prompts, short
    decodes, LOW hints) — the mix where per-request quality floors and
    admission policy actually disagree."""
    events = []
    for i in range(n):
        k = _event_key(seed, i)
        k_tok, k_kind = rng.split(k)
        if _uniform(k_kind) < chat_frac:
            plen, nt, app, q = chat_prompt, chat_tokens, "chat", "high"
        else:
            plen, nt, app, q = batch_prompt, batch_tokens, "batch", "low"
        events.append(TraceEvent(
            rid=i, arrival=i * arrival_every,
            tokens=_draw_tokens(k_tok, plen, cfg.vocab_size),
            new_tokens=nt, quality=q, app_id=app, session=i))
    return _finish(cfg, events, "chat_batch", seed, dict(
        chat_frac=chat_frac, chat_prompt=chat_prompt,
        chat_tokens=chat_tokens, batch_prompt=batch_prompt,
        batch_tokens=batch_tokens, arrival_every=arrival_every))


def shared_system_prompt(cfg, n: int, seed: int, *, shared_len: int = 16,
                         tail_len: int = 4, new_tokens: int = 3,
                         arrival_every: int = 1,
                         quality: Optional[str] = "high") -> Trace:
    """The prefix×wear adversarial flood: every request opens with the
    SAME ``shared_len``-token system prompt (drawn once, from event index
    ``n`` so it never collides with a request's own stream) plus a unique
    tail. Under the prefix cache the whole stream links one owner's
    resident columns — wear-once admission booking makes those physical
    rows the hottest, longest-lived rows in the pool, which is exactly
    what the rotate wear policy must migrate before the endurance budget
    goes stuck-at. ``quality="high"`` keeps wear-aware admission in the
    loop (HIGH requests steer by slot wear scores)."""
    shared = _draw_tokens(_event_key(seed, n), shared_len, cfg.vocab_size)
    events = []
    for i in range(n):
        k = _event_key(seed, i)
        tail = _draw_tokens(k, tail_len, cfg.vocab_size)
        events.append(TraceEvent(
            rid=i, arrival=i * arrival_every,
            tokens=tuple(shared) + tuple(tail),
            new_tokens=new_tokens, quality=quality, session=i,
            prefix_group=0))
    return _finish(cfg, events, "shared_system_prompt", seed, dict(
        shared_len=shared_len, tail_len=tail_len, new_tokens=new_tokens,
        arrival_every=arrival_every, quality=quality))


PRESETS: Dict[str, Callable[..., Trace]] = {
    "steady": steady,
    "diurnal": diurnal,
    "bursty": bursty,
    "heavy_tail": heavy_tail,
    "chat_batch": chat_batch,
    "shared_system_prompt": shared_system_prompt,
}


def make_workload(preset: str, cfg, n: int, seed: int = 0,
                  **params) -> Trace:
    """Build a trace from a named preset. Unknown preset names list the
    registry in the error (the launcher surfaces this directly)."""
    try:
        fn = PRESETS[preset]
    except KeyError:
        raise ValueError(f"unknown workload preset {preset!r} "
                         f"(available: {', '.join(sorted(PRESETS))})")
    return fn(cfg, n, seed, **params)
