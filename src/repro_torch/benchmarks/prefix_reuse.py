"""Prefix-reuse frontier: cross-request KV write elimination at admission
(the counterpart of ``benchmarks/prefix_reuse.py``).

Two arms over the SAME arrival stream — a 50%-overlap mix where every
other request opens with a shared system prefix (3 whole 8-token chunks,
~75% of its prompt) and the rest are fully unique — once with the
content-addressable prefix cache off and once with it on. The prefix-on
arm links each matched request's leading KV columns to the resident
owner's physical columns, so those columns never drive the stochastic
STT-RAM write: the headline is the **admission write-energy reduction**,
with the mechanism's own costs (CAM search energy, copy-on-write
materializations) charged against it.

Quality: every request's first sampled token comes from the prefill
logits, which do not read the stored cache bits, so it is identical
across arms (asserted per request); linked columns re-expose the owner's
realized write-error pattern instead of drawing a fresh one, so the
realized BER moves only within noise (asserted within tolerance).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.serve import (ContinuousScheduler, Request, ServeConfig,
                               ServingEngine)

#: match granularity (prompt tokens per CAM digest chunk) and the shared
#: prefix depth of the overlap mix: 3 whole chunks
CHUNK = 8
SHARED_TOKENS = 3 * CHUNK


def _randint(seed: int, n: int, vocab: int) -> torch.Tensor:
    return torch.from_numpy(
        rng.randint(rng.PRNGKey(seed), (1, n), 0, vocab).astype(np.int64))


def _mix(cfg, n: int, *, prompt_len: int, shared_new_tokens: int,
         unique_new_tokens: int, arrival_every: int, device,
         seed: int = 7):
    """The 50%-overlap arrival stream (the reference's draws): even rids
    share a SHARED_TOKENS system prefix (unique tails), odd rids are
    fully unique. Shared requests decode longer than unique ones, which
    keeps the current prefix owner resident when the next sharer
    arrives, so every admission's stale slot bits belong to an unrelated
    prompt and the prefix-off arm pays the full admission drive; the
    decode-length and arrival jitter keeps sharers from reusing the slot
    the previous sharer vacated."""
    vocab = cfg.vocab_size
    shared = _randint(seed, SHARED_TOKENS, vocab)
    out = []
    arrival = 0
    for i in range(n):
        if i % 2 == 0:
            tail = _randint(seed + 31 * i + 1, prompt_len - SHARED_TOKENS,
                            vocab)
            toks = torch.cat([shared, tail], dim=1)
            nt = shared_new_tokens + (i * i) % 5
        else:
            toks = _randint(seed + 31 * i + 2, prompt_len, vocab)
            nt = unique_new_tokens + (i * i) % 7
        arrival += arrival_every + (i * 3) % 2
        out.append(Request(rid=i, prompt={"tokens": toks.to(device)},
                           new_tokens=nt, arrival=arrival))
    return out


def _run_arm(prefix: bool, *, n: int, prompt_len: int,
             shared_new_tokens: int, unique_new_tokens: int,
             capacity: int, arrival_every: int, device):
    cfg = get_config("qwen2.5-3b").reduced()
    reqs = _mix(cfg, n, prompt_len=prompt_len,
                shared_new_tokens=shared_new_tokens,
                unique_new_tokens=unique_new_tokens,
                arrival_every=arrival_every, device=device)
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=prompt_len + shared_new_tokens + 8,
        max_new_tokens=shared_new_tokens + 8,
        prefix_cache=prefix, prefix_chunk=CHUNK), device=device)
    return ContinuousScheduler(eng, capacity=capacity).run(reqs)


def run(n: int = 16, prompt_len: int = 26, shared_new_tokens: int = 8,
        unique_new_tokens: int = 3, capacity: int = 6,
        arrival_every: int = 2, device=None):
    dev = resolve_device(device)
    kw = dict(n=n, prompt_len=prompt_len,
              shared_new_tokens=shared_new_tokens,
              unique_new_tokens=unique_new_tokens,
              capacity=capacity, arrival_every=arrival_every)
    off = _run_arm(False, device=dev, **kw)
    on = _run_arm(True, device=dev, **kw)

    # admission write energy: the prefill stream, plus what the prefix
    # mechanism itself spent (CoW materializations; CAM search is
    # reported separately and subtracted from the net ledger)
    e_off = off["streams"]["kv_prefill"]["energy_pj"]
    e_on = (on["streams"]["kv_prefill"]["energy_pj"]
            + on["streams"].get("kv_prefix_cow",
                                {"energy_pj": 0.0})["energy_pj"])
    reduction = 1.0 - e_on / e_off
    p = on["prefix"]

    first_tok_identical = all(
        off["requests"][r]["tokens"][0] == on["requests"][r]["tokens"][0]
        for r in off["requests"])
    ber_off = off["total"]["ber_realized"]
    ber_on = on["total"]["ber_realized"]
    ber_rel_delta = abs(ber_on - ber_off) / max(ber_off, 1e-12)

    out = {
        "workload": {**kw, "shared_tokens": SHARED_TOKENS,
                     "chunk": CHUNK,
                     "overlap_requests_frac": 0.5,
                     "shared_prompt_frac": SHARED_TOKENS / prompt_len},
        "admission_energy_off_pj": e_off,
        "admission_energy_on_pj": e_on,
        "admission_energy_reduction": reduction,
        "prefix": p,
        "ber_off": ber_off,
        "ber_on": ber_on,
        "ber_rel_delta": ber_rel_delta,
        "claims": {
            "admission_energy_reduction_ge_30pct": reduction >= 0.30,
            "first_token_identical": first_tok_identical,
            "ber_within_noise": ber_rel_delta <= 0.25,
            "prefix_hits_ge_1": p["hits"] >= 1,
        },
    }
    for name, ok in out["claims"].items():
        assert ok, (name, out)
    return out


def bench_metrics(out) -> dict:
    return {
        "admission_energy_reduction": out["admission_energy_reduction"],
        "admission_energy_off_pj": out["admission_energy_off_pj"],
        "admission_energy_on_pj": out["admission_energy_on_pj"],
        "prefix_hit_rate": out["prefix"]["hit_rate"],
        "linked_admissions": float(out["prefix"]["linked_admissions"]),
        "linked_cols": float(out["prefix"]["linked_cols"]),
        "write_energy_saved_pj": out["prefix"]["write_energy_saved_pj"],
        "cow_energy_pj": out["prefix"]["cow_energy_pj"],
        "cam_energy_pj": out["prefix"]["cam_energy_pj"],
        "net_energy_saved_pj": out["prefix"]["net_energy_saved_pj"],
        "ber_rel_delta": out["ber_rel_delta"],
        "reduction_ge_30pct":
            out["claims"]["admission_energy_reduction_ge_30pct"],
    }
