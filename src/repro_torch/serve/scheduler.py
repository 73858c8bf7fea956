"""Continuous-batching request scheduler over the slot-pool KV cache.

The counterpart of ``repro.serve.scheduler`` for the greedy, extent-only
path of the ported families (dense, hybrid): admission groups (one fused
prefill per prompt shape), decode bursts up to the next scheduler event
(earliest completion or next arrival), per-request quality resolved
through the ``ExtentTable`` with the pool-wide floor ``max(policy,
strictest active hint)``, and the serve report. Scheduling is
host-predictable, so decisions never read the device; token fragments
stay lazy device references until completion, and the device is read
once per event (completions) and once at the end.

With retention on (``ServeConfig.retention_scale > 0``) the scheduler
owns the run's ``LifetimeState``: admissions clear the admitted rows'
decay masks, bursts advance the decay (ending at every breakpoint of an
optional ambient-temperature schedule), and after each burst a host-side
scrub policy may run one corrective pass whose energy goes to the
``kv_scrub`` stream; the report gains the lifetime ledger.

Prefix linking, wear, telemetry and sharding are later slices.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.energy_model import StepEnergyMeter
from repro_torch.core.priority import Priority
from repro_torch.memory import WriteStats, rng_streams
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.slots import SlotPool


@dataclasses.dataclass
class Request:
    """One serving request: ``prompt`` is the batch dict with a leading
    batch dim of 1; ``new_tokens`` counts every generated token (the
    prefill-sampled first one included); ``arrival`` is in decode steps."""
    rid: int
    prompt: Dict[str, torch.Tensor]
    new_tokens: int
    arrival: int = 0
    app_id: Optional[Hashable] = None
    quality: Optional[Priority] = None
    session: Optional[int] = None


def synthetic_requests(cfg, n: int, *, device, prompt_len: int = 12,
                       new_tokens: int = 8, arrival_every: int = 0,
                       seed: int = 0, app_ids: Sequence = (),
                       qualities: Sequence = ()) -> List[Request]:
    """Deterministic random-token arrival stream. Prompts are drawn with
    numpy from ``seed + 17 * i`` — not JAX's ``randint``, so they differ
    from the reference's synthetic stream (replay a trace for parity)."""
    out = []
    for i in range(n):
        toks = np.random.default_rng(seed + 17 * i).integers(
            0, cfg.vocab_size, (1, prompt_len))
        out.append(Request(
            rid=i, prompt={"tokens": torch.from_numpy(toks).to(device)},
            new_tokens=new_tokens, arrival=i * arrival_every,
            app_id=app_ids[i % len(app_ids)] if app_ids else None,
            quality=qualities[i % len(qualities)] if qualities else None,
            session=i))
    return out


class ArrivalQueue:
    """The materialized-list arrival source: ``next_arrival`` /
    ``popleft`` / truthiness, in (arrival, rid) order."""

    def __init__(self, requests: Sequence[Request]):
        self._q = collections.deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))

    def __bool__(self) -> bool:
        return bool(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def next_arrival(self) -> Optional[int]:
        return self._q[0].arrival if self._q else None

    def popleft(self) -> Request:
        return self._q.popleft()


def as_arrival_source(requests) -> Any:
    if hasattr(requests, "next_arrival") and hasattr(requests, "popleft"):
        return requests
    return ArrivalQueue(requests)


def _prompt_signature(prompt: Dict[str, torch.Tensor]) -> Tuple:
    return tuple(sorted((k, tuple(v.shape[1:]), str(v.dtype))
                        for k, v in prompt.items()))


def _stack_prompts(requests: Sequence[Request]) -> Dict[str, torch.Tensor]:
    return {k: torch.cat([r.prompt[k] for r in requests], dim=0)
            for k in requests[0].prompt}


class ContinuousScheduler:
    """Admission/completion loop over one engine's slot pool."""

    def __init__(self, engine: ServingEngine, capacity: int,
                 scrub_policy: Optional[Any] = None,
                 ambient_schedule: Optional[Sequence[Tuple[int, float]]]
                 = None):
        assert capacity >= 1
        self.eng = engine
        self.scrub_policy = scrub_policy
        #: piecewise-constant (step, kelvin) ambient overrides
        self.ambient_schedule = (sorted(ambient_schedule)
                                 if ambient_schedule else None)
        self.life = None  # LifetimeState, owned per run()
        self.pool = SlotPool(engine.api, capacity, engine.scfg.max_seq,
                             engine.device)
        self.meter = StepEnergyMeter()
        self._tokens: Dict[int, List[Tuple[torch.Tensor, int, int]]] = {}
        self._remaining: Dict[int, int] = {}
        self._admitted: Dict[int, int] = {}
        self._level: Dict[int, Priority] = {}
        self._reports: Dict[int, Dict[str, Any]] = {}

    def _resolve_quality(self, r: Request) -> Priority:
        """Admission-time handshake through the EXTENT table; requests
        with neither an app block nor a hint skip the table."""
        if r.app_id is None and r.quality is None:
            return Priority.LOW
        block = r.app_id if r.app_id is not None else ("rid", r.rid)
        return self.eng.controller.resolve_request(block, hint=r.quality)

    def _floor(self) -> Priority:
        """Strictest quality level among active slots."""
        floor = Priority.LOW
        for r in self.pool.slot_req:
            if r is not None:
                floor = max(floor, self._level[r.rid])
        return Priority(floor)

    def _admit(self, pending, clock: int, key) -> Tuple[Any, int]:
        """Admit every arrived request that fits, one fused prefill per
        prompt-shape group. Returns (key, immediate completions)."""
        admissible: List[Request] = []
        while len(admissible) < self.pool.free_slots():
            nxt = pending.next_arrival()
            if nxt is None or nxt > clock:
                break
            admissible.append(pending.popleft())
        if not admissible:
            return key, 0
        groups: Dict[Tuple, List[Request]] = collections.OrderedDict()
        for r in admissible:
            groups.setdefault(_prompt_signature(r.prompt), []).append(r)
        n_done = 0
        for group in groups.values():
            for r in group:
                self._level[r.rid] = self._resolve_quality(r)
            ids = self.pool.alloc(len(group))
            vectors = self.eng.vectors_for_floor(
                max(self._floor(), max(self._level[r.rid] for r in group)))
            batch = _stack_prompts(group)
            old_rows = self.pool.extract_rows(ids)
            pos0 = [self.eng.prompt_len(r.prompt) for r in group]
            tok, rows, key, acc = self.eng.prefill(
                self.eng.params, batch, old_rows, key, vectors)
            self._acc_prefill = self.pool.admit(
                ids, group, rows, tok, pos0, acc, self._acc_prefill)
            if self.life is not None:
                # the admitted rows were just prefill-written: their
                # decay record restarts from zero
                self.life = self.eng.life_plan.reset_rows(
                    self.life, self.pool.index(ids))
            for j, r in enumerate(group):
                self._tokens[r.rid] = [(tok, j, 1)]
                self._remaining[r.rid] = r.new_tokens - 1
                self._admitted[r.rid] = clock
            n_done += self._complete(clock)
        return key, n_done

    # ----------------------------------------------------------- reliability
    def _ambient_at(self, clock: int) -> Optional[float]:
        """Ambient schedule lookup (None = the engine's configured
        ambient)."""
        if not self.ambient_schedule:
            return None
        t = None
        for step, kelvin in self.ambient_schedule:
            if step <= clock:
                t = kelvin
        return t

    def _retention_vectors(self, clock: int) -> Tuple:
        """Decay thresholds for the burst starting at ``clock``."""
        return self.eng.retention_vectors_for(
            self._floor(), ambient_k=self._ambient_at(clock))

    def _maybe_scrub(self, clock: int, key) -> None:
        """Idle-slot background scrubbing: when the host-side policy says a
        pass is due, re-write the accumulated decay through the engine's
        backend. The pass key folds the pass index off the carried decode
        key, which the pass does not advance."""
        eng, policy = self.eng, self.scrub_policy
        if policy is None or self.life is None:
            return
        enabled = policy.plan_pass(clock, eng.plan.leaf_levels,
                                   idle=self.pool.free_slots() > 0)
        if enabled is None:
            return
        # the scrub re-resolves the quality of the blocks it re-writes
        # through the table, in its own "scrub" scope so it never
        # inflates the serve hit rate
        floor = Priority.LOW
        with eng.controller.table.scope("scrub"):
            for i in self.pool.occupied():
                r = self.pool.slot_req[i]
                if r.app_id is not None or r.quality is not None:
                    block = (r.app_id if r.app_id is not None
                             else ("rid", r.rid))
                    floor = max(floor, eng.controller.resolve_request(block))
        cols = policy.cols_per_pass or None
        k = rng.fold_in(key, rng_streams.SCHEDULER_SCRUB_PASS_OFFSET
                        + self._scrub_passes)
        self.pool.cache, self.life, st = eng.scrub(
            k, self.pool.cache, self.life,
            eng.vectors_for_floor(Priority(floor)), enabled=enabled,
            cols=cols, cursor=self._scrub_cursor)
        self._acc_scrub = self._acc_scrub + st
        policy.record(clock)
        self._scrub_passes += 1
        if cols:
            self._scrub_cursor = (self._scrub_cursor + cols) % \
                eng.scfg.max_seq

    def _materialize_tokens(self, rid: int,
                            memo: Dict[int, np.ndarray]) -> List[int]:
        out: List[int] = []
        for arr, col, take in self._tokens[rid]:
            a = memo.get(id(arr))
            if a is None:
                a = memo[id(arr)] = arr.cpu().numpy()
            if a.ndim == 1:
                out.append(int(a[col]))
            else:
                out.extend(int(t) for t in a[:take, col])
        return out

    def _complete(self, clock: int) -> int:
        """Retire every slot whose budget is spent (one small transfer per
        event)."""
        done = [i for i in self.pool.occupied()
                if self._remaining[self.pool.slot_req[i].rid] == 0]
        if not done:
            return 0
        keys = list(self.pool.slot_acc)
        rows = torch.stack([self.pool.slot_acc[k] for k in keys]).cpu()
        slot_host = dict(zip(keys, rows.numpy()))
        memo: Dict[int, np.ndarray] = {}
        for i in done:
            r = self.pool.slot_req[i]
            flips = float(slot_host["flips"][i])
            errors = float(slot_host["errors"][i])
            toks = self._materialize_tokens(r.rid, memo)
            self._reports[r.rid] = {
                "rid": r.rid, "slot": i, "app_id": r.app_id,
                "quality": self._level[r.rid].name,
                "tokens": toks, "n_tokens": len(toks),
                "arrival_step": r.arrival,
                "admitted_step": self._admitted[r.rid],
                "completed_step": clock,
                "queue_steps": self._admitted[r.rid] - r.arrival,
                "latency_steps": clock - r.arrival,
                "energy_pj": float(slot_host["energy_pj"][i]),
                "flips": flips, "errors": errors,
                "ber": errors / max(flips, 1.0),
            }
            del self._tokens[r.rid]
            del self._remaining[r.rid], self._admitted[r.rid]
        self.pool.release(done)
        return len(done)

    def run(self, requests) -> Dict[str, Any]:
        """Serve an arrival stream (a request list or any arrival source,
        e.g. ``workload.replay.TraceSource``) to completion; returns the
        serve report."""
        eng, pool = self.eng, self.pool
        pending = as_arrival_source(requests)
        key = rng.PRNGKey(eng.scfg.seed + 1)
        clock = decode_steps = bursts = 0
        self._acc_prefill = WriteStats.zero(eng.device)
        self._acc_decode = WriteStats.zero(eng.device)
        self._acc_scrub = WriteStats.zero(eng.device)
        self._scrub_passes = 0
        self._scrub_cursor = 0
        if self.scrub_policy is not None:
            self.scrub_policy.reset()  # the serving clock restarts at 0
        self.life = (eng.life_plan.init_state(pool.cache)
                     if eng.life_plan is not None else None)
        eng.controller.table.reset_stats()
        while pending or pool.busy():
            nxt = pending.next_arrival()
            if (not pool.busy()) and nxt is not None and nxt > clock:
                clock = nxt
            while True:
                key, n_done = self._admit(pending, clock, key)
                nxt = pending.next_arrival()
                if not (n_done and nxt is not None and nxt <= clock
                        and pool.free_slots()):
                    break
            if not pool.busy():
                continue
            active_ids = pool.occupied()
            n = min(self._remaining[pool.slot_req[i].rid]
                    for i in active_ids)
            nxt = pending.next_arrival()
            if nxt is not None and nxt > clock:
                n = min(n, nxt - clock)
            if self.ambient_schedule and self.life is not None:
                # an ambient breakpoint ends the burst: the decay
                # thresholds are per-burst operands
                for step, _ in self.ambient_schedule:
                    if step > clock:
                        n = min(n, step - clock)
                        break
            n = max(int(n), 1)
            active = pool.active_mask()
            vectors = eng.vectors_for_floor(self._floor())
            rvec = (self._retention_vectors(clock)
                    if self.life is not None else None)
            (pool.tok, pool.cache, pool.pos, key, self._acc_decode,
             pool.slot_acc, self.life, toks) = eng.burst(
                eng.params, pool.tok, pool.cache, pool.pos, key,
                self._acc_decode, pool.slot_acc, active, vectors,
                self.life, rvec, n=n)
            for i in active_ids:
                rid = pool.slot_req[i].rid
                take = min(n, self._remaining[rid])
                self._tokens[rid].append((toks, i, take))
                self._remaining[rid] -= take
            clock += n
            decode_steps += n
            bursts += 1
            self._complete(clock)
            self._maybe_scrub(clock, key)
        pre_host = self._acc_prefill.host_dict()
        dec_host = self._acc_decode.host_dict()
        self.meter.add_stream("kv_prefill", pre_host)
        self.meter.add_stream("kv_decode", dec_host)
        if self.life is not None:
            scrub_host = self._acc_scrub.host_dict()
            self.meter.add_stream("kv_scrub", scrub_host)
        summary = self.meter.summary()
        summary.update({
            "requests": self._reports,
            "clock_steps": clock,
            "decode_steps": decode_steps,
            "bursts": bursts,
            "pool": pool.stats(),
            "extent_table": eng.controller.table.stats(),
        })
        if self.life is not None:
            # the lifetime ledger: write energy plus the scrub energy spent
            # defending it, and the decay that slipped through
            flips, decayed = torch.stack([self.life.retention_flips,
                                          self.life.decayed_bits()]).tolist()
            write_pj = pre_host["energy_pj"] + dec_host["energy_pj"]
            scrub_pj = scrub_host["energy_pj"]
            remap_pj = 0.0  # wear leveling is a later slice
            summary["lifetime"] = {
                "ambient_k": eng.scfg.ambient_k,
                "dwell_s_per_step": eng.scfg.retention_scale,
                "write_energy_pj": write_pj,
                "scrub_energy_pj": scrub_pj,
                "remap_energy_pj": remap_pj,
                "lifetime_energy_pj": write_pj + scrub_pj + remap_pj,
                "retention_flips": int(flips),
                "residual_decayed_bits": int(decayed),
                "scrub_passes": self._scrub_passes,
                "scrub_policy": (self.scrub_policy.name
                                 if self.scrub_policy else "none"),
            }
        return summary
