"""Continuous-batching request scheduler over the slot-pool KV cache.

The counterpart of ``repro.serve.scheduler`` for the extent path of the
ported families (dense, moe, hybrid): admission groups (one fused
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

With the prefix cache on (``ServeConfig.prefix_cache``) admission reads
each prompt on the host once, matches its chunk digests against the CAM
(``serve.prefix``), keeps the match owners out of allocation, makes room
by copy-on-write detaching link-blocked free slots, splices the owners'
resident columns into the old rows and writes with those columns
aliased; linked slots inherit the owner's decay record, and the report
gains the ``kv_prefix_cow`` stream and a ``prefix`` section.

With the addressing layer on (a wear policy or an endurance budget on
the engine) the scheduler owns the run's ``AddressState``: bursts and
scrub passes take its remap shifts as device operands, and every
``check_interval`` steps one wear checkpoint reads the (L, G) row-group
counters and the per-slot placement scores in one transfer — the one
sync the layer adds — and asks the wear policy whether to rotate. A
rotation advances the shifts and books the start-gap migration write to
the ``kv_remap`` stream and its row re-writes to the wear counters.
HIGH-quality admissions are steered to slots with the lowest scores of
the last checkpoint; the prefix cache's linked admissions and
copy-on-writes book their column drives as wear (prefix-off runs book
decode columns only, as the reference does). ``wear_state()`` and
``run(..., wear_state=)`` carry the map and the counters across runs.
The report gains the ``kv_remap`` stream and a ``wear`` section.

With ``telemetry=`` (a ``repro_torch.telemetry.Telemetry``) the loop
records the reference's spans and instruments at the same places: a
request tree (queue, prefill, decode bursts) per request, the pool's
burst spans, and scrub, wear-checkpoint, rotation and copy-on-write
spans on the background lane, with one drain per scheduler event. The
device values (the ``WriteStats`` accumulators, retention flips, burst
energy deltas as ``Lazy`` args) are captured as references and land at
the end of the run in one transfer; every gauge and host arg comes from
host state. ``telemetry=None`` adds nothing to the loop.

With ``ServeConfig.shards`` > 1 the pool spans that many dies
(``repro_torch.sharding.DieMesh``) over the slot axis, served by the
same full-pool bursts. ``die_ambients`` (``{die: kelvin}``) override the
ambient per die: divergent ambients decay each slot at its die's
temperature (per-slot threshold rows), give every die hotter than the
coolest one extra die-masked scrub pass per pass, and steer HIGH-quality
admissions to cool and little-worn dies. With the dies alike all of it
collapses to the 1-die run, bit for bit. The report gains a
``sharding`` section (per-die energy, flips, errors, scrub passes,
decayed bits and wear).
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
from repro_torch.memory import AddressState, WriteStats, rng_streams
from repro_torch.reliability.scrub import scrub_span_args
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.prefix import PrefixCache, PrefixConfig, PrefixMatch
from repro_torch.serve.slots import SlotPool
from repro_torch.sharding import DieMesh, uniform
from repro_torch.telemetry import LANE_BACKGROUND, Lazy, Telemetry


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
    """Deterministic random-token arrival stream, the reference's: prompt
    ``i`` is ``randint(PRNGKey(seed + 17 * i), (1, prompt_len), 0,
    vocab)`` (the host threefry draw). ``arrival_every=k`` staggers
    arrivals k decode steps apart (0 = all at once); ``app_ids`` /
    ``qualities`` cycle over the requests when non-empty."""
    out = []
    for i in range(n):
        toks = rng.randint(rng.PRNGKey(seed + 17 * i), (1, prompt_len), 0,
                           cfg.vocab_size)
        out.append(Request(
            rid=i, prompt={"tokens": torch.from_numpy(
                toks.astype(np.int64)).to(device)},
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
                 = None,
                 wear_policy: Optional[Any] = None,
                 telemetry: Optional[Telemetry] = None,
                 die_ambients: Optional[Dict[int, float]] = None):
        assert capacity >= 1
        self.eng = engine
        self.scrub_policy = scrub_policy
        self.wear_policy = wear_policy
        #: None = telemetry off: no instrument, span or drain anywhere
        self.tele = telemetry
        #: piecewise-constant (step, kelvin) ambient overrides
        self.ambient_schedule = (sorted(ambient_schedule)
                                 if ambient_schedule else None)
        self.life = None  # LifetimeState, owned per run()
        self.addr: Optional[AddressState] = None  # remap shifts, per run()
        self.pool = SlotPool(engine.api, capacity, engine.scfg.max_seq,
                             engine.device)
        self.mesh = DieMesh(n_dies=max(1, engine.scfg.shards),
                            capacity=capacity)
        #: per-die ambient overrides (kelvin) on top of the global one
        self.die_ambients: Dict[int, float] = dict(die_ambients or {})
        assert all(0 <= d < self.mesh.n_dies for d in self.die_ambients)
        if self.mesh.n_dies > 1:
            # every die lives on the one card (DieMesh.shard_slots is an
            # identity): the pool only learns its per-die slot ranges
            self.pool.mesh = self.mesh
        #: None = prefix cache off: every admission takes the plain path
        self.prefix: Optional[PrefixCache] = None
        if engine.scfg.prefix_cache:
            self.prefix = PrefixCache(PrefixConfig(
                chunk=engine.scfg.prefix_chunk,
                table_size=engine.scfg.prefix_table_size))
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

    # ----------------------------------------------------------- telemetry
    def _bind_telemetry(self) -> None:
        """Bind the registry's device metrics to the run's accumulators
        (references, rebuilt by ``+`` and never written in place, so a
        drain pins its event's values; tuple parts sum on the host)."""
        ins = self.tele.instruments
        ins.bind("serve_prefill_energy_pj_total",
                 lambda: self._acc_prefill.energy_pj)
        ins.bind("serve_decode_energy_pj_total",
                 lambda: self._acc_decode.energy_pj)
        ins.bind("serve_scrub_energy_pj_total",
                 lambda: self._acc_scrub.energy_pj)
        ins.bind("serve_remap_energy_pj_total",
                 lambda: self._acc_remap.energy_pj)
        ins.bind("serve_flips_total",
                 lambda: (self._acc_prefill.flips01,
                          self._acc_prefill.flips10,
                          self._acc_decode.flips01,
                          self._acc_decode.flips10))
        ins.bind("serve_bit_errors_total",
                 lambda: (self._acc_prefill.errors,
                          self._acc_decode.errors))
        if self.eng.life_plan is not None:
            ins.bind("serve_retention_flips_total",
                     lambda: self.life.retention_flips)

    def _event_gauges(self, clock: int, pending) -> Dict[str, float]:
        """The event's gauges, all host state."""
        ambient = self._ambient_at(clock)
        return {
            **self.pool.telemetry_gauges(),
            "serve_queue_depth": len(pending),
            "serve_ambient_k": (ambient if ambient is not None
                                else self.eng.scfg.ambient_k),
        }

    def _req_track(self, rid: int) -> str:
        return f"req {rid}"

    # ---------------------------------------------------------- prefix cache
    def _resolve_prefix(self, group: Sequence[Request]
                        ) -> Tuple[List[Optional[PrefixMatch]], List[Any]]:
        """Match every member's prompt prefix against the CAM. Returns
        (matches, signature chains), aligned with ``group``. A match names
        a slot whose resident leading columns hold what this request's
        prefill would store there (same prefix, causal attention)."""
        matches: List[Optional[PrefixMatch]] = []
        sigs: List[Any] = []
        for r in group:
            # the one host read of the prompt, at admission
            host_prompt = {k: v.cpu().numpy() for k, v in r.prompt.items()}
            s = self.prefix.signatures(host_prompt)
            sigs.append(s)
            matches.append(self.prefix.lookup(
                s, valid=lambda slot, gen:
                    self.pool.generation[slot] == gen,
                max_cols=self.eng.prompt_len(r.prompt)))
        return matches, sigs

    def _cow_owner(self, owner: int, clock: int) -> None:
        """Copy-on-write detach of every linker of ``owner``: each
        linker's columns are now really driven, booked at the price the
        link was credited (``WritePlan.alias_saving``)."""
        for linker, cols in self.pool.cow_detach(owner):
            pj, bits = self.eng.plan.alias_saving(self.pool.cache, cols)
            self._acc_cow = self._acc_cow + WriteStats.for_bits(
                bits, self.eng.device, energy_pj=torch.tensor(
                    pj, dtype=torch.float32, device=self.eng.device))
            self._cow_events += 1
            if self.tele is not None:
                self.tele.instruments.inc("serve_cow_events_total")
                self.tele.tracer.complete(
                    "cow_detach", clock, clock, lane=LANE_BACKGROUND,
                    track="prefix", cat="prefix", owner=owner,
                    linker=linker, cols=cols, energy_pj=pj)
            if self.eng.wear:
                # the detached linker's columns are now its own drives
                self.life = self.eng.life_plan.record_admission_write(
                    self.life, self.pool.cache, self.pool.index([linker]),
                    self.pool.index([0]), self.pool.index([cols]),
                    self.addr.shifts)

    def _make_room(self, n: int, matches: List[Optional[PrefixMatch]],
                   exclude: set, clock: int) -> None:
        """Guarantee ``n`` allocatable slots: first CoW link-blocked free
        slots (lowest id first), then drop matches whose owner exclusion
        starves capacity."""
        while self.pool.allocatable(exclude) < n:
            blocked = [i for i in self.pool.blocked_free()
                       if i not in exclude]
            if blocked:
                self._cow_owner(blocked[0], clock)
                continue
            dropped = False
            for j, m in enumerate(matches):
                if m is None:
                    continue
                matches[j] = None
                if (m.slot in exclude and not any(
                        mm is not None and mm.slot == m.slot
                        for mm in matches)):
                    exclude.discard(m.slot)
                    if (self.pool.col_refs[m.slot] > 0
                            and self.pool.slot_req[m.slot] is None):
                        self._cow_owner(m.slot, clock)  # free, blocked
                dropped = True
                break
            assert dropped, (n, sorted(exclude))

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
            # prefix resolution: match, keep the owners out of allocation
            # (linking to a slot about to be overwritten defeats itself),
            # then CoW or drop matches until the group fits
            matches: List[Optional[PrefixMatch]] = [None] * len(group)
            sigs: List[Any] = []
            exclude: set = set()
            if self.prefix is not None:
                matches, sigs = self._resolve_prefix(group)
                exclude = {m.slot for m in matches if m is not None}
                self._make_room(len(group), matches, exclude, clock)
            # wear-aware admission: HIGH-quality requests steer away from
            # slots backed by worn or decayed rows (the last wear
            # checkpoint's scores, no read here) and, once the dies are
            # observably unequal, toward cool and little-worn dies;
            # others keep the lowest-id order
            scores = None
            high = max(self._level[r.rid] for r in group) >= Priority.HIGH
            if high:
                scores = self._slot_scores_host
                bias = self._die_bias(clock)
                if bias is not None:
                    scores = bias if scores is None else scores + bias
            ids = self.pool.alloc(len(group), scores=scores,
                                  exclude=sorted(exclude))
            vectors = self.eng.vectors_for_floor(
                max(self._floor(), max(self._level[r.rid] for r in group)))
            batch = _stack_prompts(group)
            old_rows = self.pool.extract_rows(ids)
            pos0 = [self.eng.prompt_len(r.prompt) for r in group]
            linked = any(m is not None for m in matches)
            if linked:
                # splice the owners' resident prefix columns into the old
                # rows, then write with them aliased: zero energy and
                # zero WER exposure there; same split schedule
                owner_ids = [m.slot if m is not None else ids[j]
                             for j, m in enumerate(matches)]
                alias = self.pool.index([m.cols if m is not None else 0
                                         for m in matches])
                old_rows = self.eng.splice_rows(
                    old_rows, self.pool.extract_rows(owner_ids), alias)
                tok, rows, key, acc = self.eng.prefill(
                    self.eng.params, batch, old_rows, key, vectors,
                    alias_cols=alias)
            else:
                tok, rows, key, acc = self.eng.prefill(
                    self.eng.params, batch, old_rows, key, vectors)
            self._acc_prefill = self.pool.admit(
                ids, group, rows, tok, pos0, acc, self._acc_prefill)
            if self.life is not None:
                # the admitted rows were just prefill-written: their
                # decay record restarts from zero, except linked columns,
                # which carry the owner's stored bits and decay record
                idx = self.pool.index(ids)
                self.life = (
                    self.eng.life_plan.reset_rows_linked(
                        self.life, idx, self.pool.index(owner_ids), alias)
                    if linked else
                    self.eng.life_plan.reset_rows(self.life, idx))
                if self.prefix is not None and self.eng.wear:
                    # the prompt window's row drives, minus the linked
                    # columns: shared columns wear once, at their owner
                    self.life = self.eng.life_plan.record_admission_write(
                        self.life, self.pool.cache, idx,
                        alias if linked else self.pool.index(
                            [0] * len(group)),
                        self.pool.index(pos0), self.addr.shifts)
            if self.prefix is not None:
                for j, r in enumerate(group):
                    m = matches[j]
                    if m is not None:
                        self.pool.link(ids[j], m.slot, m.cols)
                        pj, bits = self.eng.plan.alias_saving(
                            self.pool.cache, m.cols)
                        self._saved_pj += pj
                        self._saved_bits += bits
                        self._linked_admissions += 1
                        self._linked_cols += m.cols
                    self.prefix.insert(
                        sigs[j], ids[j], self.pool.generation[ids[j]],
                        col_offset=pos0[j] - r.prompt["tokens"].shape[1])
            for j, r in enumerate(group):
                self._tokens[r.rid] = [(tok, j, 1)]
                self._remaining[r.rid] = r.new_tokens - 1
                self._admitted[r.rid] = clock
            if self.tele is not None:
                self._trace_admission(group, ids, matches, acc, clock)
            n_done += self._complete(clock)
        return key, n_done

    def _trace_admission(self, group, ids, matches, acc, clock) -> None:
        """Each admitted request's span tree: the root (arrival to
        completion) with its queue and prefill children. The prefill's
        energy is the group write's even split, a ``Lazy`` of the
        group's device energy."""
        tele = self.tele
        tele.instruments.inc("serve_admissions_total", len(group))
        share = Lazy(lambda e, k=len(group): e / k, acc.energy_pj)
        for j, r in enumerate(group):
            track = self._req_track(r.rid)
            root = tele.tracer.begin(
                f"req {r.rid}", r.arrival, track=track, cat="request",
                rid=r.rid, app_id=str(r.app_id),
                quality=self._level[r.rid].name)
            self._req_span[r.rid] = root
            tele.tracer.complete("queue", r.arrival, clock, track=track,
                                 cat="request", parent=root)
            m = matches[j]
            pargs = dict(group=len(group), slot=ids[j], energy_pj=share)
            if m is not None:
                tele.instruments.inc("serve_prefix_linked_total")
                pargs.update(m.span_args())
            tele.tracer.complete("prefill", clock, clock, track=track,
                                 cat="prefill", parent=root, **pargs)

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

    def _die_ambients_at(self, clock: int) -> Tuple[float, ...]:
        """Per-die ambients at ``clock``: the global schedule or
        configured ambient, overridden per die by ``die_ambients``."""
        base = self._ambient_at(clock)
        if base is None:
            base = self.eng.scfg.ambient_k
        return tuple(self.die_ambients.get(d, float(base))
                     for d in range(self.mesh.n_dies))

    def _retention_vectors(self, clock: int) -> Tuple:
        """Decay thresholds for the burst starting at ``clock``: the
        pool-wide ones while every die sits at one temperature, per-slot
        rows once the die ambients diverge."""
        amb = self._die_ambients_at(clock)
        if not uniform(amb):
            return self.eng.retention_vectors_for_dies(
                self._floor(), amb, self.mesh.slots_per_die)
        return self.eng.retention_vectors_for(
            self._floor(), ambient_k=self._ambient_at(clock))

    def _die_bias(self, clock: int) -> Optional[np.ndarray]:
        """(capacity,) admission score bias steering HIGH-quality requests
        to cool, little-worn dies (higher = a worse home, as
        ``SlotPool.alloc`` reads scores): each die's kelvin above the
        coolest die's plus its last wear checkpoint's peak group wear
        above the healthiest die's. None while the dies' ambients are
        alike, so such runs keep the 1-die admission order."""
        if self.mesh.n_dies <= 1:
            return None
        amb = self._die_ambients_at(clock)
        if uniform(amb):
            return None
        per_die = np.asarray(amb, np.float64) - min(amb)
        if self._die_wear_host is not None:
            per_die = per_die + (self._die_wear_host
                                 - self._die_wear_host.min())
        return self.mesh.per_slot(per_die)

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
        vectors = eng.vectors_for_floor(Priority(floor))
        shifts = None if self.addr is None else self.addr.shifts

        def scrub_pass(slot_mask=None):
            # the pass key folds the pass index off the decode key; with
            # wear on the cursor walks physical rows through the current
            # shifts, and worn rows keep their decay
            k = rng.fold_in(key, rng_streams.SCHEDULER_SCRUB_PASS_OFFSET
                            + self._scrub_passes)
            self.pool.cache, self.life, st = eng.scrub(
                k, self.pool.cache, self.life, vectors, enabled=enabled,
                cols=cols, cursor=self._scrub_cursor, shifts=shifts,
                slot_mask=slot_mask)
            self._acc_scrub = self._acc_scrub + st
            self._scrub_passes += 1
            return st

        st = scrub_pass()
        if self.tele is not None:
            # scrub interference on the background lane, over the same
            # clock; the pass energy stays a device ref until finalize
            self.tele.instruments.inc("serve_scrub_passes_total")
            self.tele.tracer.complete(
                "scrub_pass", clock, clock, lane=LANE_BACKGROUND,
                track="scrub", cat="reliability",
                **scrub_span_args(
                    st, policy, cols=cols or 0, floor=Priority(floor),
                    resident=[self.pool.slot_req[i].rid
                              for i in self.pool.occupied()]))
        policy.record(clock)
        for d in range(self.mesh.n_dies):
            self._die_scrub_passes[d] += 1
        # per-die cadence: a die hotter than the coolest decays faster
        # and earns one extra pass over its own slots (out-of-die slots
        # held out at zero energy); with alike ambients this never runs
        amb = self._die_ambients_at(clock)
        if not uniform(amb):
            for d, t in enumerate(amb):
                if t > min(amb):
                    scrub_pass(self.mesh.slot_mask(d, eng.device))
                    self._die_scrub_passes[d] += 1
        if cols:
            self._scrub_cursor = (self._scrub_cursor + cols) % \
                eng.scfg.max_seq

    # ------------------------------------------------------- wear leveling
    def _remap_stats(self) -> WriteStats:
        """One rotation's migration write as a WriteStats increment (host
        constants resolved once per run: ``ServingEngine.remap_cost``)."""
        if self._remap_cost is None:
            self._remap_cost = self.eng.remap_cost(self.pool.cache)
        pj, bits = self._remap_cost
        return WriteStats.for_bits(
            bits, self.eng.device, energy_pj=torch.tensor(
                pj, dtype=torch.float32, device=self.eng.device))

    def _maybe_wear_check(self, clock: int) -> None:
        """Periodic wear checkpoint: read the (L, G) row-group counters
        and the per-slot placement scores in one transfer (the one sync
        of this layer, every ``check_interval`` steps), then ask the wear
        policy whether to rotate. A rotation advances the shifts (device
        operands of the bursts and scrubs), books the start-gap
        migration to the ``kv_remap`` stream and its row re-writes to
        the wear counters."""
        eng, pol = self.eng, self.wear_policy
        if not eng.wear:
            return
        interval = pol.check_interval if pol is not None else 16
        if clock - self._last_wear_check < max(1, interval):
            return
        self._last_wear_check = clock
        wear, self._slot_scores_host = self.read_wear()
        if self.mesh.n_dies > 1:
            # per-die health from the same read: each die's peak
            # row-group wear
            self._die_wear_host = self.mesh.reduce_wear(wear)
        if self.tele is not None:
            self.tele.tracer.complete(
                "wear_check", clock, clock, lane=LANE_BACKGROUND,
                track="wear", cat="reliability",
                max_group_wear=int(wear.max()))
        if pol is not None and pol.plan_rotation(clock, wear):
            self.addr = self.addr.rotate(self._rotatable, pol.rotate_step)
            self._acc_remap = self._acc_remap + self._remap_stats()
            # the migration's row re-writes wear the rows it lands on
            self.life = eng.life_plan.record_migration(
                self.life, self.pool.cache, self._gap_host,
                pol.rotate_step)
            self._gap_host += pol.rotate_step
            pol.record(clock, wear)
            if self.tele is not None:
                self.tele.instruments.inc("serve_wear_rotations_total")
                self.tele.tracer.complete(
                    "remap_rotation", clock, clock, lane=LANE_BACKGROUND,
                    track="wear", cat="reliability",
                    rotate_step=pol.rotate_step,
                    migration_energy_pj=float(self._remap_cost[0]))

    def read_wear(self) -> Tuple[np.ndarray, np.ndarray]:
        """The wear checkpoint's one device read: the (L, G) row-group
        wear (int64) and the (B,) slot placement scores (float32), as
        host arrays, in one transfer (float64 holds both exactly)."""
        wear = self.life.row_wear()
        flat = torch.cat([
            wear.reshape(-1).to(torch.float64),
            self.eng.life_plan.slot_scores(
                self.life, self.pool.cache).to(torch.float64)]).cpu().numpy()
        return (flat[:wear.numel()].reshape(tuple(wear.shape))
                .astype(np.int64), flat[wear.numel():].astype(np.float32))

    def wear_state(self) -> Dict[str, torch.Tensor]:
        """The physical address map and the row-group endurance counters
        of the last run: feed it to ``run(..., wear_state=)`` so wear
        (device damage) outlives one arrival stream."""
        assert self.eng.wear and self.life is not None
        return {"shifts": self.addr.shifts,
                "rotations": self.addr.rotations,
                "row_write_count": self.life.row_write_count,
                "row_scrub_count": self.life.row_scrub_count}

    def _restore_wear(self, wear_state: Dict[str, Any]) -> None:
        """Install a ``wear_state()`` snapshot (tensors or arrays)."""
        assert self.eng.wear and self.life is not None
        dev = self.eng.device

        def t(k):
            return torch.as_tensor(wear_state[k]).to(dev, torch.int64)

        self.addr = AddressState(shifts=t("shifts"),
                                 rotations=t("rotations"))
        self.life = dataclasses.replace(
            self.life, row_write_count=t("row_write_count"),
            row_scrub_count=t("row_scrub_count"))
        self._gap_host = int(self.addr.shifts.max())
        if self.wear_policy is not None:
            # restored wear is not wear gained this run: without the
            # rebase the first check would fire an unearned rotation
            self.wear_policy.rebase(self.life.row_wear().cpu().numpy())

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
            if self.tele is not None:
                self._trace_completion(r.rid, i, clock)
            del self._tokens[r.rid]
            del self._remaining[r.rid], self._admitted[r.rid]
        self.pool.release(done)
        return len(done)

    def _trace_completion(self, rid: int, slot: int, clock: int) -> None:
        """Close a request's root span with its attributed energy, flips
        and BER (host values this event's read already brought) and
        observe its latency and queue wait."""
        rep = self._reports[rid]
        ins = self.tele.instruments
        ins.inc("serve_completions_total")
        ins.observe("serve_request_latency_steps", rep["latency_steps"])
        ins.observe("serve_request_queue_steps", rep["queue_steps"])
        root = self._req_span.pop(rid, None)
        if root is not None:
            self.tele.tracer.end(
                root, clock, slot=slot, n_tokens=rep["n_tokens"],
                energy_pj=rep["energy_pj"], flips=rep["flips"],
                errors=rep["errors"], ber=rep["ber"])

    def _trace_burst(self, n: int, clock: int, active_ids,
                     e_before: torch.Tensor) -> None:
        """The burst's span on the pool track and a decode span per
        active request; the energy delta and its even split are ``Lazy``
        args over the accumulator before and after (no op here)."""
        ins = self.tele.instruments
        ins.inc("serve_bursts_total")
        ins.inc("serve_decode_steps_total", n)
        ins.observe("serve_burst_steps", n)
        e_after = self._acc_decode.energy_pj
        burst_e = Lazy(lambda a, b: a - b, e_after, e_before)
        share = Lazy(lambda a, b, k=len(active_ids): (a - b) / k,
                     e_after, e_before)
        self.tele.tracer.complete(
            "burst", clock - n, clock, track="pool", cat="decode",
            steps=n, active=len(active_ids), energy_pj=burst_e)
        for i in active_ids:
            rid = self.pool.slot_req[i].rid
            self.tele.tracer.complete(
                "decode", clock - n, clock, track=self._req_track(rid),
                cat="decode", parent=self._req_span.get(rid), steps=n,
                energy_pj=share)

    def run(self, requests,
            wear_state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Serve an arrival stream (a request list or any arrival source,
        e.g. ``workload.replay.TraceSource``) to completion; returns the
        serve report. ``wear_state`` (an earlier run's ``wear_state()``)
        restores the address map and the row-group wear counters."""
        eng, pool = self.eng, self.pool
        pending = as_arrival_source(requests)
        key = rng.PRNGKey(eng.scfg.seed + 1)
        clock = decode_steps = bursts = 0
        self._acc_prefill = WriteStats.zero(eng.device)
        self._acc_decode = WriteStats.zero(eng.device)
        self._acc_scrub = WriteStats.zero(eng.device)
        self._acc_cow = WriteStats.zero(eng.device)
        self._acc_remap = WriteStats.zero(eng.device)
        self._saved_pj = 0.0
        self._saved_bits = 0
        self._linked_admissions = self._linked_cols = self._cow_events = 0
        self._req_span: Dict[int, int] = {}
        if self.tele is not None:
            self._bind_telemetry()
        if self.prefix is not None:
            self.prefix.reset_stats()  # as the extent table's
        self._scrub_passes = 0
        self._scrub_cursor = 0
        self._die_scrub_passes = [0] * self.mesh.n_dies
        self._die_wear_host = None
        if self.scrub_policy is not None:
            self.scrub_policy.reset()  # the serving clock restarts at 0
        self._last_wear_check = 0
        self._slot_scores_host = None
        self._remap_cost = None
        self._gap_host = 0  # host mirror of the gap (the pre-rotation shift)
        if self.wear_policy is not None:
            self.wear_policy.reset()
        self.life = (eng.life_plan.init_state(pool.cache)
                     if eng.life_plan is not None else None)
        self.addr = self._rotatable = None
        if eng.wear:
            self.addr = eng.plan.identity_address()
            self._rotatable = torch.tensor(eng.plan.rotatable(),
                                           device=eng.device)
            if wear_state is not None:
                self._restore_wear(wear_state)
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
                if self.tele is not None:
                    self.tele.event(clock,
                                    **self._event_gauges(clock, pending))
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
            # the pre-burst decode energy (a reference): the burst span's
            # energy is a lazy delta against it
            e_before = (self._acc_decode.energy_pj
                        if self.tele is not None else None)
            active = pool.active_mask()
            vectors = eng.vectors_for_floor(self._floor())
            rvec = (self._retention_vectors(clock)
                    if self.life is not None else None)
            (pool.tok, pool.cache, pool.pos, key, self._acc_decode,
             pool.slot_acc, self.life, toks) = eng.burst(
                eng.params, pool.tok, pool.cache, pool.pos, key,
                self._acc_decode, pool.slot_acc, active, vectors,
                self.life, rvec,
                None if self.addr is None else self.addr.shifts, n=n)
            for i in active_ids:
                rid = pool.slot_req[i].rid
                take = min(n, self._remaining[rid])
                self._tokens[rid].append((toks, i, take))
                self._remaining[rid] -= take
            clock += n
            decode_steps += n
            bursts += 1
            if self.tele is not None:
                self._trace_burst(n, clock, active_ids, e_before)
            self._complete(clock)
            self._maybe_scrub(clock, key)
            self._maybe_wear_check(clock)
            if self.tele is not None:
                self.tele.event(clock, **self._event_gauges(clock, pending))
        pre_host = self._acc_prefill.host_dict()
        dec_host = self._acc_decode.host_dict()
        self.meter.add_stream("kv_prefill", pre_host)
        self.meter.add_stream("kv_decode", dec_host)
        if self.life is not None:
            scrub_host = self._acc_scrub.host_dict()
            self.meter.add_stream("kv_scrub", scrub_host)
        if eng.wear:
            remap_host = self._acc_remap.host_dict()
            self.meter.add_stream("kv_remap", remap_host)
        if self.prefix is not None:
            cow_host = self._acc_cow.host_dict()
            self.meter.add_stream("kv_prefix_cow", cow_host)
        summary = self.meter.summary()
        summary.update({
            "requests": self._reports,
            "clock_steps": clock,
            "decode_steps": decode_steps,
            "bursts": bursts,
            "pool": pool.stats(),
            "extent_table": eng.controller.table.stats(),
        })
        if self.prefix is not None:
            # the prefix ledger: what linking earned, net of what the
            # mechanism cost (CAM searches and copy-on-write writes)
            pstats = self.prefix.stats()
            cow_pj = cow_host["energy_pj"]
            summary["prefix"] = {
                "enabled": True,
                "chunk": eng.scfg.prefix_chunk,
                "table_size": eng.scfg.prefix_table_size,
                **pstats,
                "linked_admissions": self._linked_admissions,
                "linked_cols": self._linked_cols,
                "write_energy_saved_pj": self._saved_pj,
                "saved_bits": self._saved_bits,
                "cow_events": self._cow_events,
                "cow_energy_pj": cow_pj,
                "net_energy_saved_pj": (self._saved_pj - cow_pj
                                        - pstats["cam_energy_pj"]),
            }
        if self.life is not None:
            # the lifetime ledger: write energy plus the scrub energy spent
            # defending it, and the decay that slipped through
            flips, decayed = torch.stack([self.life.retention_flips,
                                          self.life.decayed_bits()]).tolist()
            write_pj = pre_host["energy_pj"] + dec_host["energy_pj"]
            scrub_pj = scrub_host["energy_pj"]
            # the energy spent spreading the wear (0 with wear off)
            remap_pj = remap_host["energy_pj"] if eng.wear else 0.0
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
        if eng.wear:
            pol = self.wear_policy
            summary["wear"] = {
                "policy": pol.name if pol else "none",
                "rotations": pol.rotations if pol else 0,
                "remap_energy_pj": remap_host["energy_pj"],
                **eng.wear_report(self.life)}
        if self.mesh.n_dies > 1:
            summary["sharding"] = self._sharding_summary(clock)
        if self.tele is not None:
            # one snapshot every consumer (launcher, exporters) reads
            summary["telemetry"] = self.tele.snapshot()
        return summary

    def _sharding_summary(self, clock: int) -> Dict[str, Any]:
        """Per-die breakdown of the merged ledger: contiguous-slice
        reductions, on the host, of the per-slot attribution, the
        per-slot decayed bits and the row-group wear, read in one
        transfer (float64 holds the float32 attribution and the int64
        counts exactly)."""
        m, pool, eng = self.mesh, self.pool, self.eng
        amb = self._die_ambients_at(clock)
        parts = [pool.slot_acc[k].to(torch.float64)
                 for k in ("energy_pj", "flips", "errors")]
        decay = (None if self.life is None
                 else eng.life_plan.decayed_bits_by_slot(self.life))
        if decay is not None:
            parts.append(decay.to(torch.float64))
        wear = self.life.row_wear() if eng.wear else None
        if wear is not None:
            parts.append(wear.reshape(-1).to(torch.float64))
        flat = torch.cat(parts).cpu().numpy()
        cap = m.capacity
        energy, flips, errors = (
            m.reduce_slots(flat[j * cap:(j + 1) * cap].astype(np.float32))
            for j in range(3))
        off = 3 * cap
        if decay is not None:
            decay = m.reduce_slots(flat[off:off + cap].astype(np.int64))
            off += cap
        if wear is not None:
            wear = m.reduce_wear(flat[off:].astype(np.int64).reshape(
                tuple(wear.shape)))
        dies = []
        for d in range(m.n_dies):
            sl = m.slot_slice(d)
            row: Dict[str, Any] = {
                "die": d, "slots": [sl.start, sl.stop],
                "ambient_k": amb[d],
                "energy_pj": float(energy[d]),
                "flips": float(flips[d]),
                "errors": float(errors[d]),
                "scrub_passes": self._die_scrub_passes[d],
            }
            if decay is not None:
                row["decayed_bits"] = int(decay[d])
            if wear is not None:
                row["max_group_wear"] = int(wear[d])
            dies.append(row)
        # every die folds onto the one card
        return {"shards": m.n_dies, "slots_per_die": m.slots_per_die,
                "mesh_devices": 1, "dies": dies}
