"""Serving engine: batched prefill + decode with EXTENT-approximate KV writes.

The counterpart of ``repro.serve.engine`` for the extent path of every
family (the recurrent states of hybrid and ssm are float32 EXACT leaves,
stored as they are; a vlm batch carries ``image_embeds`` and an audio
batch ``frames``, and decoding starts after the image columns). The
engine diffs cache
trees: after a decode step the approximate write of (old cache, new
cache) is exactly the paper's write semantics — untouched slots are
bit-identical (zero energy under CMP) and the freshly written ring
column pays level energy and carries level WER. One ``WritePlan`` is
resolved at construction; the backend is a registry name (``cuda`` on a
CUDA device, ``lanes_ref`` on the CPU by default).

A decode *burst* of ``n`` steps is a Python loop of fused steps
(decode -> column write -> retention decay -> sample -> stats)
that never reads the device: the RNG key schedule runs on the host
(``repro_torch.rng``), every carried value stays on the device, and
stats accumulate into one device-resident ``WriteStats``. Sampling is
greedy (argmax) by default; with ``ServeConfig(greedy=False)`` it is
``jax.random.categorical``'s Gumbel argmax over ``logits / temperature``,
its uniforms drawn on the device from the step's sampling key (the
third of the step's three-way split, as in the reference), so the
sampled burst reads nothing back either. On a CUDA device the burst runs under
``torch.cuda.set_sync_debug_mode("error")``, so any host sync inside it
raises — the port's form of the reference's transfer guard.

With ``retention_scale > 0`` a ``LifetimePlan`` shadows the write plan
(``repro_torch.reliability``): after each step's column write the decay
record of the re-written columns is cleared and every stored bit of the
approximate leaves dwells one step at the ambient temperature; ``scrub``
runs one corrective pass between bursts. The decay streams fold off the
step's write key, so the write and sampling schedule is the same with
retention on or off, and a 300 K run equals a retention-off run.

With a wear policy or an endurance budget (``wear_policy`` /
``endurance_budget``) the physical addressing layer is on
(``repro_torch.memory.address``): the burst takes the per-leaf remap
``shifts`` (a device operand), derives the stuck-at map ``worn`` from
the carried row-group counters on the device each step, writes with
``addr=(shifts, worn)`` and books each column write to its physical row
group. The layer needs the lifetime state even with retention off, so
it builds the lifetime plan then too (an immortal one: its decay is an
identity). Identity shifts with no worn rows reproduce the run without
the layer bit for bit.

With ``soft_error_ber > 0`` every write of the plan is followed by the
radiation-upset hook (the hardened driver shields sign and exponent);
strikes land in ``WriteStats.soft_strikes``. A prefix-linked admission
(``prefill`` with ``alias_cols``, after ``splice_rows`` grafted the link
owners' resident columns into the old rows) runs the same split
schedule and model prefill, and its write skips the linked columns.

``generate(..., telemetry=)`` records the batch's span tree and one
event (``repro_torch.telemetry``); ``ServeConfig.shards`` splits the
scheduler's pool over dies, and ``retention_vectors_for_dies`` gives the
per-slot decay thresholds of dies at different ambients.

Lockstep contract (as in the reference): admitting a whole pool at once
and decoding it reproduces ``generate`` on the same batch bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core.energy_model import (StepEnergyMeter, add_slot_stats,
                                           zero_slot_stats)
from repro_torch.core.approx_store import approx_write_with_stats
from repro_torch.core.extent_table import QualityController
from repro_torch.core.priority import Priority, kv_cache_policy
from repro_torch.device import resolve_device
from repro_torch.memory import (AddressSpec, WritePlan, WriteStats,
                                default_backend)
from repro_torch.memory.plan import BATCH_AXIS, _approximate
from repro_torch.models import ModelApi, get_model
from repro_torch.reliability import LifetimePlan, scrub_tree


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 256
    max_new_tokens: int = 32
    extent_enabled: bool = True
    #: argmax sampling; False draws jax.random.categorical's Gumbel
    #: argmax of logits / temperature from each step's sampling key
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    #: write-path backend (a repro_torch.memory registry name); None picks
    #: the kernel ("cuda") on a CUDA device and the twin on the CPU
    backend: Optional[str] = None
    #: modelled device dwell (seconds) per decode step; 0 disables the
    #: retention model (repro_torch.reliability)
    retention_scale: float = 0.0
    #: die ambient temperature (kelvin) of the retention model
    ambient_k: float = 300.0
    #: post-write radiation upsets per stored bit (0 = off); the hardened
    #: driver protects the sign/exponent planes
    soft_error_ber: float = 0.0
    soft_error_hardened: bool = True
    #: content-addressable prefix cache (serve.prefix): admission links a
    #: matched prompt prefix to resident KV columns instead of writing
    #: them; prefix-off runs are bit-identical to an engine without it
    prefix_cache: bool = False
    prefix_chunk: int = 8
    prefix_table_size: int = 256
    #: physical addressing (memory.address): "rotate" turns on the
    #: wear-leveling remap (the scheduler rotates the logical -> physical
    #: column map when hot-row wear concentrates); endurance_budget > 0
    #: the stuck-at failure model (row groups whose wear reaches it stop
    #: accepting writes). Either turns the address layer on, in row
    #: groups of remap_group_cols ring columns
    wear_policy: str = "none"
    endurance_budget: int = 0
    remap_group_cols: int = 8
    #: sharded serving (repro_torch.sharding.DieMesh): the slot pool
    #: spans this many independently aging dies, partitioned over the
    #: slot axis (capacity must divide evenly). The burst stays one
    #: full-pool loop: any count is bit-identical to 1 until per-die
    #: state (ambients, wear) diverges
    shards: int = 1


def _tag_cache(cache: Any) -> Any:
    """Priority tree for a cache tree via the KV policy."""
    return T.map_with_path(kv_cache_policy, cache)


def _row_mask(active: torch.Tensor, ndim: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[BATCH_AXIS] = active.shape[0]
    return active.reshape(shape)


def mask_rows(new_tree: Any, old_tree: Any, active: torch.Tensor) -> Any:
    """Active rows take the new value, inactive rows keep the old — the
    burst guard that makes finished/empty slots free under CMP."""
    return T.tree_map(
        lambda n, o: torch.where(_row_mask(active, n.dim()), n, o),
        new_tree, old_tree)


def eager_extent_cache_write(key: np.ndarray, old_cache: Any,
                             new_cache: Any, tags: Any
                             ) -> Tuple[Any, Dict[str, Any]]:
    """Eager oracle for the fused cache write (the seed engine's data
    path): every approximate leaf goes through ``approx_write_with_stats``
    with ``fold_in(key, i)``, its stats read to the host leaf by leaf and
    summed in Python. The reference the benchmarks hold the fused path
    against; no serving path calls it."""
    stored, agg = [], {"energy_pj": 0.0, "bits_written": 0, "bit_errors": 0,
                       "bits_total": 0}
    for i, (o, n, t) in enumerate(zip(T.leaves(old_cache),
                                      T.leaves(new_cache), T.leaves(tags))):
        if _approximate(n, t):
            s, st = approx_write_with_stats(rng.fold_in(key, i), o, n, t)
            agg["energy_pj"] += float(st.energy_pj)
            agg["bits_written"] += int(st.bits_written)
            agg["bit_errors"] += int(st.bit_errors)
            agg["bits_total"] += int(st.bits_total)
            stored.append(s)
        else:
            stored.append(n)  # EXACT leaves are stored as they are
    return T.structure(new_cache).unflatten(stored), agg


class ServingEngine:
    """Batched autoregressive serving of any ported family: the engine
    only diffs cache trees."""

    def __init__(self, cfg: ModelConfig, serve_cfg: ServeConfig,
                 params: Optional[Any] = None, *, device=None,
                 api: Optional[ModelApi] = None):
        self.cfg = cfg
        self.scfg = serve_cfg
        self.device = resolve_device(device)
        self.api = api if api is not None else get_model(cfg)
        self.params = (params if params is not None
                       else self.api.init(serve_cfg.seed, self.device))
        self.meter = StepEnergyMeter()
        self.controller = QualityController()
        self.backend = serve_cfg.backend or default_backend(self.device)
        cache_like = self.api.init_cache(1, serve_cfg.max_seq, "meta")
        self.wear = (serve_cfg.wear_policy != "none"
                     or serve_cfg.endurance_budget > 0)
        self.plan = WritePlan.for_tree(
            cache_like, device=self.device, backend=self.backend,
            axes=self.api.cache_axes(),
            soft_error_ber=serve_cfg.soft_error_ber,
            soft_error_hardened=serve_cfg.soft_error_hardened,
            address_spec=AddressSpec(
                group_cols=serve_cfg.remap_group_cols,
                endurance_budget=serve_cfg.endurance_budget)
            if self.wear else None)
        # per-(leaf, floor, ambient) decay thresholds resolved once; an
        # ambient schedule swaps them between bursts. The wear layer
        # needs the lifetime state (it carries the row-group counters):
        # at retention_scale 0 that plan is immortal
        self.life_plan = None
        if serve_cfg.retention_scale > 0.0 or self.wear:
            self.life_plan = LifetimePlan.for_tree(
                cache_like, self.plan, ambient_k=serve_cfg.ambient_k,
                dwell_s=serve_cfg.retention_scale)

    def vectors_for_floor(self, floor: Priority = Priority.LOW) -> Tuple:
        return self.plan.vectors_for(floor)

    def retention_vectors_for(self, floor: Priority = Priority.LOW,
                              ambient_k: Optional[float] = None) -> Tuple:
        """Per-leaf decay thresholds for one (floor, ambient) pair. Only
        valid with retention on."""
        assert self.life_plan is not None, "retention_scale == 0"
        return self.life_plan.vectors_for(floor, ambient_k=ambient_k)

    def retention_vectors_for_dies(self, floor: Priority,
                                   ambients: Tuple[float, ...],
                                   slots_per_die: int) -> Tuple:
        """Per-die decay thresholds of a die-sharded pool
        (``LifetimePlan.vectors_for_dies``): uniform ambients give the
        pool-wide thresholds, divergent ones per-slot rows."""
        assert self.life_plan is not None, "retention_scale == 0"
        return self.life_plan.vectors_for_dies(floor, ambients,
                                               slots_per_die)

    def remap_cost(self, tree: Any) -> Tuple[float, int]:
        """Host constants (energy_pj, bits) of ONE wear-leveling rotation
        (``WritePlan.migration_cost``)."""
        return self.plan.migration_cost(tree)

    def prompt_len(self, batch: Dict[str, torch.Tensor]) -> int:
        return self.api.prompt_len(batch)

    # ---------------------------------------------------------- fused steps
    def prefill(self, params, batch, old_rows, key: np.ndarray, vectors,
                alias_cols: Optional[torch.Tensor] = None):
        """Fused prefill -> extent write -> first token.
        ``old_rows=None`` diffs against zeros (a cold cache); otherwise
        against the pool's current rows for the admitted slots.
        ``alias_cols`` ((B,) int64, with ``old_rows``) keeps each slot's
        leading linked columns as they are in ``old_rows``."""
        key, k_write, k_sample = rng.split(key, 3)
        logits, cache = self.api.prefill(params, batch, self.scfg.max_seq)
        acc = WriteStats.zero(self.device)
        if self.scfg.extent_enabled:
            old = (old_rows if old_rows is not None
                   else T.tree_map(torch.zeros_like, cache))
            cache, acc = self.plan.write(k_write, old, cache, vectors,
                                         alias_cols=alias_cols)
        return self._sample(k_sample, logits), cache, key, acc

    def splice_rows(self, old_rows, owner_rows, alias_cols: torch.Tensor):
        """Graft the link owners' resident prefix columns into extracted
        admission rows: per ring leaf, slot ``b``'s columns ``[0,
        alias_cols[b])`` take ``owner_rows``'s bits, the rest keep
        ``old_rows``'s. The result is the linked prefill's ``old``: its
        linked columns are stored as they are (the owner's current bits,
        realized write errors and decay included)."""
        out = []
        for i, (o, w) in enumerate(zip(T.leaves(old_rows),
                                       T.leaves(owner_rows))):
            keep = self.plan.alias_keep(i, o, alias_cols)
            out.append(o if keep is None else torch.where(keep, w, o))
        return self.plan.unflatten(out)

    def burst(self, params, tok, cache, pos, key: np.ndarray, acc,
              slot_acc, active, vectors, life=None, rvec=None, shifts=None,
              *, n: int):
        """``n`` fused decode steps. Inactive rows keep their cache bits,
        position and token. ``life``/``rvec`` (the lifetime state and the
        decay thresholds) are required with retention or wear on and
        ignored otherwise; ``shifts`` (the (L,) remap shifts) with wear
        on. Returns (tok, cache, pos, key, acc, slot_acc, life, tokens
        (n, B))."""
        retention = self.life_plan is not None
        act_i = active.to(pos.dtype)
        toks = []
        with _no_host_sync(self.device):
            for _ in range(n):
                key, k_write, k_sample = rng.split(key, 3)
                logits, new_cache = self.api.decode_step(
                    params, tok, cache, pos, self.scfg.max_seq)
                new_cache = mask_rows(new_cache, cache, active)
                if self.scfg.extent_enabled:
                    addr = None
                    if self.wear:
                        # the column's address maps through the shifts to
                        # its row group; worn groups are stuck-at (the map
                        # derives from the carried counters, on the card)
                        addr = (shifts, self.life_plan.worn_groups(life))
                    new_cache, st = self.plan.write_columns(
                        k_write, cache, new_cache, pos, vectors, addr=addr)
                    if self.wear:
                        life = self.life_plan.record_column_write(
                            life, new_cache, pos, active, shifts)
                    acc = acc + st
                    slot_acc = add_slot_stats(slot_acc, st, active)
                if retention:
                    # the step re-wrote the active slots' ring columns:
                    # their decay record is void; then every stored bit
                    # of the approximate leaves dwells one step
                    life = self.life_plan.clear_written(life, pos, active)
                    new_cache, life = self.life_plan.advance(
                        k_write, new_cache, life, rvec)
                tok = torch.where(active, self._sample(k_sample, logits),
                                  tok)
                cache, pos = new_cache, pos + act_i
                toks.append(tok)
        return tok, cache, pos, key, acc, slot_acc, life, torch.stack(toks)

    def scrub(self, key: np.ndarray, cache, life, vectors, *,
              enabled=None, cols: Optional[int] = None, cursor: int = 0,
              shifts: Optional[torch.Tensor] = None,
              slot_mask: Optional[torch.Tensor] = None):
        """One corrective scrub pass through the write path's backend
        (``reliability.scrub_tree``). With wear on, ``shifts`` are the
        remap shifts: the cursor walks physical rows and worn rows keep
        their decay. ``slot_mask`` ((B,) bool) limits the pass to one
        die's slots. Returns (cache, life, WriteStats)."""
        addr = None
        if self.wear:
            addr = (shifts, self.life_plan.worn_groups(life))
        return scrub_tree(key, cache, life, self.life_plan, vectors,
                          enabled=enabled, cols=cols, cursor=cursor,
                          addr=addr, slot_mask=slot_mask)

    def _sample(self, key: np.ndarray, logits: torch.Tensor) -> torch.Tensor:
        if self.scfg.greedy:
            return torch.argmax(logits, dim=-1)
        return rng.categorical_t(key, logits / self.scfg.temperature)

    # ------------------------------------------------------------ generation
    def generate(self, batch: Dict[str, torch.Tensor],
                 max_new_tokens: Optional[int] = None, *,
                 telemetry: Optional[Any] = None
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill ``batch`` then decode one burst. Returns (tokens
        (B, T_new), report); the stats cross to the host once, at the end.
        ``telemetry`` (a ``repro_torch.telemetry.Telemetry``) records one
        ``generate[B=...]`` span with ``prefill`` and ``decode`` children
        and one event."""
        mnt = max_new_tokens or self.scfg.max_new_tokens
        key = rng.PRNGKey(self.scfg.seed + 1)
        B = batch["tokens"].shape[0]
        vectors = self.vectors_for_floor(Priority.LOW)
        tok, cache, key, pre_acc = self.prefill(self.params, batch, None,
                                                key, vectors)
        pos = torch.full((B,), self.prompt_len(batch), dtype=torch.int64,
                         device=self.device)
        active = torch.ones((B,), dtype=torch.bool, device=self.device)
        acc = WriteStats.zero(self.device)
        slot_acc = zero_slot_stats(B, self.device)
        life = rvec = shifts = None
        if self.life_plan is not None:
            life = self.life_plan.init_state(cache)
            rvec = self.retention_vectors_for(Priority.LOW)
        if self.wear:
            # no scheduler to rotate the map: the identity permutation,
            # bit-identical to wear off until a budget wears a group out
            shifts = self.plan.identity_address().shifts
        if mnt > 1:
            _, cache, pos, key, acc, slot_acc, life, toks = self.burst(
                self.params, tok, cache, pos, key, acc, slot_acc, active,
                vectors, life, rvec, shifts, n=mnt - 1)
            tokens = torch.cat([tok[:, None], toks.t()], dim=1)
        else:
            tokens = tok[:, None]
        if telemetry is not None:
            # the batch's spans on the serve lane and one drain at the
            # end (the monolithic event); energies stay device refs
            # until finalize
            ins = telemetry.instruments
            ins.bind("serve_prefill_energy_pj_total",
                     lambda: pre_acc.energy_pj)
            ins.bind("serve_decode_energy_pj_total", lambda: acc.energy_pj)
            root = telemetry.tracer.begin(
                f"generate[B={B}]", 0, track="batch", cat="request")
            telemetry.tracer.complete(
                "prefill", 0, 0, track="batch", parent=root,
                energy_pj=pre_acc.energy_pj)
            telemetry.tracer.complete(
                "decode", 0, mnt - 1, track="batch", parent=root,
                steps=mnt - 1, energy_pj=acc.energy_pj)
            telemetry.tracer.end(root, mnt - 1)
            telemetry.event(mnt - 1, serve_pool_occupancy=B,
                            serve_queue_depth=0)
        if self.scfg.extent_enabled:
            self.meter.add_stream("kv_prefill", pre_acc.host_dict())
            self.meter.add_stream("kv_decode", acc.host_dict())
        report = self.meter.summary()
        if life is not None:
            # repro_torch: allow(no-host-sync-in-burst): once per generate
            flips, decayed = torch.stack(
                [life.retention_flips, life.decayed_bits()]).tolist()
            report["retention"] = {
                "ambient_k": self.scfg.ambient_k,
                "dwell_s_per_step": self.scfg.retention_scale,
                "flips": int(flips), "decayed_bits": int(decayed)}
        if self.wear:
            report["wear"] = self.wear_report(life)
        return tokens, report

    def wear_report(self, life) -> Dict[str, Any]:
        """The row-group wear summary of ``life`` (one host read)."""
        worn = self.life_plan.worn_groups(life)
        # repro_torch: allow(no-host-sync-in-burst): once per report
        top, n_worn = torch.stack([
            life.row_wear().max(),
            torch.zeros_like(life.step) if worn is None
            else worn.sum()]).tolist()
        return {"max_group_wear": int(top), "worn_groups": int(n_worn),
                "endurance_budget": self.scfg.endurance_budget,
                "group_cols": self.scfg.remap_group_cols}


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """Any host sync inside the block raises (CUDA); restored after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
