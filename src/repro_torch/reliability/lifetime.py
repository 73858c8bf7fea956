"""Device-resident retention lifetime state for the serving cache.

The counterpart of ``repro.reliability.lifetime`` for the serving slice.
Every stored bit of an approximate leaf decays with the thermal
activation rate of its cell,

    tau(T)  = tau0 * exp(Delta_eff(T))          (paper Eq. 15 at V = 0)
    p_flip  = 1 - exp(-dwell / tau)             (paper Eq. 14)

with ``Delta_eff = delta_of_t(T) * derate(level)``: the weak LOW driver
writes shallower states that also rot faster. Planes coded EXACT by
``bitplane_priorities`` (sign and exponent) never decay; mantissa planes
decay at their plane's level. Probabilities below ``MIN_P_STEP`` are
exactly zero, so a 300 K run with retention on is bit-identical to one
with retention off.

The decay sampler hashes (seed, flat ELEMENT index, bit plane) over the
element's own planes (16 for bf16) with the lane kernels' murmur3
counter hash — unlike the scrub, which hashes flat LANE indices over 32
lane planes. Leaf ``i`` folds ``RETENTION_OFFSET + i`` into the step's
write key. The thresholds are host numpy, resolved once per (dtype,
level, temperature, dwell); planes whose threshold is 0 are skipped
(``u < 0`` never holds), so a 300 K step costs nothing.

The decay stays plain torch ops (it is plain ``jnp`` in the reference),
int64 masked to 32 bits as in the lane twins. Masks are held as the
signed integer view of the leaf's dtype (``int_type``), the bit pattern
of the reference's unsigned view.

State carried per leaf on the device: ``masks`` (XOR record of the bits
that differ from their written value), ``write_count`` / ``scrub_count``
(per-leaf wear), ``last_write_step`` / ``last_scrub_step`` and
``retention_flips`` (all sampled decay flips).

Endurance wear is also kept per physical row group
(``row_write_count`` / ``row_scrub_count``, (L, G)), the granularity the
wear-leveling policy and the endurance-budget failure model work at:
one unit per column write or scrubbed column, booked to the group the
*rotated* address lands in (``repro_torch.memory.address``). Without an
``AddressSpec`` on the plan G is 1 and nothing books there.
``worn_groups`` turns the counters into the stuck-at map, on the device,
inside the burst.

A pool sharded over dies at different ambients decays each slot at its
own die's temperature: ``vectors_for_dies`` gives per-slot threshold
rows (``SlotThresholds``: host rows decide which planes are live, the
same rows on the device are the compare operand, uploaded once per
change of ambients). The hash stays over (seed, flat element, plane),
so heating one die never moves another die's decay record.

``decay_tensor`` decays one tensor over one dwell (the same sampler,
seeded from the key's bits), and ``RestoreIntegrity`` configures the
checkpoint restore's decay-and-scrub pass (``train.checkpoint``).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.core import mtj, wer
from repro_torch.core.priority import (Priority, bitplane_priorities,
                                       bits_of, int_type)
from repro_torch.memory import address as A
from repro_torch.memory import rng_streams
from repro_torch.memory.plan import BATCH_AXIS, WritePlan
from repro_torch.memory.stats import popcount, popcount_rows
from repro_torch.memory.rng_streams import (K_BIT, K_ELEM, M32, hash_u32,
                                           mul32)

#: per-priority Delta derate: the approximation floor sets the decay clock.
RETENTION_DERATE = {
    Priority.LOW: 0.80,
    Priority.MID: 0.90,
    Priority.HIGH: 0.97,
    Priority.EXACT: 1.0,
}

#: flip probabilities below this are exactly zero (see module doc).
MIN_P_STEP = 1e-8


def retention_delta(level: Priority, t_k: float,
                    p: mtj.MTJParams = mtj.DEFAULT_MTJ) -> float:
    """Effective thermal stability of a ``level``-written cell at ``t_k``
    kelvin: the float32 Delta(T) times the level derate (in float64, as
    the reference computes it)."""
    return float(mtj.delta_of_t(p, np.float32(t_k))) * \
        RETENTION_DERATE[Priority.coerce(level)]


def retention_flip_p(level: Priority, t_k: float, dwell_s: float,
                     p: mtj.MTJParams = mtj.DEFAULT_MTJ) -> float:
    """Probability one stored bit decays within ``dwell_s`` seconds (Eq. 14
    at zero bias), clamped to exactly 0 below ``MIN_P_STEP``."""
    if dwell_s <= 0.0:
        return 0.0
    d = retention_delta(level, t_k, p)
    prob = float(wer.switching_probability(dwell_s, d, 0.0, p.tau0))
    return prob if prob >= MIN_P_STEP else 0.0


@functools.lru_cache(maxsize=1024)
def _retention_thresholds(dtype: torch.dtype, level: Priority, t_k: float,
                          dwell_s: float) -> np.ndarray:
    """(element_bits,) host uint32 decay thresholds for one (dtype,
    effective level, temperature, dwell): per-plane p_flip * 2^32, EXACT
    planes 0."""
    codes = bitplane_priorities(dtype, Priority.coerce(level))
    probs = np.asarray([
        0.0 if c == int(Priority.EXACT)
        else retention_flip_p(Priority(int(c)), t_k, dwell_s)
        for c in codes], np.float64)
    thr = (np.clip(probs, 0.0, 1.0) * 2**32).astype(
        np.uint64).clip(0, 2**32 - 1).astype(np.uint32)
    thr.setflags(write=False)
    return thr


#: bytes of int64 bases ``_elem_hash_base`` keeps between calls
ELEM_BASE_CACHE_BYTES = 1 << 29


class _BaseCache:
    """``(flat element index * K_ELEM) mod 2^32`` for ``n`` elements — the
    seed-independent half of the counter hash — kept per (size, device)
    while the kept bases total at most ``limit`` bytes, the least
    recently used going first; a base larger than ``limit`` is built at
    each call, so no caller inherits gigabytes of them."""

    def __init__(self, limit: int):
        self.limit = limit
        self._kept: "collections.OrderedDict" = collections.OrderedDict()

    def __call__(self, n: int, device: torch.device) -> torch.Tensor:
        key = (n, device)
        if key in self._kept:
            self._kept.move_to_end(key)
            return self._kept[key]
        base = mul32(torch.arange(n, dtype=torch.int64, device=device),
                     K_ELEM)
        if 8 * n <= self.limit:
            self._kept[key] = base
            while self.bytes_held() > self.limit:
                self._kept.popitem(last=False)
        return base

    def bytes_held(self) -> int:
        return sum(8 * n for n, _ in self._kept)

    def cache_clear(self) -> None:
        self._kept.clear()


_elem_hash_base = _BaseCache(ELEM_BASE_CACHE_BYTES)


def _to_int_bits(v: torch.Tensor, nbits: int, dtype: torch.dtype
                 ) -> torch.Tensor:
    """int64 values in [0, 2^nbits) -> the ``dtype`` tensor of the same
    bits."""
    return (v - ((v >> (nbits - 1)) << nbits)).to(dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class SlotThresholds:
    """One leaf's per-slot decay thresholds (a die-sharded pool whose
    dies sit at different ambients): ``host`` (B, nbits) uint32 rows,
    from which the host decides which planes can decay at all, and
    ``dev``, the same rows transposed to (nbits, B) int64 on the device,
    the compare operand (uploaded once, outside the bursts)."""
    host: np.ndarray
    dev: torch.Tensor

    @classmethod
    def of(cls, rows: np.ndarray, device) -> "SlotThresholds":
        rows.setflags(write=False)
        return cls(host=rows, dev=torch.from_numpy(
            rows.T.astype(np.int64)).to(device))

    def any(self) -> bool:
        return bool(self.host.any())


def _decay_leaf(seed: int, x: torch.Tensor, thr
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample retention flips on every stored bit of ``x``: counter hash
    over (seed, flat element index, bit plane). ``thr`` is the (nbits,)
    host thresholds of every slot, or a ``SlotThresholds`` whose rows
    broadcast along the batch axis (each slot's bits against its own
    die's thresholds). Returns (decayed, flip mask (``int_type`` view),
    n_flips int64). Planes whose threshold is zero for every slot are
    skipped (decided on the host); with all of them zero this is an
    identity."""
    it = int_type(x.dtype)
    nbits = bits_of(x.dtype)
    base = (_elem_hash_base(x.numel(), x.device).reshape(x.shape)
            ^ (int(seed) & M32))
    strike = torch.zeros_like(base)
    flips = torch.zeros((), dtype=torch.int64, device=x.device)
    rows = isinstance(thr, SlotThresholds)
    if rows:
        live = thr.host.any(axis=0)
        bshape = [1] * x.dim()
        bshape[BATCH_AXIS] = -1
    for b in range(nbits):
        if not (live[b] if rows else thr[b]):
            continue
        u = hash_u32(base ^ ((b * K_BIT) & M32))
        hit = u < (thr.dev[b].reshape(bshape) if rows else int(thr[b]))
        strike = strike | (hit.to(torch.int64) << b)
        flips = flips + hit.sum()
    mask = _to_int_bits(strike, nbits, it)
    return (x.view(it) ^ mask).view(x.dtype), mask, flips


def decay_tensor(key: np.ndarray, x: torch.Tensor, *, level: Priority,
                 ambient_k: float, dwell_s: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-tensor retention decay: ``x`` sat ``dwell_s`` seconds at
    ``ambient_k`` kelvin after a ``level`` write. Returns (decayed, flip
    mask (``int_type`` view), n_flips 0-d int64): the checkpoint's
    restore integrity pass rides on it. ``key`` is a host threefry key;
    its ``bits`` are the hash seed, as in the reference."""
    thr = _retention_thresholds(x.dtype, Priority.coerce(level),
                                float(ambient_k), float(dwell_s))
    return _decay_leaf(rng.seed_u32(key), x, thr)


@dataclasses.dataclass(frozen=True)
class LifetimeState:
    """Per-region lifetime state: device tensors, one mask per flat leaf
    (``None`` for exact leaves), (L,) int64 per-leaf counters and (L, G)
    int64 per-physical-row-group wear counters."""
    step: torch.Tensor                         # () i64 decode-step clock
    masks: Tuple[Optional[torch.Tensor], ...]  # decayed-bit XOR masks
    write_count: torch.Tensor                  # (L,) i64 writes per leaf
    scrub_count: torch.Tensor                  # (L,) i64 scrub passes
    row_write_count: torch.Tensor              # (L, G) i64 column writes
    row_scrub_count: torch.Tensor              # (L, G) i64 scrubbed cols
    retention_flips: torch.Tensor              # () i64 sampled decay flips
    last_write_step: torch.Tensor              # (L,) i64
    last_scrub_step: torch.Tensor              # (L,) i64

    def decayed_bits(self) -> torch.Tensor:
        """Stored bits currently differing from their written value
        (popcount of the masks): a 0-d int64 on the device."""
        total = torch.zeros_like(self.retention_flips)
        for m in self.masks:
            if m is not None:
                total = total + popcount(m)
        return total

    def row_wear(self) -> torch.Tensor:
        """(L, G) cumulative row-group wear: writes and scrub re-writes
        consume the same endurance budget."""
        return self.row_write_count + self.row_scrub_count


@dataclasses.dataclass
class LifetimePlan:
    """Resolve-once retention policy shadowing one ``WritePlan``.

    Holds the per-leaf dtypes and resolves (floor, ambient temperature)
    pairs to per-leaf host decay thresholds: swapping floor or ambient
    between bursts swaps operands. ``dwell_s`` is the modelled device
    dwell per decode step (``--retention-scale``); ``dwell_s == 0`` is the
    immortal plan, whose ``advance`` is an identity."""
    plan: WritePlan
    leaf_dtypes: Tuple[torch.dtype, ...]
    ambient_k: float = 300.0
    dwell_s: float = 0.0

    @classmethod
    def for_tree(cls, tree: Any, plan: WritePlan, *,
                 ambient_k: float = 300.0,
                 dwell_s: float = 0.0) -> "LifetimePlan":
        """``tree``: tensors (any device, ``meta`` included) with the
        plan's structure; only dtypes are read."""
        return cls(plan=plan,
                   leaf_dtypes=tuple(leaf.dtype for leaf in T.leaves(tree)),
                   ambient_k=ambient_k, dwell_s=dwell_s)

    @property
    def immortal(self) -> bool:
        return self.dwell_s <= 0.0

    def __post_init__(self):
        # (L,) 1-for-approximate-leaf vector, uploaded here: ``advance``
        # runs inside sync-free bursts, where a host copy is refused
        self._approx = torch.tensor(
            [int(lvl is not None) for lvl in self.plan.leaf_levels],
            dtype=torch.int64, device=self.plan.device)
        #: per-(floor, ambients, slots_per_die) SlotThresholds tuples
        self._die_rows = {}

    # ------------------------------------------------------------- operands
    def vectors_for(self, floor: Priority = Priority.LOW,
                    ambient_k: Optional[float] = None,
                    dwell_s: Optional[float] = None
                    ) -> Tuple[Optional[np.ndarray], ...]:
        """Per-leaf decay thresholds for one (floor, ambient, dwell) —
        ``None`` for exact leaves. The ambient override is how a
        temperature schedule runs: the host swaps operands between
        bursts; ``dwell_s`` overrides the plan's dwell (a region aging
        several steps in one draw)."""
        t_k = self.ambient_k if ambient_k is None else float(ambient_k)
        dw = self.dwell_s if dwell_s is None else float(dwell_s)
        floor = Priority.coerce(floor)
        return tuple(
            _retention_thresholds(dt, max(lvl, floor), t_k, dw)
            if lvl is not None else None
            for dt, lvl in zip(self.leaf_dtypes, self.plan.leaf_levels))

    def vectors_for_dies(self, floor: Priority, ambients: Sequence[float],
                         slots_per_die: int) -> Tuple[Any, ...]:
        """Per-leaf decay thresholds for a slot pool sharded over
        ``len(ambients)`` dies of ``slots_per_die`` slots (die ``d`` owns
        the slots from ``d * slots_per_die``). Uniform ambients return
        ``vectors_for``'s (nbits,) thresholds unchanged; divergent ones
        give each approximate leaf a ``SlotThresholds`` of per-slot rows,
        built and uploaded once per (floor, ambients)."""
        ts = tuple(float(t) for t in ambients)
        if len(set(ts)) <= 1:
            return self.vectors_for(floor, ambient_k=ts[0])
        floor = Priority.coerce(floor)
        key = (floor, ts, slots_per_die)
        if key not in self._die_rows:
            self._die_rows[key] = tuple(
                None if lvl is None else SlotThresholds.of(np.repeat(
                    np.stack([_retention_thresholds(
                        dt, max(lvl, floor), t, self.dwell_s) for t in ts]),
                    slots_per_die, axis=0), self.plan.device)
                for dt, lvl in zip(self.leaf_dtypes, self.plan.leaf_levels))
        return self._die_rows[key]

    # ---------------------------------------------------------------- state
    def init_state(self, tree: Any) -> LifetimeState:
        """Fresh (just-written, zero-wear) state for a concrete tree."""
        flat = T.leaves(tree)
        masks = tuple(
            torch.zeros(leaf.shape, dtype=int_type(leaf.dtype),
                        device=leaf.device) if lvl is not None else None
            for leaf, lvl in zip(flat, self.plan.leaf_levels))
        zl = torch.zeros((len(flat),), dtype=torch.int64,
                         device=self.plan.device)
        zg = torch.zeros((len(flat), self.n_row_groups(tree)),
                         dtype=torch.int64, device=self.plan.device)
        z = torch.zeros((), dtype=torch.int64, device=self.plan.device)
        return LifetimeState(step=z, masks=masks, write_count=zl,
                             scrub_count=zl, row_write_count=zg,
                             row_scrub_count=zg, retention_flips=z,
                             last_write_step=zl, last_scrub_step=zl)

    def n_row_groups(self, tree: Any) -> int:
        """Padded row-group count G of the (L, G) wear counters: the most
        groups of any approximate leaf under the plan's ``AddressSpec``
        (1 without one)."""
        spec = self.plan.address_spec
        if spec is None:
            return 1
        return max((spec.n_groups(leaf.shape, ax, BATCH_AXIS)
                    for leaf, lvl, ax in zip(T.leaves(tree),
                                             self.plan.leaf_levels,
                                             self.plan.leaf_seq_axis)
                    if lvl is not None), default=1)

    # ------------------------------------------------- physical addressing
    def worn_groups(self, state: LifetimeState) -> Optional[torch.Tensor]:
        """(L, G) bool stuck-at map of the endurance-budget failure model:
        groups whose write+scrub wear has reached the budget accept no
        more writes. None (a static decision: no gating work at all)
        when the address layer is off or the budget unbounded."""
        spec = self.plan.address_spec
        if spec is None or spec.endurance_budget <= 0:
            return None
        return state.row_wear() >= spec.endurance_budget

    def _approx_leaves(self, tree: Any):
        """(leaf index, leaf, seq axis) of every approximate leaf."""
        for i, (leaf, lvl, ax) in enumerate(zip(T.leaves(tree),
                                                self.plan.leaf_levels,
                                                self.plan.leaf_seq_axis)):
            if lvl is not None:
                yield i, leaf, ax

    def record_column_write(self, state: LifetimeState, tree: Any,
                            pos: torch.Tensor, active: torch.Tensor,
                            shifts: torch.Tensor) -> LifetimeState:
        """Book one decode step's column writes into the row-group
        counters: each ACTIVE slot's write at ``pos % C`` maps through
        the leaf's rotation to its physical group. Device scatter-adds
        only (it runs inside the burst)."""
        spec = self.plan.address_spec
        if spec is None:
            return state
        act = active.to(torch.int64)
        rw = state.row_write_count.clone()
        for i, leaf, ax in self._approx_leaves(tree):
            if ax is None:
                g = torch.arange(pos.shape[0], dtype=torch.int64,
                                 device=pos.device)
            else:
                g = A.column_group_ids(pos, shifts[i], leaf.shape[ax], spec)
            rw[i].index_add_(0, g, act)
        return dataclasses.replace(state, row_write_count=rw)

    def record_admission_write(self, state: LifetimeState, tree: Any,
                               idx: torch.Tensor, start: torch.Tensor,
                               end: torch.Tensor, shifts: torch.Tensor
                               ) -> LifetimeState:
        """Book one admission prefill's column drives: admitted slot
        ``idx[b]`` re-drove the logical ring columns ``[start[b],
        end[b])`` of every ring leaf; with a prefix link ``start`` is the
        linked depth, so shared columns wear once, at their owner's
        admission. Non-ring approximate leaves book one whole-row drive
        per admitted slot. Only the prefix-cache path calls this:
        prefix-off runs book wear on decode columns only, as the
        reference does."""
        spec = self.plan.address_spec
        if spec is None:
            return state
        rw = state.row_write_count.clone()
        for i, leaf, ax in self._approx_leaves(tree):
            if ax is None:
                rw[i].index_add_(0, idx, torch.ones_like(idx))
            else:
                rw[i] += A.slot_window_group_counts(
                    idx, start, end, shifts[i], leaf.shape[ax],
                    rw.shape[1], spec)
        return dataclasses.replace(state, row_write_count=rw)

    def record_migration(self, state: LifetimeState, tree: Any,
                         gap_start: int, cols: int) -> LifetimeState:
        """Book one start-gap migration's row re-writes: the ``cols``-wide
        physical window at ``gap_start`` (host ints) is re-driven once
        per slot of every ring leaf. Migration writes consume the same
        budget as data writes. Runs per rotation, outside the burst."""
        spec = self.plan.address_spec
        if spec is None:
            return state
        rw = state.row_write_count.clone()
        for i, leaf, ax in self._approx_leaves(tree):
            if ax is None:
                continue
            C = leaf.shape[ax]
            rw[i] += A.window_group_counts(
                gap_start % C, min(cols, C), C, leaf.shape[BATCH_AXIS],
                rw.shape[1], spec, rw.device)
        return dataclasses.replace(state, row_write_count=rw)

    def slot_scores(self, state: LifetimeState, tree: Any) -> torch.Tensor:
        """(B,) float32 placement score per slot for wear-aware
        admission: the hottest row-group wear backing the slot's rows
        plus its residual decayed bits (higher = a worse home for a
        HIGH-quality request). The scheduler reads it at its wear
        checkpoints, never per admission."""
        spec = self.plan.address_spec or A.AddressSpec()
        flat = T.leaves(tree)
        B = flat[0].shape[BATCH_AXIS]
        wear = state.row_wear()
        wear_s = torch.zeros((B,), dtype=torch.float32, device=wear.device)
        decay_s = torch.zeros_like(wear_s)
        for i, leaf, ax in self._approx_leaves(tree):
            gc = 1 if ax is None else spec.col_groups(leaf.shape[ax])
            wear_s = torch.maximum(wear_s, wear[i, :B * gc].reshape(
                B, gc).amax(1).to(torch.float32))
            m = state.masks[i]
            if m is not None:
                decay_s = decay_s + popcount_rows(
                    m.movedim(BATCH_AXIS, 0).reshape(B, -1)).to(
                        torch.float32)
        return wear_s + decay_s

    def decayed_bits_by_slot(self, state: LifetimeState
                             ) -> Optional[torch.Tensor]:
        """(B,) int64 residual decayed bits per slot row (popcount of the
        masks over every non-batch axis); None when no leaf carries a
        mask."""
        out = None
        for m in state.masks:
            if m is None:
                continue
            v = popcount_rows(m.movedim(BATCH_AXIS, 0).reshape(
                m.shape[BATCH_AXIS], -1))
            out = v if out is None else out + v
        return out

    # -------------------------------------------------------------- advance
    def advance(self, key: np.ndarray, tree: Any, state: LifetimeState,
                vectors: Optional[Sequence[Any]] = None, *,
                count_write: bool = True, steps: int = 1
                ) -> Tuple[Any, LifetimeState]:
        """One dwell interval: sample decay on every stored bit of the
        approximate leaves, XOR the flips into the masks and move the
        clock ``steps`` steps (the steps the caller's ``vectors`` cover:
        one draw, the process is memoryless). ``count_write`` (a decode
        step, which re-wrote the leaves before dwelling) also books the
        write counters; a pure dwell (``MemoryRegion.age``) books no
        wear. ``vectors`` holds per leaf (nbits,) thresholds or per-slot
        ``SlotThresholds`` (``vectors_for_dies``). Reads nothing from the
        device. ``key`` is the step's write key; leaf ``i`` folds
        ``RETENTION_OFFSET + i`` off it, so the write and sampling
        schedule is the same with retention on or off."""
        if self.immortal:
            return tree, state
        if vectors is None:
            vectors = self.vectors_for()
        flat = T.leaves(tree)
        masks = list(state.masks)
        flips = state.retention_flips
        out = []
        for i, leaf in enumerate(flat):
            thr = vectors[i]
            if thr is None or not thr.any():
                # no plane can decay (u < 0 never holds): an identity
                out.append(leaf)
                continue
            k = rng.fold_in(key, rng_streams.RETENTION_OFFSET + i)
            decayed, dmask, n = _decay_leaf(rng.seed_u32(k), leaf, thr)
            out.append(decayed)
            masks[i] = masks[i] ^ dmask
            flips = flips + n
        step = state.step + steps
        state = dataclasses.replace(state, step=step, masks=tuple(masks),
                                    retention_flips=flips)
        if count_write:
            approx = self._approx
            state = dataclasses.replace(
                state, write_count=state.write_count + approx,
                last_write_step=torch.where(approx > 0, step,
                                            state.last_write_step))
        return self.plan.unflatten(out), state

    def clear_written(self, state: LifetimeState, pos: torch.Tensor,
                      active: torch.Tensor) -> LifetimeState:
        """Forget the decay record of what a decode step just re-wrote:
        the ring column at ``pos % C`` of each ACTIVE slot for sequence-
        axis leaves, the whole active row otherwise. Inactive slots keep
        their masks (their bits were carried through unchanged). Without
        this a stale mask bit on a later-written column would make the
        next scrub corrupt live data."""
        if self.immortal:
            return state
        masks = list(state.masks)
        for i, m in enumerate(masks):
            if m is None:
                continue
            rshape = [1] * m.dim()
            rshape[BATCH_AXIS] = active.shape[0]
            row = active.reshape(rshape)
            ax = self.plan.leaf_seq_axis[i]
            if ax is None:
                masks[i] = torch.where(row, torch.zeros_like(m), m)
                continue
            gshape = m.shape[:ax] + (1,) + m.shape[ax + 1:]
            idx = (pos % m.shape[ax]).reshape(rshape).expand(gshape)
            col = torch.gather(m, ax, idx)
            masks[i] = m.scatter(ax, idx, torch.where(
                row, torch.zeros_like(col), col))
        return dataclasses.replace(state, masks=tuple(masks))

    def reset_rows(self, state: LifetimeState, idx: torch.Tensor
                   ) -> LifetimeState:
        """Clear the decay masks of the slot rows ``idx`` (an int64 index
        tensor): a re-admitted slot's rows were freshly prefill-written."""
        masks = tuple(None if m is None else
                      m.index_fill(BATCH_AXIS, idx, 0)
                      for m in state.masks)
        return dataclasses.replace(state, masks=masks)

    def reset_rows_linked(self, state: LifetimeState, idx: torch.Tensor,
                          src: torch.Tensor, cols: torch.Tensor
                          ) -> LifetimeState:
        """Admission reset for prefix-linked slots: the rows ``idx``
        restart from zero like ``reset_rows``, except each slot's leading
        ``cols[b]`` ring columns, which were *linked* to slot ``src[b]``'s
        stored bits and so inherit its decay record for those columns
        (a later scrub corrects the linked copy as it corrects the
        owner). All-zero ``cols`` equals ``reset_rows(state, idx)``."""
        masks = []
        for i, m in enumerate(state.masks):
            if m is None:
                masks.append(None)
                continue
            sel = m.index_select(BATCH_AXIS, src)
            ax = self.plan.leaf_seq_axis[i]
            if ax is None:
                new = torch.zeros_like(sel)
            else:
                keep = self.plan.alias_keep(i, sel, cols)
                new = torch.where(keep, sel, torch.zeros_like(sel))
            masks.append(m.index_copy(BATCH_AXIS, idx, new))
        return dataclasses.replace(state, masks=tuple(masks))


@dataclasses.dataclass(frozen=True)
class RestoreIntegrity:
    """The checkpoint's pre-restore integrity pass
    (``train.checkpoint``): approximate leaves sat in NVM ``dwell_s``
    seconds at ``ambient_k`` kelvin, so their decay over that dwell is
    sampled, then (``scrub``) corrected and re-written through the
    checkpoint's backend, the re-write energy charged to the restore
    report. ``scrub=False`` hands the decayed values back as they are."""
    ambient_k: float = 350.0
    dwell_s: float = 3600.0
    scrub: bool = True
