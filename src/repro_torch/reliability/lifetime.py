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
``retention_flips`` (all sampled decay flips). The per-die vectors, the
row-group wear counters and the checkpoint integrity pass belong to
later slices.
"""
from __future__ import annotations

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
from repro_torch.kernels.extent_write.ref import M32, mul32
from repro_torch.memory import rng_streams
from repro_torch.memory.plan import BATCH_AXIS, WritePlan
from repro_torch.memory.rng_streams import K_BIT, K_ELEM, hash_u32

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


@functools.lru_cache(maxsize=8)
def _elem_hash_base(n: int, device: torch.device) -> torch.Tensor:
    """``(flat element index * K_ELEM) mod 2^32`` for ``n`` elements — the
    seed-independent half of the counter hash, built once per size."""
    return mul32(torch.arange(n, dtype=torch.int64, device=device), K_ELEM)


def _to_int_bits(v: torch.Tensor, nbits: int, dtype: torch.dtype
                 ) -> torch.Tensor:
    """int64 values in [0, 2^nbits) -> the ``dtype`` tensor of the same
    bits."""
    return (v - ((v >> (nbits - 1)) << nbits)).to(dtype)


def _decay_leaf(seed: int, x: torch.Tensor, thr: np.ndarray
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample retention flips on every stored bit of ``x``: counter hash
    over (seed, flat element index, bit plane). Returns (decayed, flip
    mask (``int_type`` view), n_flips int64). Planes with a zero
    threshold are skipped; with all of them zero this is an identity."""
    it = int_type(x.dtype)
    nbits = bits_of(x.dtype)
    base = (_elem_hash_base(x.numel(), x.device).reshape(x.shape)
            ^ (int(seed) & M32))
    strike = torch.zeros_like(base)
    flips = torch.zeros((), dtype=torch.int64, device=x.device)
    for b in range(nbits):
        if thr[b] == 0:
            continue
        u = hash_u32(base ^ ((b * K_BIT) & M32))
        hit = u < int(thr[b])
        strike = strike | (hit.to(torch.int64) << b)
        flips = flips + hit.sum()
    mask = _to_int_bits(strike, nbits, it)
    return (x.view(it) ^ mask).view(x.dtype), mask, flips


def popcount(m: torch.Tensor) -> torch.Tensor:
    """Set bits of an integer tensor, summed to a 0-d int64 (a 256-entry
    byte table: torch has no popcount)."""
    table = _byte_popcount(m.device)
    return table[m.contiguous().view(torch.uint8).to(torch.int64)].sum()


@functools.lru_cache(maxsize=4)
def _byte_popcount(device: torch.device) -> torch.Tensor:
    return torch.tensor([bin(v).count("1") for v in range(256)],
                        dtype=torch.int64, device=device)


@dataclasses.dataclass(frozen=True)
class LifetimeState:
    """Per-region lifetime state: device tensors, one mask per flat leaf
    (``None`` for exact leaves) and (L,) int64 per-leaf counters."""
    step: torch.Tensor                         # () i64 decode-step clock
    masks: Tuple[Optional[torch.Tensor], ...]  # decayed-bit XOR masks
    write_count: torch.Tensor                  # (L,) i64 writes per leaf
    scrub_count: torch.Tensor                  # (L,) i64 scrub passes
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

    # ------------------------------------------------------------- operands
    def vectors_for(self, floor: Priority = Priority.LOW,
                    ambient_k: Optional[float] = None
                    ) -> Tuple[Optional[np.ndarray], ...]:
        """Per-leaf decay thresholds for one (floor, ambient) pair —
        ``None`` for exact leaves. The ambient override is how a
        temperature schedule runs: the host swaps operands between
        bursts."""
        t_k = self.ambient_k if ambient_k is None else float(ambient_k)
        floor = Priority.coerce(floor)
        return tuple(
            _retention_thresholds(dt, max(lvl, floor), t_k, self.dwell_s)
            if lvl is not None else None
            for dt, lvl in zip(self.leaf_dtypes, self.plan.leaf_levels))

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
        z = torch.zeros((), dtype=torch.int64, device=self.plan.device)
        return LifetimeState(step=z, masks=masks, write_count=zl,
                             scrub_count=zl, retention_flips=z,
                             last_write_step=zl, last_scrub_step=zl)

    # -------------------------------------------------------------- advance
    def advance(self, key: np.ndarray, tree: Any, state: LifetimeState,
                vectors: Optional[Sequence[Optional[np.ndarray]]] = None
                ) -> Tuple[Any, LifetimeState]:
        """One decode step's dwell: sample decay on every stored bit of
        the approximate leaves, XOR the flips into the masks, bump the
        clock and the write counters (the step re-wrote the leaves before
        dwelling). Reads nothing from the device. ``key`` is the step's
        write key; leaf ``i`` folds ``RETENTION_OFFSET + i`` off it, so
        the write and sampling schedule is the same with retention on or
        off."""
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
        step = state.step + 1
        approx = self._approx
        return T.unflatten(list(self.plan.paths), out), dataclasses.replace(
            state, step=step, masks=tuple(masks), retention_flips=flips,
            write_count=state.write_count + approx,
            last_write_step=torch.where(approx > 0, step,
                                        state.last_write_step))

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
