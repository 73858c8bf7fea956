"""Physical addressing: the logical -> physical remap layer of the cache.

The counterpart of ``repro.memory.address``. Every path above this
module addresses stored columns *logically*: the KV ring column at
``pos % C``, the scrub cursor. This module owns the mapping from those
logical addresses to the *physical* rows of the modelled STT-RAM array,
so endurance wear — which the device accumulates per physical row, not
per logical name — can be tracked, spread and exhausted:

  * the map is an invertible per-leaf column **rotation** (start-gap
    style): ``phys = (logical + shift) % C``, ``logical = (phys - shift)
    % C``. The per-leaf shifts live in an ``AddressState`` of (L,) int64
    device tensors that the decode burst and the scrub pass take as
    operands, so a wear-leveling rotation between bursts changes a
    device integer and nothing reads it back on the host;
  * physical rows are accounted in **row groups** of ``group_cols`` ring
    columns per cache slot (each slot's ring is its own set of physical
    rows, so groups are indexed ``slot * ceil(C / group_cols) + phys_col
    // group_cols``). ``LifetimeState`` carries one write and one scrub
    wear counter per group;
  * groups whose cumulative wear reaches ``endurance_budget`` are
    **worn**: stuck-at rows whose bits no longer accept writes. The
    write path gates stores through ``worn_*_mask`` — a worn bit keeps
    its old value, the lost flips land in ``WriteStats.errors``, and
    (because the gated new value equals the stored one) CMP charges no
    energy for the inhibited drive.

RNG layout invariance: the remap permutes *addresses*, never RNG
streams. The data tree stays the logical view (the model reads it as it
is) and every counter hash keeps indexing flat elements of the logical
tensor, so an identity-shift run is bit-identical to a plan with no
address layer; rotation moves *which physical group a write wears out
and which stuck-at rows a write hits*, not which bits the driver flips.

Every function here is plain torch on device tensors (shifts, positions
and worn maps stay on the device, so the burst reads none of them back);
group counts accumulate with ``index_add``, which keeps duplicate
indices, as ``jnp.zeros(...).at[g].add(x)`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

IntLike = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AddressSpec:
    """Static config of the addressing layer of one WritePlan.

    ``group_cols``: ring columns per physical row group (the wear and
    failure granularity). ``endurance_budget``: writes plus scrubs a row
    group survives before its rows go stuck-at; 0 means unbounded (wear
    is tracked but nothing fails)."""
    group_cols: int = 8
    endurance_budget: int = 0

    def col_groups(self, n_cols: int) -> int:
        """Row groups per slot of an ``n_cols``-column ring."""
        return -(-int(n_cols) // self.group_cols)

    def n_groups(self, shape: Sequence[int], seq_axis: Optional[int],
                 batch_axis: int) -> int:
        """Row groups of one leaf: ``slots * ceil(C / group_cols)`` for a
        ring leaf, one group per slot row otherwise."""
        b = int(shape[batch_axis])
        if seq_axis is None:
            return b
        return b * self.col_groups(shape[seq_axis])


# ---------------------------------------------------------------------------
# the permutation
# ---------------------------------------------------------------------------

def phys_col(logical: IntLike, shift: IntLike, n_cols: int) -> IntLike:
    """Logical ring column -> the physical row backing it."""
    return (logical + shift) % n_cols


def logical_col(phys: IntLike, shift: IntLike, n_cols: int) -> IntLike:
    """Physical row -> the logical column it currently backs."""
    return (phys - shift) % n_cols


def column_group_ids(pos: torch.Tensor, shift: IntLike, n_cols: int,
                     spec: AddressSpec) -> torch.Tensor:
    """(B,) int64 physical row group per slot of a column write at
    ``pos``: ``slot * Gc + phys // group_cols``."""
    gc = spec.col_groups(n_cols)
    p = phys_col(pos % n_cols, shift, n_cols)
    slot = torch.arange(pos.shape[0], dtype=torch.int64, device=pos.device)
    return slot * gc + torch.div(p, spec.group_cols, rounding_mode="floor")


def worn_slot_mask(worn_row: torch.Tensor, pos: torch.Tensor,
                   shift: IntLike, n_cols: int,
                   spec: AddressSpec) -> torch.Tensor:
    """(B,) bool: is the physical group backing slot b's column write at
    ``pos[b]`` worn out? ``worn_row`` is the leaf's (G,) worn vector."""
    return worn_row[column_group_ids(pos, shift, n_cols, spec)]


def _axis_iota(n: int, axis: int, ndim: int,
               device: torch.device) -> torch.Tensor:
    """``arange(n)`` shaped to broadcast along ``axis`` of an
    ``ndim``-dimensional tensor."""
    shape = [1] * ndim
    shape[axis] = n
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def worn_element_mask(worn_row: torch.Tensor, shift: IntLike,
                      shape: Sequence[int], seq_axis: Optional[int],
                      batch_axis: int, spec: AddressSpec, *,
                      cols: Optional[torch.Tensor] = None,
                      n_cols: Optional[int] = None) -> torch.Tensor:
    """Bool mask, broadcastable to ``shape``, of the elements backed by
    worn physical groups: the stuck-at gate of a full-tree write.

    For a span gathered from the ring (a windowed scrub), ``cols`` is the
    (W,) int64 logical column of each position along ``seq_axis`` and
    ``n_cols`` the ring's length; by default the span is the whole ring
    in order."""
    nd = len(shape)
    dev = worn_row.device
    slot = _axis_iota(shape[batch_axis], batch_axis, nd, dev)
    if seq_axis is None:
        return worn_row[slot]
    if n_cols is None:
        n_cols = shape[seq_axis]
    gc = spec.col_groups(n_cols)
    if cols is None:
        col = _axis_iota(n_cols, seq_axis, nd, dev)
    else:
        cshape = [1] * nd
        cshape[seq_axis] = cols.shape[0]
        col = cols.reshape(cshape)
    g = slot * gc + torch.div(phys_col(col, shift, n_cols),
                              spec.group_cols, rounding_mode="floor")
    return worn_row[g]


def slot_window_group_counts(idx: torch.Tensor, start: torch.Tensor,
                             end: torch.Tensor, shift: IntLike,
                             n_cols: int, n_groups: int,
                             spec: AddressSpec) -> torch.Tensor:
    """Admission wear of per-slot *logical* column windows: slot
    ``idx[b]`` re-drove the ring columns ``[start[b], end[b])`` of one
    leaf (an admission prefill; with a prefix link, ``start`` skips the
    linked columns, so shared prefix columns wear once, at their owner's
    admission). Returns (n_groups,) int64 row re-writes per physical
    group, each window mapped through the rotation."""
    gc = spec.col_groups(n_cols)
    col = torch.arange(n_cols, dtype=torch.int64, device=idx.device)
    wrote = (col[None, :] >= start[:, None]) & (col[None, :] < end[:, None])
    g = idx[:, None] * gc + torch.div(phys_col(col, shift, n_cols),
                                      spec.group_cols,
                                      rounding_mode="floor")[None, :]
    return torch.zeros((n_groups,), dtype=torch.int64,
                       device=idx.device).index_add(
        0, g.reshape(-1), wrote.to(torch.int64).reshape(-1))


def window_group_counts(cursor: IntLike, cols: int, n_cols: int,
                        n_slots: int, n_groups: int, spec: AddressSpec,
                        device) -> torch.Tensor:
    """Scrub wear of a ``cols``-wide *physical* ring window starting at
    ``cursor``: (n_groups,) int64 row re-writes per group (one per
    covered column per slot)."""
    gc = spec.col_groups(n_cols)
    pg = torch.div((cursor + torch.arange(cols, dtype=torch.int64,
                                          device=device)) % n_cols,
                   spec.group_cols, rounding_mode="floor")
    g = (torch.arange(n_slots, dtype=torch.int64, device=device)[:, None]
         * gc + pg[None, :]).reshape(-1)
    return torch.zeros((n_groups,), dtype=torch.int64,
                       device=device).index_add(0, g, torch.ones_like(g))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AddressState:
    """Per-leaf permutation state on the device.

    ``shifts``: (L,) int64 rotation offsets (0 = identity, bit-identical
    to a plan with no address layer). ``rotations``: (L,) int64 rotation
    count per leaf."""
    shifts: torch.Tensor
    rotations: torch.Tensor

    @classmethod
    def identity(cls, n_leaves: int, device) -> "AddressState":
        z = torch.zeros((n_leaves,), dtype=torch.int64, device=device)
        return cls(shifts=z, rotations=z)

    def rotate(self, rotatable: torch.Tensor, step: int = 1
               ) -> "AddressState":
        """Advance the permutation of every ``rotatable`` leaf ((L,) bool)
        by ``step`` columns: device arithmetic on the same operands."""
        r = rotatable.to(torch.int64)
        return AddressState(shifts=self.shifts + step * r,
                            rotations=self.rotations + r)

