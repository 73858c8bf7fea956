"""The serving die mesh: one logical STT-RAM slot pool over N dies.

The serving half of ``repro.sharding.mesh``. ``DieMesh`` partitions a
``capacity``-slot pool along the SLOT axis: die ``d`` owns the
contiguous slot block ``[d * slots_per_die, (d + 1) * slots_per_die)``.
Every per-slot structure of the stack is slot-major (the pool cache's
batch axis, the ``slot_acc`` ledgers, the ``(L, G)`` row-group wear
counters with ``G = capacity * groups_per_slot``), so a die's state is a
contiguous slice of the pool-wide tensors and its ledger is a host
reshape-reduction: no device work.

The write and decay hashes run over FLAT logical element and lane
indices, so the die count is a layout choice: an N-die run is
bit-identical to the 1-die run while the dies are indistinguishable.
Per-die divergence (ambient temperature, scrub cadence, admission
steering) enters only through operands (per-slot threshold rows,
per-die slot masks, admission score biases) that collapse to the
1-die shapes while the dies are alike.

On one H100 every die folds onto the one card: ``shard_slots`` is an
identity, as the reference's placement is on a one-device host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence

import numpy as np
import torch

#: the named mesh axis the slot dimension is sharded over
DIE_AXIS = "die"


@dataclasses.dataclass(frozen=True)
class DieMesh:
    """Slot-axis partition of a ``capacity``-slot pool over ``n_dies``.
    Host metadata: construction touches no device."""
    n_dies: int
    capacity: int

    def __post_init__(self):
        assert self.n_dies >= 1, self.n_dies
        assert self.capacity % self.n_dies == 0, (
            f"pool capacity {self.capacity} must divide evenly over "
            f"{self.n_dies} dies — shard count is a layout choice, and a "
            "ragged last die would break the contiguous-slice layout")

    # ------------------------------------------------------------ layout
    @property
    def slots_per_die(self) -> int:
        return self.capacity // self.n_dies

    def die_of_slot(self, slot: int) -> int:
        return int(slot) // self.slots_per_die

    def slot_slice(self, die: int) -> slice:
        s = self.slots_per_die
        return slice(die * s, (die + 1) * s)

    def die_ids(self) -> np.ndarray:
        """(capacity,) int32 die index of every slot."""
        return np.repeat(np.arange(self.n_dies, dtype=np.int32),
                         self.slots_per_die)

    @functools.lru_cache(maxsize=None)
    def slot_mask(self, die: int, device) -> torch.Tensor:
        """(capacity,) bool tensor on ``device`` selecting one die's
        slots: the operand of a die-masked scrub pass. Built once per
        (die, device), so a pass uploads nothing."""
        return torch.from_numpy(self.die_ids() == die).to(device)

    # ----------------------------------------------------- per-die views
    def reduce_slots(self, per_slot: Any, op=np.sum) -> np.ndarray:
        """(capacity,)-leading host array -> (n_dies,) per-die reduction
        (the per-die ledger: energy, flips and errors of ``slot_acc``,
        the decayed bits of the lifetime masks)."""
        a = np.asarray(per_slot)
        return op(a.reshape(self.n_dies, self.slots_per_die, *a.shape[1:]),
                  axis=1)

    def reduce_wear(self, wear: Any, op=np.max) -> np.ndarray:
        """(L, G) host row-group wear -> (n_dies,) per-die reduction.
        ``G`` is slot-major (``capacity * groups_per_slot``, possibly
        padded with zeros), so each die's groups are one slice."""
        w = np.asarray(wear)
        gps = w.shape[1] // self.capacity
        w = w[:, :self.capacity * gps]
        return op(w.reshape(w.shape[0], self.n_dies, -1), axis=(0, 2))

    def per_slot(self, per_die: Sequence) -> np.ndarray:
        """(n_dies,) per-die values -> (capacity,) per-slot broadcast
        (admission score biases, per-slot operand rows)."""
        v = np.asarray(per_die)
        assert v.shape[0] == self.n_dies, (v.shape, self.n_dies)
        return np.repeat(v, self.slots_per_die, axis=0)

    # --------------------------------------------------------- placement
    def shard_slots(self, tree: Any, slot_axis: int) -> Any:
        """Place a slot-major tree through the die mesh: an identity on
        one card (every die lives on it), so placement never perturbs
        the bit-identity contract."""
        return tree


def uniform(values: Sequence) -> bool:
    """True when per-die values are indistinguishable: every per-die
    operand then collapses to its pool-wide shape and an N-die run is
    the 1-die run."""
    return len(set(values)) <= 1
