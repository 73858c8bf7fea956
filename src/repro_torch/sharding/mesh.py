"""Device meshes: the serving die mesh (one logical STT-RAM slot pool over
N dies) and the training meshes.

The counterpart of ``repro.sharding.mesh``. ``DieMesh`` partitions a
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

``Mesh`` stands in for ``jax.sharding.Mesh``: an array of devices (or of
placeholder ids, for the rules' arithmetic) with axis names, and the
position of this process in it. The training mesh
(``make_production_mesh``) lays the ranks of the process group
(``repro_torch.device.start_process_group``) out as (data, model), one
rank a device, as the reference reshapes its devices: rank
``d * M + m`` at coordinates (d, m). Over a running group it also holds
this rank's process subgroup of each axis (``Mesh.groups``): the
``model`` group of its data row and the ``data`` group of its model
column. ``make_host_mesh`` is the one-device mesh.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import new_subgroups, rank_and_world, resolve_device

#: the named mesh axis the slot dimension is sharded over
DIE_AXIS = "die"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an n-d numpy array of devices (or ids), one axis per
    name in ``axis_names``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    #: this process's flat index into ``devices`` (its rank)
    rank: int = 0
    #: axis name -> this rank's process subgroup along it
    #: (``axis_groups``); None off a process group
    groups: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        assert self.devices.ndim == len(self.axis_names), (
            self.devices.shape, self.axis_names)
        assert 0 <= self.rank < self.devices.size, (self.rank,
                                                    self.devices.shape)

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's index along each axis: (d, m) on (data, model)."""
        return self.coords_of(self.rank)

    def coords_of(self, rank: int) -> Tuple[int, ...]:
        return tuple(int(i) for i in np.unravel_index(rank,
                                                      self.devices.shape))

    def index(self, axis: str, rank: Optional[int] = None) -> int:
        """``rank``'s (default this rank's) index along ``axis``."""
        rank = self.rank if rank is None else rank
        return self.coords_of(rank)[self.axis_names.index(axis)]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec (one entry per array axis: a mesh axis name, a tuple of
    them, or None) over a mesh; ``device`` is where this process places
    its part of the array."""
    mesh: Mesh
    spec: Tuple[Any, ...]

    @property
    def device(self) -> torch.device:
        return torch.device(self.mesh.devices.flat[self.mesh.rank])


def device_grid(devices: Sequence, shape: Tuple[int, ...]) -> np.ndarray:
    """An object array of ``shape`` holding ``devices`` in order."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr.reshape(shape)


def local_devices(device=None) -> List[torch.device]:
    """The devices a mesh may use: every CUDA device present (the
    default), or the one device asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1)."""
    for k in range(min(n, cap), 0, -1):
        if n % k == 0:
            return k
    return 1


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
    def device_mesh(self, device=None) -> Mesh:
        """1-D mesh over the ``die`` axis: its size is the largest divisor
        of ``n_dies`` the device count admits (1 on one card), so the dies
        fold evenly onto the devices."""
        devices = local_devices(device)
        k = _largest_divisor_leq(self.n_dies, len(devices))
        return Mesh(device_grid(devices[:k], (k,)), (DIE_AXIS,))

    def sharding_for(self, ndim: int, slot_axis: int, device=None
                     ) -> NamedSharding:
        """An array's ``slot_axis`` on the die axis, every other axis
        replicated."""
        spec = [None] * ndim
        spec[slot_axis] = DIE_AXIS
        return NamedSharding(self.device_mesh(device), tuple(spec))

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


# --------------------------------------------------------------------------
# training meshes


def group_devices(device=None) -> List[torch.device]:
    """One device a rank of the process group, in rank order: rank ``r``
    on ``cuda:r``, or every rank on the CPU. Without a group the process
    is a world of one."""
    dev = resolve_device(device)
    _, world = rank_and_world()
    if dev.type == "cuda":
        return [torch.device("cuda", r) for r in range(world)]
    return [dev] * world


def axis_groups(shape: Tuple[int, ...], axis_names: Tuple[str, ...]
                ) -> Dict[str, Any]:
    """This rank's process subgroup along each axis of a mesh of
    ``shape`` over the running group: for each axis in order, one group
    for each line of ranks along it (the others' indices fixed, in
    row-major order), every rank building every group in that order."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    out = {}
    for a, name in enumerate(axis_names):
        lines = np.moveaxis(ranks, a, -1).reshape(-1, shape[a])
        out[name] = new_subgroups([list(line) for line in lines])
    return out


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Tuple[int, ...]] = None,
                         device=None) -> Mesh:
    """The reference's pod mesh: (data=16, model=16), multi-pod (pod=2,
    16, 16); ``shape`` overrides the intra-pod (data, model) split. Over
    the ranks of the process group (``group_devices``), this process at
    its rank, with its axis subgroups when the group is running; a
    shape that does not cover the group exactly raises."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    elif multi_pod:
        shape = (2,) + tuple(shape)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devices = group_devices(device)
    if len(devices) != n:
        raise RuntimeError(f"need {n} devices for the production mesh, "
                           f"found {len(devices)} in the process group")
    rank, _ = rank_and_world()
    groups = (axis_groups(tuple(shape), axes) if dist.is_initialized()
              else None)
    return Mesh(device_grid(devices, tuple(shape)), axes, rank, groups)


def make_host_mesh(device=None) -> Mesh:
    """The one-device (data, model) mesh of the reduced runs."""
    return Mesh(device_grid(local_devices(device)[:1], (1, 1)),
                ("data", "model"))
