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
placeholder ids, for the rules' arithmetic) with axis names. The
training meshes (``make_production_mesh``, ``make_host_mesh``) are
built from the CUDA devices present, or from the CPU when it is asked
for; on one H100 they fold onto the card as (1, 1). The port runs no
program over more than one device: ``rules.make_constrain`` refuses a
mesh that has more than one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

#: the named mesh axis the slot dimension is sharded over
DIE_AXIS = "die"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an n-d numpy array of devices (or ids), one axis per
    name in ``axis_names``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        assert self.devices.ndim == len(self.axis_names), (
            self.devices.shape, self.axis_names)

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
    them, or None) over a mesh; ``device`` is where a one-device mesh
    places the array."""
    mesh: Mesh
    spec: Tuple[Any, ...]

    @property
    def device(self) -> torch.device:
        if self.mesh.size != 1:
            raise NotImplementedError(
                f"placement over a {self.mesh.shape} mesh: the port runs "
                "on one device")
        return torch.device(self.mesh.devices.flat[0])


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


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Tuple[int, ...]] = None,
                         device=None) -> Mesh:
    """The reference's pod mesh: (data=16, model=16), multi-pod (pod=2,
    16, 16); ``shape`` overrides the intra-pod (data, model) split. Over
    the devices ``local_devices(device)`` gives; asking for more than
    exist raises."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    elif multi_pod:
        shape = (2,) + tuple(shape)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devices = local_devices(device)
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices for the production mesh, "
                           f"found {len(devices)}")
    return Mesh(device_grid(devices[:n], tuple(shape)), axes)


def make_host_mesh(device=None) -> Mesh:
    """The one-device (data, model) mesh of the reduced runs."""
    return Mesh(device_grid(local_devices(device)[:1], (1, 1)),
                ("data", "model"))
