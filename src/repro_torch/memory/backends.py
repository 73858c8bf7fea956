"""Pluggable write-path backends and the string-keyed registry.

The counterpart of ``repro.memory.backends``: every implementation of the
EXTENT write sits behind one protocol,

    stored, stats = backend.leaf_write(key, old, new, leaf_vectors)

and is selected by name. Registered here:

  * ``"lanes_ref"`` — the plain-PyTorch lane twin (any device);
  * ``"cuda"``      — the hand-written CUDA kernel (the card's default);
    on CPU tensors its wrapper runs the twin;
  * ``"exact"``     — passthrough, no approximation model.

The eager bit-unpacked ``"oracle"`` backend and the scrub protocol belong
to later slices. ``key`` is a host threefry key (``repro_torch.rng``);
the backend turns it into the kernel's scalar seed on the host, so a
write never reads the device.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Protocol, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.kernels.extent_write import kernel as xkernel
from repro_torch.kernels.extent_write import ops as xops
from repro_torch.kernels.extent_write import ref as xref
from repro_torch.memory.stats import WriteStats


class LeafVectors(NamedTuple):
    """Device operands for one (dtype, effective level) pair: the lane
    layout's thresholds (int32 bit patterns of uint32 ``wer * 2^32``) and
    energies, and the slowest driver the entry uses."""
    thr01: torch.Tensor   # (32,) i32
    thr10: torch.Tensor   # (32,) i32
    le01: torch.Tensor    # (32,) f32 pJ per 0->1 flip, lane layout
    le10: torch.Tensor    # (32,) f32 pJ per 1->0 flip
    lat_max: torch.Tensor  # () f32 ns


class Backend(Protocol):
    name: str

    def leaf_write(self, key: np.ndarray, old: torch.Tensor,
                   new: torch.Tensor, lv: LeafVectors
                   ) -> Tuple[torch.Tensor, WriteStats]:
        ...


def _bits(x: torch.Tensor) -> int:
    return x.numel() * x.element_size() * 8


class LaneBackend:
    """Lane-packed write through ``impl`` (the twin or the CUDA wrapper),
    counter RNG over flat lane indices."""

    def __init__(self, name: str, impl: xops.LaneWrite):
        self.name = name
        self.impl = impl

    def leaf_write(self, key, old, new, lv: LeafVectors):
        stored, st = xops.extent_write(
            rng.seed_u32(key), old, new,
            (lv.thr01, lv.thr10, lv.le01, lv.le10), self.impl)
        flips = st["flips01"] + st["flips10"]
        return stored, WriteStats.for_bits(
            _bits(old), old.device, energy_pj=st["energy_pj"],
            # lane stats reduce per leaf, not per plane: report the plan
            # entry's slowest driver whenever anything flipped
            latency_ns=torch.where(flips > 0, lv.lat_max,
                                   torch.zeros_like(lv.lat_max)),
            flips01=st["flips01"], flips10=st["flips10"],
            errors=st["errors"])


class ExactBackend:
    """Passthrough: ``stored == new``, only the addressed bits counted."""
    name = "exact"

    def leaf_write(self, key, old, new, lv: LeafVectors):
        del key, lv
        assert old.shape == new.shape and old.dtype == new.dtype
        return new, WriteStats.for_bits(_bits(new), new.device)


_FACTORIES: Dict[str, Callable[[], Backend]] = {}
_INSTANCES: Dict[str, Backend] = {}


def register_backend(name: str, factory: Callable[[], Backend]) -> None:
    _FACTORIES[name] = factory
    _INSTANCES.pop(name, None)


def get_backend(name: str) -> Backend:
    if name not in _FACTORIES:
        raise KeyError(f"unknown memory backend {name!r}; registered: "
                       f"{', '.join(available_backends())}")
    if name not in _INSTANCES:
        _INSTANCES[name] = _FACTORIES[name]()
    return _INSTANCES[name]


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_FACTORIES))


def default_backend(device: torch.device) -> str:
    """The kernel on a CUDA device, the twin on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "lanes_ref"


register_backend("lanes_ref",
                 lambda: LaneBackend("lanes_ref", xref.extent_write_ref))
register_backend("cuda",
                 lambda: LaneBackend("cuda", xkernel.extent_write_cuda))
register_backend("exact", ExactBackend)
