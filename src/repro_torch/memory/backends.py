"""Pluggable write-path backends and the string-keyed registry.

The counterpart of ``repro.memory.backends``: every implementation of the
EXTENT write and of the scrub (corrective re-write) sits behind one
protocol,

    stored, stats = backend.leaf_write(key, old, new, leaf_vectors)
    scrubbed, residual, stats = backend.leaf_scrub(key, stored, mask,
                                                   leaf_vectors)

and is selected by name. Registered here:

  * ``"lanes_ref"`` — the plain-PyTorch lane twins (any device);
  * ``"cuda"``      — the hand-written CUDA kernels (the card's default);
    on CPU tensors their wrappers run the twins;
  * ``"exact"``     — passthrough, no approximation model.

The eager bit-unpacked ``"oracle"`` backend belongs to a later slice, and
so does the scrub fallback for widths without lane packing: every KV leaf
packs. ``key`` is a host threefry key (``repro_torch.rng``); the backend
turns it into the kernel's scalar seed on the host, so neither a write
nor a scrub reads the device.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Protocol, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.kernels.extent_write import kernel as xkernel
from repro_torch.kernels.extent_write import ops as xops
from repro_torch.kernels.extent_write import ref as xref
from repro_torch.kernels.scrub import kernel as skernel
from repro_torch.kernels.scrub import ops as sops
from repro_torch.kernels.scrub import ref as sref
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

    def leaf_scrub(self, key: np.ndarray, stored: torch.Tensor,
                   mask: torch.Tensor, lv: LeafVectors
                   ) -> Tuple[torch.Tensor, torch.Tensor, WriteStats]:
        """Corrective re-write of the decayed bits of ``stored`` (``mask``
        is the element-space decayed-bit mask, an integer tensor of the
        stored dtype's width and shape). Returns (scrubbed, residual mask,
        WriteStats); corrections that fail stay set in the residual."""
        ...


def _bits(x: torch.Tensor) -> int:
    return x.numel() * x.element_size() * 8


def _lane_stats(bits: int, device, st, lv: LeafVectors) -> WriteStats:
    flips = st["flips01"] + st["flips10"]
    return WriteStats.for_bits(
        bits, device, energy_pj=st["energy_pj"],
        # lane stats reduce per leaf, not per plane: report the plan
        # entry's slowest driver whenever anything flipped
        latency_ns=torch.where(flips > 0, lv.lat_max,
                               torch.zeros_like(lv.lat_max)),
        flips01=st["flips01"], flips10=st["flips10"], errors=st["errors"])


class LaneBackend:
    """Lane-packed write and scrub through ``impl`` and ``scrub_impl``
    (the twins or the CUDA wrappers), counter RNG over flat lane
    indices."""

    def __init__(self, name: str, impl: xops.LaneWrite,
                 scrub_impl: sops.LaneScrub):
        self.name = name
        self.impl = impl
        self.scrub_impl = scrub_impl

    def leaf_write(self, key, old, new, lv: LeafVectors):
        stored, st = xops.extent_write(
            rng.seed_u32(key), old, new,
            (lv.thr01, lv.thr10, lv.le01, lv.le10), self.impl)
        return stored, _lane_stats(_bits(old), old.device, st, lv)

    def leaf_scrub(self, key, stored, mask, lv: LeafVectors):
        scrubbed, residual, st = sops.scrub_write(
            rng.seed_u32(key), stored, mask,
            (lv.thr01, lv.thr10, lv.le01, lv.le10), self.scrub_impl)
        return scrubbed, residual, _lane_stats(_bits(stored),
                                               stored.device, st, lv)


class ExactBackend:
    """Passthrough: ``stored == new``, only the addressed bits counted."""
    name = "exact"

    def leaf_write(self, key, old, new, lv: LeafVectors):
        del key, lv
        assert old.shape == new.shape and old.dtype == new.dtype
        return new, WriteStats.for_bits(_bits(new), new.device)

    def leaf_scrub(self, key, stored, mask, lv: LeafVectors):
        """Perfect, free correction: the decayed bits are restored, the
        residual is clear, only the addressed bits are counted."""
        del key, lv
        bits = stored.view(mask.dtype)
        return ((bits ^ mask).view(stored.dtype), torch.zeros_like(mask),
                WriteStats.for_bits(_bits(stored), stored.device))


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
                 lambda: LaneBackend("lanes_ref", xref.extent_write_ref,
                                     sref.scrub_ref))
register_backend("cuda",
                 lambda: LaneBackend("cuda", xkernel.extent_write_cuda,
                                     skernel.scrub_cuda))
register_backend("exact", ExactBackend)
