"""Pluggable write-path backends and the string-keyed registry.

The counterpart of ``repro.memory.backends``: every implementation of the
EXTENT write and of the scrub (corrective re-write) sits behind one
protocol,

    stored, stats = backend.leaf_write(key, old, new, leaf_vectors)
    scrubbed, residual, stats = backend.leaf_scrub(key, stored, mask,
                                                   leaf_vectors)

and is selected by name. Registered here:

  * ``"oracle"``    — the eager bit-unpacked write (``core.approx_store``:
                      one threefry uniform per (element, bit), bit-exact
                      with the JAX oracle) on any device;
  * ``"lanes_ref"`` — the plain-PyTorch lane twins (any device);
  * ``"cuda"``      — the hand-written CUDA kernels (the card's default);
                      on CPU tensors their wrappers run the twins;
  * ``"exact"``     — passthrough, no approximation model.

Every backend but ``exact`` scrubs through the lane scrub (``scrub.cu``
on the card, its twin on the CPU; bit-identical), and falls back for
element widths without lane packing (8-byte floats): the write to the
oracle, the scrub to ``_planes_scrub``. ``key`` is a host threefry key
(``repro_torch.rng``); the backend turns it into the kernel's scalar seed
or the oracle's counters on the host, so neither a write nor a scrub
reads the device.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import approx_store
from repro_torch.core.priority import bits_of, int_type
from repro_torch.kernels.extent_write import kernel as xkernel
from repro_torch.kernels.extent_write import ops as xops
from repro_torch.kernels.extent_write import ref as xref
from repro_torch.kernels.scrub import kernel as skernel
from repro_torch.kernels.scrub import ops as sops
from repro_torch.kernels.scrub import ref as sref
from repro_torch.memory.stats import WriteStats


class LeafVectors(NamedTuple):
    """Device operands for one (dtype, effective level) pair. The
    per-bit-plane vectors drive the oracle; the lane quadruple (int32 bit
    patterns of uint32 ``wer * 2^32`` thresholds, lane-layout energies)
    drives the lane paths and is ``None`` for widths without lane
    packing."""
    wer01: torch.Tensor   # (ebits,) f32 failure probability, 0->1
    wer10: torch.Tensor   # (ebits,) f32 failure probability, 1->0
    eb01: torch.Tensor    # (ebits,) f32 pJ per 0->1 flip
    eb10: torch.Tensor    # (ebits,) f32 pJ per 1->0 flip
    lat: torch.Tensor     # (ebits,) f32 driver latency (ns)
    lat_max: torch.Tensor  # () f32 ns: the slowest driver of the entry
    thr01: Optional[torch.Tensor]  # (32,) i32
    thr10: Optional[torch.Tensor]  # (32,) i32
    le01: Optional[torch.Tensor]   # (32,) f32 pJ per 0->1 flip, lane layout
    le10: Optional[torch.Tensor]   # (32,) f32 pJ per 1->0 flip


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


def _planes_scrub(stored: torch.Tensor, mask: torch.Tensor,
                  lv: LeafVectors):
    """Element-space scrub for widths without lane packing: perfect
    correction (no stochastic failure modelled), per-plane energy from
    the bit-plane vectors. Keeps the scrub total over every dtype the
    write path accepts."""
    nbits = bits_of(stored.dtype)
    s = stored.view(int_type(stored.dtype))
    corrected = s ^ mask
    shift = torch.arange(nbits, dtype=torch.int64, device=stored.device)
    rewrite = ((mask.reshape(-1, 1).to(torch.int64) >> shift) & 1).bool()
    to_ap = rewrite & ((corrected.reshape(-1, 1).to(torch.int64) >> shift)
                       & 1).bool()
    f01 = to_ap.sum(0)
    f10 = (rewrite & ~to_ap).sum(0)
    energy = approx_store.plane_energy(f01, f10, lv.eb01, lv.eb10)
    flips = f01.sum() + f10.sum()
    st = WriteStats.for_bits(
        _bits(stored), stored.device, energy_pj=energy,
        latency_ns=torch.where(flips > 0, lv.lat_max,
                               torch.zeros_like(lv.lat_max)),
        flips01=f01.sum(), flips10=f10.sum())
    return corrected.view(stored.dtype), torch.zeros_like(mask), st


class _LaneScrub:
    """``leaf_scrub`` over the lane scrub ``scrub_impl``: one RNG contract
    (the flat-lane counter hash) for every backend, so all of them agree
    on a scrub's residuals bit for bit."""
    scrub_impl: sops.LaneScrub

    def leaf_scrub(self, key, stored, mask, lv: LeafVectors):
        if lv.thr01 is None:  # no lane packing for this width
            return _planes_scrub(stored, mask, lv)
        scrubbed, residual, st = sops.scrub_write(
            rng.seed_u32(key), stored, mask,
            (lv.thr01, lv.thr10, lv.le01, lv.le10), self.scrub_impl)
        return scrubbed, residual, _lane_stats(_bits(stored),
                                               stored.device, st, lv)


class OracleBackend(_LaneScrub):
    """The eager bit-unpacked write (threefry uniforms per (element,
    bit)); scrubs through the CUDA scrub wrapper (the twin on the CPU)."""
    name = "oracle"
    scrub_impl = skernel.scrub_cuda

    def leaf_write(self, key, old, new, lv: LeafVectors):
        stored, d = approx_store.oracle_write(
            key, old, new, lv.wer01, lv.wer10, lv.eb01, lv.eb10, lv.lat)
        return stored, WriteStats.for_bits(
            _bits(old), old.device, energy_pj=d["energy_pj"],
            latency_ns=d["latency_ns"], flips01=d["flips01"],
            flips10=d["flips10"], errors=d["errors"])


class LaneBackend(_LaneScrub):
    """Lane-packed write and scrub through ``impl`` and ``scrub_impl``
    (the twins or the CUDA wrappers), counter RNG over flat lane
    indices; widths without lane packing write through the oracle."""

    def __init__(self, name: str, impl: xops.LaneWrite,
                 scrub_impl: sops.LaneScrub):
        self.name = name
        self.impl = impl
        self.scrub_impl = scrub_impl
        self._oracle = OracleBackend()

    def leaf_write(self, key, old, new, lv: LeafVectors):
        if lv.thr01 is None:  # no lane packing for this width
            return self._oracle.leaf_write(key, old, new, lv)
        stored, st = xops.extent_write(
            rng.seed_u32(key), old, new,
            (lv.thr01, lv.thr10, lv.le01, lv.le10), self.impl)
        return stored, _lane_stats(_bits(old), old.device, st, lv)


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


register_backend("oracle", OracleBackend)
register_backend("lanes_ref",
                 lambda: LaneBackend("lanes_ref", xref.extent_write_ref,
                                     sref.scrub_ref))
register_backend("cuda",
                 lambda: LaneBackend("cuda", xkernel.extent_write_cuda,
                                     skernel.scrub_cuda))
register_backend("exact", ExactBackend)
