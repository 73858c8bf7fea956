"""Lane packing, level vectors and the write entry of the extent_write kernel.

The counterpart of ``repro.kernels.extent_write.ops``:

  * ``level_vectors`` resolves (element dtype, level) to the per-plane
    (thr01, thr10, e01, e10) vectors with the bit-plane priority policy
    applied, widened to the 32-bit lane layout (a 16-bit element's 16
    planes tile twice across a lane, an 8-bit element's 8 planes four
    times);
  * ``to_lanes`` / ``from_lanes`` bitcast a 1/2/4-byte tensor to a flat
    int32 lane vector (uint32 bit patterns): 4 int8, 2 bf16/f16 or 1 f32
    element per lane, little-endian, the ragged tail zero-padded;
  * ``extent_write`` packs, calls a lane write (the twin or the CUDA
    wrapper), and unpacks.

This module is plumbing for ``repro_torch.memory``: everything else goes
through the backend registry there.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import write_driver
from repro_torch.core.priority import Priority, bitplane_priorities

_SUB = {1: torch.int8, 2: torch.int16, 4: torch.int32}


@functools.lru_cache(maxsize=64)
def level_vectors(dtype: torch.dtype, level: Priority
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host (thr01 uint32, thr10 uint32, e01 f32, e10 f32), each (32,),
    from the default driver's level table."""
    table = write_driver.level_table()
    codes = bitplane_priorities(dtype, Priority.coerce(level))
    vecs = [table[k][codes] for k in ("wer01", "wer10", "e01", "e10")]
    ebits = codes.shape[0]
    if ebits in (8, 16):
        vecs = [np.tile(v, 32 // ebits) for v in vecs]

    def to_thr(w):
        return (np.clip(w, 0.0, 1.0) * 2 ** 32).astype(np.uint64).clip(
            0, 2 ** 32 - 1).astype(np.uint32)

    return (to_thr(vecs[0]), to_thr(vecs[1]),
            vecs[2].astype(np.float32), vecs[3].astype(np.float32))


def to_lanes(x: torch.Tensor) -> torch.Tensor:
    """Any 1/2/4-byte tensor -> flat (ceil(bytes/4),) int32 lanes."""
    nbytes = x.element_size()
    if nbytes not in _SUB:
        raise ValueError(f"no lane packing for {x.dtype}")
    flat = x.contiguous().view(_SUB[nbytes]).reshape(-1)
    per = 4 // nbytes
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(torch.int32)


def from_lanes(u: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    n = int(np.prod(shape))
    return u.view(_SUB[dtype.itemsize])[:n].view(dtype).reshape(shape)


LaneWrite = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def extent_write(seed: int, old: torch.Tensor, new: torch.Tensor,
                 vectors: Tuple[torch.Tensor, ...], impl: LaneWrite
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """EXTENT approximate write of ``new`` over ``old`` through the lane
    write ``impl``. ``vectors`` are the device (thr01, thr10, e01, e10)
    operands; ``seed`` is the host uint32 seed of the counter hash.
    Returns (stored, {energy_pj, flips01, flips10, errors})."""
    assert old.shape == new.shape and old.dtype == new.dtype
    stored_u, stats = impl(to_lanes(old), to_lanes(new), seed, *vectors)
    return from_lanes(stored_u, old.shape, old.dtype), stats
