"""RNG sub-stream registry: the fold constants of the ported slice.

The slice of ``repro.memory.rng_streams`` the serving path uses. The
write plan folds the flat leaf index ``i`` straight into the step's write
key (offset 0, ``fold_in(k_write, i)``); the counter hash the extent
write kernel and its twin share is keyed on (seed, flat lane index, bit
plane). The soft-error, retention, scrub and workload streams belong to
slices not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

from repro_torch.kernels.extent_write.ref import (  # noqa: F401
    K_BIT, K_ELEM, hash_u32)


class Stream(NamedTuple):
    name: str
    offset: int
    domain: str
    doc: str
    span: int = 1


#: WritePlan folds the flat leaf index directly into the step write key.
WRITE_LEAF_OFFSET = 0
INDEX_SPAN = 1_000_000

STREAMS: Tuple[Stream, ...] = (
    Stream("write-leaf", WRITE_LEAF_OFFSET, "step-write-key",
           "WritePlan leaf writes: fold_in(k_write, i)", span=INDEX_SPAN),
)
