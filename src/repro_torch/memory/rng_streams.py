"""RNG sub-stream registry: the fold constants of the ported slices.

The slice of ``repro.memory.rng_streams`` the serving path uses, with the
same names and values. Domains (who the parent key is):

  * ``step-write-key``    — the per-step write key the burst splits
                            (``k_write``): the write plan folds the flat
                            leaf index ``i`` (offset 0), retention decay
                            folds ``RETENTION_OFFSET + i`` and a scrub
                            pass ``SCRUB_OFFSET + i`` off its pass key;
  * ``serve-decode-root`` — the scheduler's carried decode key: scrub
                            pass ``n`` folds
                            ``SCHEDULER_SCRUB_PASS_OFFSET + n`` off it.

The counter hash the lane kernels, their twins and the decay sampler
share is keyed on (seed, flat index, bit plane). The soft-error,
checkpoint and workload streams belong to slices not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from repro_torch.kernels.extent_write.ref import (  # noqa: F401
    K_BIT, K_ELEM, hash_u32)


class Stream(NamedTuple):
    name: str
    offset: int
    domain: str
    doc: str
    #: fold constants the stream occupies: per-index streams fold
    #: ``offset + i`` and reserve [offset, offset + span)
    span: int = 1


#: WritePlan folds the flat leaf index directly into the step write key.
WRITE_LEAF_OFFSET = 0
#: LifetimePlan.advance per-leaf decay sub-streams.
RETENTION_OFFSET = 2_000_003
#: scrub_tree per-leaf corrective-re-write sub-streams.
SCRUB_OFFSET = 3_000_017
#: ContinuousScheduler's per-pass scrub key, folded off the decode root.
SCHEDULER_SCRUB_PASS_OFFSET = 1_000_000

#: the spacing of the per-index counter-hash sub-streams.
INDEX_SPAN = 1_000_000

STREAMS: Tuple[Stream, ...] = (
    Stream("write-leaf", WRITE_LEAF_OFFSET, "step-write-key",
           "WritePlan leaf writes: fold_in(k_write, i)", span=INDEX_SPAN),
    Stream("retention-decay", RETENTION_OFFSET, "step-write-key",
           "LifetimePlan.advance decay sampler: fold_in(k_write, off + i)",
           span=INDEX_SPAN),
    Stream("scrub-correct", SCRUB_OFFSET, "step-write-key",
           "scrub_tree corrective re-writes: fold_in(k, off + i)",
           span=INDEX_SPAN),
    Stream("scheduler-scrub-pass", SCHEDULER_SCRUB_PASS_OFFSET,
           "serve-decode-root",
           "one key per scrub pass: fold_in(key, off + pass_index)",
           span=INDEX_SPAN),
)


def validate(streams: Optional[Tuple[Stream, ...]] = None) -> None:
    """Assert the registry is collision-free: within a parent-key domain
    no two streams share an offset, and no offset lands inside another
    stream's reserved range ``[offset, offset + span)``."""
    streams = STREAMS if streams is None else streams
    seen = {}
    for s in streams:
        key = (s.domain, s.offset)
        assert key not in seen, (
            f"stream '{s.name}' collides with '{seen[key]}' on {key}")
        seen[key] = s.name
    by_domain = {}
    for s in streams:
        by_domain.setdefault(s.domain, []).append(s)
    for domain, group in by_domain.items():
        group = sorted(group, key=lambda s: s.offset)
        for a, b in zip(group, group[1:]):
            assert a.offset + a.span <= b.offset, (
                f"stream '{b.name}' (offset {b.offset}) lands inside "
                f"'{a.name}'s reserved range [{a.offset}, "
                f"{a.offset + a.span}) in domain '{domain}'")
