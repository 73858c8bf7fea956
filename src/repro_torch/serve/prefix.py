"""Content-addressable prefix cache: cross-request KV reuse at admission.

A copy of ``repro.serve.prefix`` (numpy and hashlib only), so digests,
lookups, LRU order and the CAM energy model are the reference's.

Millions of users means massive prompt overlap — system prompts, few-shot
headers, shared document contexts. The cheapest STT-RAM write is the one
never issued: when an arriving request's leading prompt tokens match a
prefix that is already resident in the slot pool, admission can *link* its
leading KV columns to the owner's physical columns instead of re-driving
them, extending the substrate's redundant-write elimination from
within-request (CMP bit diffing, evicted-row diffing) to **cross-request**
sharing. A linked column skips the stochastic write entirely, so a prefix
hit saves write energy *and* write-error (WER) exposure at once.

The match stage is modeled as a small CAM (content-addressable memory) in
front of slot admission, with the same bounded-capacity / traffic-counter
accounting discipline as the ``ExtentTable`` (core/extent_table.py — the
paper's Fig. 11 SRAM structure): entries are keyed by a running digest of
``chunk``-token prompt chunks, capacity pressure evicts LRU entries, and
every lookup/insertion/eviction lands in exported counters. A lookup
broadcasts the search digest across every occupied match line, so its
modeled energy scales with occupancy — searching an over-provisioned CAM
is not free, and the report's ``net_energy_saved_pj`` subtracts it.

Entry validity rides a **generation** check instead of eager invalidation:
each slot-pool admission bumps the slot's generation, and a match whose
recorded generation no longer equals the slot's current one is dropped at
lookup time (counted as ``stale_drops``) — the columns it named have been
overwritten by a later admission. Released-but-not-overwritten slots keep
their generation, so their resident prefix bits stay linkable: the
evicted-row story, cross-request.

Everything here is HOST-side bookkeeping (like the slot pool's free list):
admission times are host-predictable scheduler events, and the digesting
runs on host token bytes the scheduler reads once per admitted request,
at admission, outside any decode burst. No device code.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

#: digest width of one CAM match line (blake2b-128). At 128 bits a
#: same-digest collision between distinct prefixes is negligible
#: (~2^-64 at any realistic occupancy), so a digest match is treated as a
#: content match — the standard content-addressable-cache approximation.
DIGEST_BITS = 128

#: modeled CAM search energy: fJ per match-line bit per lookup. NOR-style
#: match lines precharge/discharge once per search; ~1 fJ/bit/search is
#: the order reported for small SRAM-based CAMs at modern nodes, and the
#: exact constant only scales the (reported, subtracted) search overhead.
CAM_MATCH_FJ_PER_BIT = 1.0


@dataclasses.dataclass(frozen=True)
class PrefixConfig:
    """Static config of the prefix-cache match stage.

    ``chunk``: prompt tokens per digest chunk — the match granularity (a
    prefix matches in whole chunks only). ``table_size``: CAM entries; the
    LRU capacity pressure of a small physical structure."""
    chunk: int = 8
    table_size: int = 256


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """One resolved admission match: link the first ``cols`` cache columns
    to slot ``slot``'s resident columns (``tokens`` of them are prompt
    tokens; for multimodal prompts ``cols`` also covers the leading
    image/frame columns, which the extra-leaf digest guarantees equal)."""
    slot: int
    cols: int
    tokens: int

    def span_args(self) -> Dict[str, int]:
        """Telemetry attribution for a linked admission's prefill span
        (``repro.telemetry``): which resident slot the prefix linked to
        and how many columns the link covers."""
        return {"linked_owner": self.slot, "linked_cols": self.cols,
                "linked_tokens": self.tokens}


class PrefixCache:
    """Bounded-LRU CAM model mapping prompt-prefix digests to resident
    slot columns, with ExtentTable-style traffic accounting."""

    def __init__(self, cfg: PrefixConfig):
        assert cfg.chunk >= 1 and cfg.table_size >= 1
        self.cfg = cfg
        # digest -> (slot, cols, tokens, generation); insertion-ordered =
        # LRU order (move_to_end on hit, popitem(last=False) on pressure)
        self._map: "Dict[bytes, Tuple[int, int, int, int]]" = {}
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.insertions = 0
        self.stale_drops = 0
        self.cam_energy_pj = 0.0

    # ------------------------------------------------------------- digests
    @staticmethod
    def _extra_digest(prompt: Dict[str, np.ndarray]) -> bytes:
        """Digest of every non-token prompt leaf (image embeds, audio
        frames). Folded into every chunk digest, so multimodal requests
        only match when their non-text context is bit-identical — the
        leading image/frame columns are then identical too, and a match
        may cover them."""
        h = hashlib.blake2b(digest_size=DIGEST_BITS // 8)
        for name in sorted(prompt):
            if name == "tokens":
                continue
            leaf = prompt[name]
            h.update(name.encode())
            h.update(str(leaf.dtype).encode())
            h.update(np.ascontiguousarray(leaf).tobytes())
        return h.digest()

    def signatures(self, prompt: Dict[str, np.ndarray]
                   ) -> List[Tuple[bytes, int]]:
        """Running chunk digests of a HOST prompt dict: one ``(digest,
        n_tokens)`` per whole ``chunk``-token prefix depth, shallowest
        first. The digest chain is cumulative (chunk k's digest folds
        chunk k-1's), so equal digests mean equal *whole prefixes*, not
        just equal chunks."""
        # the prompt dict is HOST data (the scheduler's one read per
        # admitted request) — no transfer happens here
        toks = np.ascontiguousarray(prompt["tokens"],
                                    dtype=np.int64).reshape(-1)
        extra = self._extra_digest(prompt)
        out: List[Tuple[bytes, int]] = []
        running = extra
        for depth in range(1, toks.size // self.cfg.chunk + 1):
            chunk = toks[(depth - 1) * self.cfg.chunk:
                         depth * self.cfg.chunk]
            h = hashlib.blake2b(digest_size=DIGEST_BITS // 8)
            h.update(running)
            h.update(chunk.tobytes())
            running = h.digest()
            out.append((running, depth * self.cfg.chunk))
        return out

    # ------------------------------------------------------------ CAM model
    def _search_energy(self) -> float:
        """Energy (pJ) of ONE parallel CAM search at current occupancy:
        every occupied match line compares all DIGEST_BITS bits."""
        return len(self._map) * DIGEST_BITS * CAM_MATCH_FJ_PER_BIT * 1e-3

    # ------------------------------------------------------------- requests
    def lookup(self, signatures: List[Tuple[bytes, int]],
               valid: Callable[[int, int], bool],
               max_cols: Optional[int] = None) -> Optional[PrefixMatch]:
        """Deepest valid match for one request's signature chain.

        One modeled CAM search per probed depth (deepest-first, stopping
        at the first hit — a real CAM would search all depths in parallel;
        deepest-first sequential probing is the energy-conservative
        upper-bound model). ``valid(slot, generation)`` is the pool-side
        liveness check; entries failing it are dropped (``stale_drops``).
        ``max_cols`` caps the linkable depth (a request never links more
        columns than its own prompt occupies)."""
        self.lookups += 1
        for digest, tokens in reversed(signatures):
            self.cam_energy_pj += self._search_energy()
            ent = self._map.get(digest)
            if ent is None:
                continue
            slot, cols, ent_tokens, gen = ent
            if not valid(slot, gen):
                del self._map[digest]
                self.stale_drops += 1
                continue
            if max_cols is not None and cols > max_cols:
                continue
            self.hits += 1
            # LRU touch
            d = self._map.pop(digest)
            self._map[digest] = d
            return PrefixMatch(slot=slot, cols=cols, tokens=ent_tokens)
        self.misses += 1
        return None

    def insert(self, signatures: List[Tuple[bytes, int]], slot: int,
               generation: int, col_offset: int = 0) -> None:
        """Install one admitted request's whole signature chain: every
        chunk-aligned prefix depth becomes a match line naming ``slot``'s
        leading columns (``col_offset`` + the depth's tokens — the offset
        covers leading non-text columns of multimodal prompts). LRU
        eviction under capacity pressure, as for the ExtentTable."""
        for digest, tokens in signatures:
            if digest in self._map:
                self._map.pop(digest)
            elif len(self._map) >= self.cfg.table_size:
                self._map.pop(next(iter(self._map)))
                self.evictions += 1
            self._map[digest] = (slot, col_offset + tokens, tokens,
                                 generation)
            self.insertions += 1

    # -------------------------------------------------------- observability
    def reset_stats(self) -> None:
        """Zero the traffic counters without touching the match lines —
        called between scheduler arrival streams (same contract as
        ``ExtentTable.reset_stats``)."""
        self.lookups = self.hits = self.misses = 0
        self.evictions = self.insertions = self.stale_drops = 0
        self.cam_energy_pj = 0.0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> Dict[str, float]:
        return {"lookups": self.lookups, "hits": self.hits,
                "misses": self.misses, "hit_rate": self.hit_rate,
                "evictions": self.evictions,
                "insertions": self.insertions,
                "stale_drops": self.stale_drops,
                "occupancy": len(self._map),
                "cam_energy_pj": self.cam_energy_pj}
