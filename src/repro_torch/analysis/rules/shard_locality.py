"""shard-locality — zero cross-device collectives in the serving zone's
sync-free code.

The sharded pool's scaling contract (``repro_torch.sharding``): the slot
axis partitions over dies and every step of a burst — the decode, the
column write, the decay, the scrub pass — is elementwise or batched
*along* that axis, never *across* it. A ``torch.distributed`` collective
inside a burst would serialize every die on the slowest one and put
cross-device traffic on the per-token path.

So: any ``torch.distributed`` collective inside a sync-free region of
``src/repro_torch/serve/`` or ``src/repro_torch/reliability/`` is a
violation. An intentional one must carry a
``# repro_torch: allow(shard-locality): …`` waiver naming why it is off
the per-token path. Host-path code is exempt: the contract is about the
per-token stream, not set-up or the once-per-run ledger merge.
"""
from __future__ import annotations

from typing import Iterator

from repro_torch.analysis.engine import (Finding, RepoContext, Rule,
                                         SourceFile, register_rule)
from repro_torch.analysis.visitors import dotted, walk_calls

_COLLECTIVE_NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                     "all_gather_object", "reduce_scatter",
                     "reduce_scatter_tensor", "all_to_all",
                     "all_to_all_single", "broadcast", "reduce", "gather",
                     "scatter", "send", "recv", "barrier")
COLLECTIVE_CALLS = {f"{prefix}.{name}"
                    for name in _COLLECTIVE_NAMES
                    for prefix in ("torch.distributed", "dist")}

ZONE_PREFIXES = ("src/repro_torch/serve/", "src/repro_torch/reliability/")


class ShardLocality(Rule):
    name = "shard-locality"
    contract = ("sync-free decode/scrub code performs zero cross-device "
                "collectives — die-sharded throughput scales only while "
                "each die touches its own slot rows")

    def check(self, sf: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        if not sf.rel.startswith(ZONE_PREFIXES):
            return
        sm = sf.sync_map()
        for call in walk_calls(sf.tree):
            fn = dotted(call.func)
            if fn not in COLLECTIVE_CALLS:
                continue
            hit = sm.region_of(call)
            if hit is None:
                continue
            _, kind = hit
            yield self.finding(
                sf, call,
                f"{fn} inside a {kind}: a cross-device collective on the "
                "per-token path serializes every die on the slowest one "
                "— keep the burst slot-local and reduce per-die ledgers "
                "on the host, once per run")


register_rule(ShardLocality())
