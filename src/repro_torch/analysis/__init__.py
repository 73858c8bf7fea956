"""repro_torch.analysis — the port's AST invariant linter (the
counterpart of ``repro.analysis``, whose rules look for JAX's idioms):

  * ``operand-discipline``     — what a burst uses arrives as device
                                 operands, not host values copied in;
  * ``no-host-sync-in-burst``  — zero host reads in sync-free regions,
                                 audited once-per-event reads in serve/,
                                 reliability/ and telemetry/;
  * ``rng-stream-hygiene``     — one fold-constant registry
                                 (``repro_torch.memory.rng_streams``),
                                 flat logical indices only;
  * ``registry-discipline``    — writes flow through the
                                 ``repro_torch.memory`` backend registry;
  * ``tree-carry-discipline``  — burst carries are frozen dataclasses or
                                 NamedTuples;
  * ``metrics-discipline``     — counters through the telemetry registry,
                                 drains off the burst;
  * ``shard-locality``         — no collectives in the zone's bursts.

A sync-free region is a ``with _no_host_sync(...)`` or
``torch.cuda.graph(...)`` body, a callable handed to ``torch.compile`` or
``torch.cuda.make_graphed_callables``, and what they call in the module
(``visitors.SyncMap``). Pure stdlib — importable and runnable
(``python -m repro_torch.analysis``) without torch or jax. Waiver syntax
and the engine's contract: see ``engine.py``.
"""
from repro_torch.analysis.engine import (  # noqa: F401
    Finding, RepoContext, Report, Rule, SourceFile, all_rules, find_root,
    register_rule, run_analysis,
)
from repro_torch.analysis.reporters import (  # noqa: F401
    render_json, render_text, to_json_dict,
)
