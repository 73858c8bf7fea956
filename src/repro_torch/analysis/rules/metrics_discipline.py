"""metrics-discipline — metrics flow through the telemetry registry and
instrument drains stay out of sync-free regions.

Two checks:

  * **ad-hoc accumulators**: a module-level ``NAME = <number>`` that the
    same module mutates (an ``AugAssign`` target or a ``global``
    declaration) is a shadow metric — an unregistered, undocumented,
    unexported counter. Declare it through
    ``repro_torch.telemetry.registry.REGISTRY`` (name + unit + doc) and
    count it on an ``Instruments`` surface, or keep the state on an
    instance. Module-level numeric *constants* are untouched.

  * **drains in sync-free regions**: ``.drain()`` / ``.event()`` /
    ``.resolve()`` / ``.finalize()`` (the ``Instruments``/``Telemetry``
    read points) inside a burst or a capture read every bound device
    metric *per step* — bound device accumulators drain once per
    scheduler event, on the host control path.

Waivers use the standard protocol: a
``# repro_torch: allow(metrics-discipline): …`` comment on the finding
line or the line above, naming the budget/justification.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import (Finding, RepoContext, Rule,
                                         SourceFile, register_rule)
from repro_torch.analysis.visitors import walk_calls

#: the instrument read points (Instruments.drain/resolve,
#: Telemetry.event/finalize)
DRAIN_METHODS = {"drain", "event", "resolve", "finalize"}


def _module_numeric_assigns(tree: ast.Module) -> dict:
    """name -> assign node for top-level ``NAME = <int|float literal>``."""
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, (int, float))
                and not isinstance(node.value.value, bool)):
            out[node.targets[0].id] = node
    return out


def _mutated_names(tree: ast.Module) -> set:
    """Names the module augments or declares ``global`` anywhere."""
    mutated = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.AugAssign)
                and isinstance(node.target, ast.Name)):
            mutated.add(node.target.id)
        elif isinstance(node, ast.Global):
            mutated.update(node.names)
    return mutated


class MetricsDiscipline(Rule):
    name = "metrics-discipline"
    contract = ("every counter/gauge/histogram is declared through the "
                "telemetry registry; instrument drains stay out of "
                "sync-free regions")

    def check(self, sf: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        assigns = _module_numeric_assigns(sf.tree)
        if assigns:
            for name in sorted(_mutated_names(sf.tree) & set(assigns)):
                yield self.finding(
                    sf, assigns[name],
                    f"module-level accumulator '{name}' is an ad-hoc "
                    "metric (unregistered, undocumented, invisible to "
                    "exporters) — declare a counter/gauge through "
                    "repro_torch.telemetry.registry.REGISTRY and count it "
                    "on an Instruments surface")
        sm = sf.sync_map()
        for call in walk_calls(sf.tree):
            if not (isinstance(call.func, ast.Attribute)
                    and call.func.attr in DRAIN_METHODS):
                continue
            hit = sm.region_of(call)
            if hit is not None:
                _, kind = hit
                yield self.finding(
                    sf, call,
                    f".{call.func.attr}() inside a {kind} reads every "
                    "bound device instrument per step — drain once per "
                    "scheduler event on the host control path")


register_rule(MetricsDiscipline())
