"""operand-discipline — what a sync-free region uses arrives as device
operands.

The contract: driver vectors, remap shifts, decay thresholds — anything
a scheduler may swap between bursts — are device tensors handed to the
burst, never host values turned into tensors inside it. A tensor built
from host data inside a burst step is a host-to-device copy per step
(and in a captured CUDA graph it is frozen at capture: the next swap is
silently ignored). This rule flags the class inside sync-free regions:

  * tensor constructors (``torch.tensor``/``as_tensor``/``from_numpy``)
    applied to a literal data table;
  * tensor constructors applied to ``self.*``/``cls.*`` or to a name
    closed over from an enclosing function — per-instance or per-closure
    host state copied in each step;
  * ``rng.PRNGKey(<literal>)`` — a constant key: every step draws the
    same bits (thread the carried key through ``split``/``fold_in``).

Module-level names are exempt (true constants).
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import (Finding, RepoContext, Rule,
                                         SourceFile, register_rule)
from repro_torch.analysis.visitors import (dotted, literal_table, root_name,
                                           walk_calls)

TENSOR_CTORS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}


class OperandDiscipline(Rule):
    name = "operand-discipline"
    contract = ("values a caller may vary between bursts reach a sync-free "
                "region as device operands, not host values copied in")

    def check(self, sf: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        sm = sf.sync_map()
        for call in walk_calls(sf.tree):
            hit = sm.region_of(call)
            if hit is None:
                continue
            region, kind = hit
            fn = dotted(call.func) or ""
            if (fn.split(".")[-1] == "PRNGKey" and call.args
                    and isinstance(call.args[0], ast.Constant)):
                yield self.finding(
                    sf, call,
                    f"{fn}(<literal>) inside a {kind}: a constant key "
                    "draws the same bits every step — thread the carried "
                    "key (split/fold_in)")
                continue
            if fn not in TENSOR_CTORS or not call.args:
                continue
            arg = call.args[0]
            if literal_table(arg):
                yield self.finding(
                    sf, call,
                    f"literal constant table made a tensor inside a "
                    f"{kind}: a host-to-device copy per step — build it "
                    "once outside and pass it as an operand")
                continue
            root = root_name(arg)
            func = sm.function_of(region)
            if root in ("self", "cls"):
                yield self.finding(
                    sf, call,
                    f"{fn}({root}.…) inside a {kind} copies per-instance "
                    "host state to the device each step — hold it as a "
                    "device tensor and pass it as an operand")
            elif (root is not None and func is not None
                  and root not in sm.locals_of(func)
                  and root in sm.closure_locals(func)):
                yield self.finding(
                    sf, call,
                    f"{fn}({root}) closes over an enclosing function's "
                    f"local inside a {kind}: host state copied to the "
                    "device each step — move it to "
                    "the device once and pass it as an operand")


register_rule(OperandDiscipline())
