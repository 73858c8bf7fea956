"""no-host-sync-in-burst — zero host reads inside sync-free regions, and
an audited once-per-event budget in the serving/reliability zone (the
counterpart of the reference's ``no-host-sync-in-scan``).

Two tiers:

  * **sync-free regions** (``_no_host_sync`` burst bodies, CUDA graph
    captures, compiled callables, their local call graph): any host read
    — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``np.asarray``/``np.array``, ``torch.cuda.synchronize``, ``print`` —
    is a hard violation: it stalls the launch queue once per step (on the
    card the burst's ``set_sync_debug_mode("error")`` raises on it, but
    only on the paths a run drives). ``float()``/``int()``/``bool()`` of a
    positional parameter is flagged too (keyword-only params are the
    port's static-argument idiom and exempt).

  * **the zero-sync zone** (``src/repro_torch/serve/``, ``reliability/``,
    ``telemetry/``): the explicit device-to-host reads (``.item()``,
    ``.tolist()``, ``.cpu()``, ``.to("cpu")``, ``torch.cuda.synchronize``)
    are flagged *everywhere*, host paths included. The serving loop's
    contract is one read per scheduler event — each intentional read
    carries a ``# repro_torch: allow(no-host-sync-in-burst): …`` waiver
    naming its budget, so the set of reads is enumerable by grep.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import (Finding, RepoContext, Rule,
                                         SourceFile, register_rule)
from repro_torch.analysis.visitors import dotted, walk_calls

#: the explicit device-to-host reads (zone and regions)
READ_METHODS = {"item", "tolist", "cpu"}
SYNC_CALLS = {"torch.cuda.synchronize"}
#: host conversions that only regions flag (they read a CPU tensor)
REGION_METHODS = {"numpy"}
NUMPY_CTORS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
COERCIONS = {"float", "int", "bool"}

ZONE_PREFIXES = ("src/repro_torch/serve/", "src/repro_torch/reliability/",
                 "src/repro_torch/telemetry/")


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    vals = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu"
               for v in vals)


def _read_name(call: ast.Call) -> str:
    """The device read a call makes, or ''."""
    fn = dotted(call.func)
    if fn in SYNC_CALLS:
        return fn
    if (isinstance(call.func, ast.Attribute)
            and call.func.attr in READ_METHODS and not call.args):
        return f".{call.func.attr}()"
    if _to_cpu(call):
        return '.to("cpu")'
    return ""


def _region_read_name(call: ast.Call) -> str:
    read = _read_name(call)
    if read:
        return read
    fn = dotted(call.func)
    if fn in NUMPY_CTORS:
        return fn
    if (isinstance(call.func, ast.Attribute)
            and call.func.attr in REGION_METHODS and not call.args):
        return f".{call.func.attr}()"
    return ""


class HostSync(Rule):
    name = "no-host-sync-in-burst"
    contract = ("decode bursts and captured regions read nothing back; "
                "the serving zone reads once per scheduler event, each "
                "read waived with its budget")

    def check(self, sf: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        sm = sf.sync_map()
        in_zone = sf.rel.startswith(ZONE_PREFIXES)
        for call in walk_calls(sf.tree):
            hit = sm.region_of(call)
            if hit is not None:
                region, kind = hit
                fn = dotted(call.func)
                read = _region_read_name(call)
                func = sm.function_of(region)
                if read:
                    yield self.finding(
                        sf, call,
                        f"{read} inside a {kind}: a host read per step "
                        "stalls the launch queue — accumulate on the "
                        "device and read once per event")
                elif fn == "print":
                    yield self.finding(
                        sf, call,
                        f"print() inside a {kind} reads its tensor "
                        "arguments back — report after the region")
                elif (fn in COERCIONS and len(call.args) == 1
                      and isinstance(call.args[0], ast.Name)
                      and call.args[0].id in sm.params_of(func)
                      and call.args[0].id not in sm.kwonly_of(func)):
                    yield self.finding(
                        sf, call,
                        f"{fn}() of parameter '{call.args[0].id}' inside "
                        f"a {kind} is a blocking read of a tensor "
                        "(keyword-only params are exempt — pass host "
                        "values as keywords)")
            elif in_zone:
                read = _read_name(call)
                if read:
                    yield self.finding(
                        sf, call,
                        f"{read} on a host path of the zero-sync serving "
                        "zone: keep to the one per-event read and waive "
                        "it with its budget")


register_rule(HostSync())
