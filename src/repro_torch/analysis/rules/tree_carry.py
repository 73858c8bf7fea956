"""tree-carry-discipline — state carried across a burst is immutable.

The counterpart of the reference's ``pytree-carry-discipline``. The port
has no pytree registry: a burst's loop carries its state as values
(``WriteStats``, ``LifetimeState``, ``AddressState``, ``OptState``) and
updates them functionally (``dataclasses.replace``, ``acc + st``). That
stays sound only while the class is immutable — a frozen dataclass or a
NamedTuple: an in-place field update of a carried object would change
the value every earlier reference holds, and field order is the
``repro_torch.tree`` flatten order (the checkpoint and fold ABI).

Checks:
  * a class named like a carry (``...State``, ``...Stats``) is a
    ``frozen=True`` dataclass or a NamedTuple;
  * a dataclass that a sync-free region of its module builds is
    ``frozen=True``.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, Optional, Set

from repro_torch.analysis.engine import (Finding, RepoContext, Rule,
                                         SourceFile, register_rule)
from repro_torch.analysis.visitors import dotted, walk_calls

DATACLASS_NAMES = {"dataclasses.dataclass", "dataclass"}
NAMEDTUPLE_BASES = {"NamedTuple", "typing.NamedTuple"}
#: the names the port gives its burst carries
CARRY_NAME_RE = re.compile(r"(State|Stats)$")


def _dataclass_frozen(cls: ast.ClassDef) -> Optional[bool]:
    """None if not a dataclass; else the frozen= flag."""
    for dec in cls.decorator_list:
        if dotted(dec) in DATACLASS_NAMES:
            return False
        if isinstance(dec, ast.Call) and dotted(dec.func) in DATACLASS_NAMES:
            for kw in dec.keywords:
                if (kw.arg == "frozen"
                        and isinstance(kw.value, ast.Constant)):
                    return bool(kw.value.value)
            return False
    return None


def _is_namedtuple(cls: ast.ClassDef) -> bool:
    return any(dotted(b) in NAMEDTUPLE_BASES for b in cls.bases)


def _region_built(sf: SourceFile) -> Set[str]:
    """Capitalized names a sync-free region calls (``Name(...)``,
    ``Name.zero(...)``): the classes it builds."""
    sm = sf.sync_map()
    out: Set[str] = set()
    for call in walk_calls(sf.tree):
        if sm.region_of(call) is None:
            continue
        fn = dotted(call.func) or ""
        head = fn.split(".")[0]
        if head and head[:1].isupper():
            out.add(head)
    return out


class TreeCarryDiscipline(Rule):
    name = "tree-carry-discipline"
    contract = ("state carried across a burst is a frozen dataclass or a "
                "NamedTuple, with a stable field order")

    def check(self, sf: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        classes: Dict[str, ast.ClassDef] = {
            node.name: node for node in ast.walk(sf.tree)
            if isinstance(node, ast.ClassDef)}
        built = _region_built(sf)
        for name, cls in classes.items():
            frozen = _dataclass_frozen(cls)
            if CARRY_NAME_RE.search(name):
                if frozen is None and not _is_namedtuple(cls):
                    yield self.finding(
                        sf, cls,
                        f"carry class {name} is neither a frozen "
                        "dataclass nor a NamedTuple — burst state must be "
                        "immutable with a stable field order")
                elif frozen is False:
                    yield self.finding(
                        sf, cls,
                        f"carry class {name} is an unfrozen dataclass — "
                        "burst state must be frozen=True (functional "
                        "replace, stable field order)")
            elif frozen is False and name in built:
                yield self.finding(
                    sf, cls,
                    f"{name} is built inside a sync-free region but "
                    "declared @dataclass without frozen=True — state a "
                    "burst carries must be immutable")


register_rule(TreeCarryDiscipline())
