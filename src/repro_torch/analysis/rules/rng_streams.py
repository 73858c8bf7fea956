"""rng-stream-hygiene — one registry of RNG sub-stream fold constants.

The port's bit-parity contracts with the reference (lockstep pool ==
batch, retention-off identity, remap invariance) all rest on a fixed RNG
schedule: every subsystem forks its sub-stream by folding a constant
offset into a parent key (``rng.fold_in``), and the counter hash
underneath sees flat *logical* indices only. This rule makes
``repro_torch/memory/rng_streams.py`` the single source of truth:

  * inside the registry: no two ``Stream`` entries may collide on
    (domain, offset), and every large constant has a ``Stream`` row;
  * everywhere else: a ``fold_in`` whose offset expression contains an
    integer literal >= 1000 is a magic sub-stream constant — name it in
    the registry (small literals are local step/leaf folds, exempt);
  * module-level ``*_KEY_OFFSET`` / ``*_STREAM_OFFSET`` integer
    assignments outside the registry are flagged;
  * ``rng_streams.<NAME>`` references must name a registered constant;
  * a ``fold_in`` offset built from a name containing ``phys``/``shift``
    hashes physical addresses — streams hash flat logical indices so
    remapping and sharding never change bits.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.analysis.engine import (Finding, RepoContext, Rule,
                                         SourceFile, register_rule)
from repro_torch.analysis.visitors import dotted, walk_calls

MAGIC_MIN = 1000
OFFSET_ASSIGN_RE = re.compile(r".*_KEY_OFFSET$|.*_STREAM_OFFSET$")
PHYSICAL_RE = re.compile(r"phys|shift", re.IGNORECASE)


def _is_fold_in(call: ast.Call) -> bool:
    fn = dotted(call.func)
    if fn is None:
        return False
    return fn == "fold_in" or fn.endswith(".fold_in")


class RngStreamHygiene(Rule):
    name = "rng-stream-hygiene"
    contract = ("every RNG sub-stream fold constant lives in "
                "repro_torch/memory/rng_streams.py; streams hash flat "
                "logical indices")

    def check(self, sf: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        reg = ctx.rng_registry()
        if reg is not None and sf.rel == reg.rel:
            yield from self._check_registry(sf, reg)
            return
        # aliases under which the registry module is visible here
        aliases = set()
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ImportFrom):
                if (node.module or "").endswith("memory"):
                    for a in node.names:
                        if a.name == "rng_streams":
                            aliases.add(a.asname or a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.endswith(".rng_streams"):
                        aliases.add(a.asname or a.name.split(".")[0])
        for node in sf.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and OFFSET_ASSIGN_RE.match(node.targets[0].id)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, int)):
                yield self.finding(
                    sf, node,
                    f"sub-stream constant {node.targets[0].id} defined "
                    "outside the registry — move it to "
                    "repro_torch/memory/rng_streams.py (the collision "
                    "check only sees registered streams)")
        for call in walk_calls(sf.tree):
            if not _is_fold_in(call) or len(call.args) < 2:
                continue
            for sub in ast.walk(call.args[1]):
                if (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, int)
                        and not isinstance(sub.value, bool)
                        and sub.value >= MAGIC_MIN):
                    yield self.finding(
                        sf, call,
                        f"magic RNG sub-stream constant {sub.value} in a "
                        "fold_in — name it in "
                        "repro_torch/memory/rng_streams.py and reference "
                        "the registry (duplicate offsets on one parent key "
                        "silently share bits)")
                elif isinstance(sub, ast.Name) and PHYSICAL_RE.search(
                        sub.id):
                    yield self.finding(
                        sf, call,
                        f"fold_in offset built from '{sub.id}': RNG "
                        "streams must hash flat LOGICAL indices — "
                        "folding a physical/remap quantity changes bits "
                        "when the wear-leveler rotates")
        if not aliases:
            return
        known = set(reg.names) if reg is not None else set()
        for node in ast.walk(sf.tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases
                    and node.attr.isupper() and known
                    and node.attr not in known):
                yield self.finding(
                    sf, node,
                    f"rng_streams.{node.attr} is not a registered stream "
                    "constant")

    def _check_registry(self, sf: SourceFile,
                        reg) -> Iterator[Finding]:
        seen = {}
        for sname, off, domain, line in reg.streams:
            key = (domain, off)
            if key in seen:
                yield Finding(
                    self.name, sf.rel, line, 0,
                    f"stream '{sname}' collides with '{seen[key]}': "
                    f"offset {off} is already taken in parent-key domain "
                    f"'{domain}' — colliding folds share bits")
            else:
                seen[key] = sname
        registered = {off for _, off, _, _ in reg.streams}
        for cname, val in reg.names.items():
            if val >= MAGIC_MIN and val not in registered:
                yield Finding(
                    self.name, sf.rel, 1, 0,
                    f"constant {cname}={val} has no Stream entry — every "
                    "offset needs a (domain, doc) row for the collision "
                    "check to see it")


register_rule(RngStreamHygiene())
