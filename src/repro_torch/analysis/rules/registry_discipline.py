"""registry-discipline — all writes flow through the repro_torch.memory
backend registry.

Nothing outside ``repro_torch/memory`` and ``repro_torch/kernels`` imports
the EXTENT write-path kernel internals (``repro_torch.kernels.extent_write``,
``repro_torch.kernels.scrub``), calls their entry points directly, or
carries the ``use_kernel=``/``interpret=`` booleans. Consumers pick an
implementation by registry *name* (``ServeConfig.backend``,
``--backend``: ``cuda``, ``lanes_ref``, ``oracle``, ``exact``), so that a
new backend lands in one place. Places that are genuinely *about* the
kernels carry a waiver.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import (Finding, RepoContext, Rule,
                                         SourceFile, register_rule)
from repro_torch.analysis.visitors import dotted, walk_calls

ALLOWED_PREFIXES = ("src/repro_torch/memory/", "src/repro_torch/kernels/")
PRIVATE_MODULES = ("repro_torch.kernels.extent_write",
                   "repro_torch.kernels.scrub")
#: the kernel packages, as ``from repro_torch.kernels import <name>``
PRIVATE_PACKAGES = {"extent_write", "scrub"}
BANNED_KWARGS = {"use_kernel", "interpret"}
#: the write path's kernel wrappers, twins and entry points
BANNED_NAMES = {"extent_write_cuda", "extent_write_ref", "scrub_cuda",
                "scrub_ref", "scrub_write"}


class RegistryDiscipline(Rule):
    name = "registry-discipline"
    contract = ("the EXTENT write path is reached only through the "
                "repro_torch.memory backend registry; kernel internals "
                "stay inside memory/ + kernels/")

    def check(self, sf: SourceFile, ctx: RepoContext) -> Iterator[Finding]:
        if sf.rel.startswith(ALLOWED_PREFIXES):
            return
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                private = mod.startswith(PRIVATE_MODULES) or (
                    mod == "repro_torch.kernels"
                    and any(a.name in PRIVATE_PACKAGES for a in node.names))
                if private:
                    yield self.finding(
                        sf, node,
                        f"import of write-path kernel internals "
                        f"'{mod}' outside memory/ + kernels/ — go "
                        "through the repro_torch.memory backend registry "
                        "(get_backend / WritePlan)")
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.startswith(PRIVATE_MODULES):
                        yield self.finding(
                            sf, node,
                            f"import of write-path kernel internals "
                            f"'{a.name}' outside memory/ + kernels/ — go "
                            "through the repro_torch.memory backend "
                            "registry")
        for call in walk_calls(sf.tree):
            for kw in call.keywords:
                if kw.arg in BANNED_KWARGS:
                    yield self.finding(
                        sf, call,
                        f"'{kw.arg}=' boolean outside memory/ + kernels/: "
                        "backend selection is a registry name, not a "
                        "kernel flag")
            fn = dotted(call.func) or ""
            if fn.split(".")[-1] in BANNED_NAMES:
                yield self.finding(
                    sf, call,
                    f"direct call of kernel entry '{fn}' outside "
                    "memory/ + kernels/ — writes flow through the "
                    "registry")


register_rule(RegistryDiscipline())
