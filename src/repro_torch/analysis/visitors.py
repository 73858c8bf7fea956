"""AST visitor framework shared by the repro_torch.analysis rules.

The heart is the :class:`SyncMap`: a per-module map of the code that runs
*sync-free* — where the port's zero-host-sync and operand contracts
apply (the counterpart of the reference's ``TraceMap`` of traced
regions). Detection follows the port's idioms:

  * bodies of ``with _no_host_sync(...)`` blocks (the serving engine's
    decode burst, run under ``torch.cuda.set_sync_debug_mode("error")``)
    and of ``with torch.cuda.graph(...)`` captures;
  * callables handed to ``torch.compile`` or
    ``torch.cuda.make_graphed_callables``, and defs decorated with
    ``@torch.compile``;
  * the local call graph: a plain-name call from a sync-free region to a
    def in an enclosing scope of the same module marks the callee too, to
    a fixpoint.

Everything here is stdlib-only: the linter runs without torch or jax.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set, Tuple

#: context managers whose body runs sync-free -> the region's kind
SYNC_FREE_WITH = {
    "_no_host_sync": "sync-free burst",
    "torch.cuda.graph": "CUDA graph capture",
}

#: callables whose argument is compiled or captured -> (indices, kind)
CAPTURE_CALLS = {
    "torch.compile": ((0,), "compiled callable"),
    "torch.cuda.make_graphed_callables": ((0,), "graphed callable"),
}

#: decorators that compile the def they decorate
COMPILE_DECORATORS = {"torch.compile"}

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.Module)


def dotted(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain (``torch.cuda.synchronize``),
    or None for anything more dynamic."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """Leftmost identifier of an expression chain: ``self.plan.vectors``
    -> ``self``; ``x[0].y`` -> ``x``."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def literal_table(node: ast.AST) -> bool:
    """Is this a non-empty list/tuple of constants (a data table baked
    into the expression)?"""
    if not isinstance(node, (ast.List, ast.Tuple)) or not node.elts:
        return False
    return all(isinstance(e, ast.Constant)
               or (isinstance(e, ast.UnaryOp)
                   and isinstance(e.operand, ast.Constant))
               for e in node.elts)


def _with_kind(node: ast.AST) -> Optional[str]:
    """The region kind of a ``with`` statement whose context manager is
    sync-free, else None."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return None
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            kind = SYNC_FREE_WITH.get(dotted(expr.func) or "")
            if kind:
                return kind
    return None


class SyncMap:
    """Sync-free region map for one module (see module doc). A region is
    a function (or lambda) node, or a ``with`` node whose body is the
    region."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        # defs indexed by the scope (function/module) that contains them
        self.scope_defs: Dict[ast.AST, Dict[str, ast.AST]] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.scope_defs.setdefault(
                    self.enclosing_scope(node), {})[node.name] = node
        self.regions: Dict[ast.AST, str] = {}
        self._mark_entry_points()
        self._propagate_call_graph()
        self._locals_cache: Dict[ast.AST, Set[str]] = {}

    # ----------------------------------------------------------- structure
    def enclosing_scope(self, node: ast.AST) -> ast.AST:
        """Nearest enclosing function (or the module) *containing* node."""
        cur = self.parents.get(node)
        while cur is not None and not isinstance(cur, _SCOPE_NODES):
            cur = self.parents.get(cur)
        return cur if cur is not None else self.tree

    def resolve(self, name: str, from_node: ast.AST) -> Optional[ast.AST]:
        """Resolve a plain name to a def visible from ``from_node``'s
        scope chain (innermost first)."""
        scope = self.enclosing_scope(from_node)
        while scope is not None:
            hit = self.scope_defs.get(scope, {}).get(name)
            if hit is not None:
                return hit
            if isinstance(scope, ast.Module):
                return None
            scope = self.enclosing_scope(scope)
        return None

    # ----------------------------------------------------- region detection
    def _mark(self, target: ast.AST, kind: str, origin: ast.AST) -> None:
        targets = (target.elts if isinstance(target, (ast.Tuple, ast.List))
                   else [target])
        for t in targets:
            if isinstance(t, ast.Lambda):
                self.regions.setdefault(t, kind)
            elif isinstance(t, ast.Name):
                fn = self.resolve(t.id, origin)
                if fn is not None:
                    self.regions.setdefault(fn, kind)

    def _mark_entry_points(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    d = dotted(dec.func if isinstance(dec, ast.Call)
                               else dec)
                    if d in COMPILE_DECORATORS:
                        self.regions.setdefault(node, "compiled callable")
            elif isinstance(node, ast.Call):
                hit = CAPTURE_CALLS.get(dotted(node.func) or "")
                if hit is not None:
                    idxs, kind = hit
                    for idx in idxs:
                        if idx < len(node.args):
                            self._mark(node.args[idx], kind, node)
            kind = _with_kind(node)
            if kind:
                self.regions.setdefault(node, kind)

    def _region_nodes(self, region: ast.AST) -> Iterator[ast.AST]:
        """Every node a region runs: a function's whole subtree, a
        ``with``'s body statements."""
        if isinstance(region, (ast.With, ast.AsyncWith)):
            for stmt in region.body:
                yield from ast.walk(stmt)
        else:
            yield from ast.walk(region)

    def _propagate_call_graph(self) -> None:
        """Fixpoint: plain-name calls out of sync-free regions mark their
        locally-resolvable callees (same kind)."""
        changed = True
        while changed:
            changed = False
            for region, kind in list(self.regions.items()):
                for node in self._region_nodes(region):
                    if not (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Name)):
                        continue
                    callee = self.resolve(node.func.id, node)
                    if callee is not None and callee not in self.regions:
                        self.regions[callee] = kind
                        changed = True

    # ------------------------------------------------------------- queries
    def region_of(self, node: ast.AST) -> Optional[Tuple[ast.AST, str]]:
        """(region, kind) when ``node`` runs in a sync-free region, else
        None: the innermost sync-free ``with`` body holding it within its
        own function, or its function when that is a region."""
        scope = self.enclosing_scope(node)
        child, cur = node, self.parents.get(node)
        while cur is not None and cur is not scope:
            if (cur in self.regions
                    and isinstance(cur, (ast.With, ast.AsyncWith))
                    and child in cur.body):
                return cur, self.regions[cur]
            child, cur = cur, self.parents.get(cur)
        if isinstance(scope, _FUNC_NODES) and scope in self.regions:
            return scope, self.regions[scope]
        return None

    def function_of(self, region: ast.AST) -> Optional[ast.AST]:
        """The function a region runs in: itself, or the function holding
        the ``with`` (None at module level)."""
        if isinstance(region, _FUNC_NODES):
            return region
        scope = self.enclosing_scope(region)
        return scope if isinstance(scope, _FUNC_NODES) else None

    def params_of(self, fn: Optional[ast.AST]) -> Set[str]:
        if fn is None:
            return set()
        a = fn.args
        names = [p.arg for p in a.posonlyargs + a.args]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return set(names)

    def kwonly_of(self, fn: Optional[ast.AST]) -> Set[str]:
        """Keyword-only params — the port's static-argument idiom (a
        burst's ``n``), exempt from tensor-value checks."""
        if fn is None:
            return set()
        return {p.arg for p in fn.args.kwonlyargs}

    def locals_of(self, fn: ast.AST) -> Set[str]:
        """Names bound anywhere inside function ``fn`` (params included)
        — an over-approximation that errs toward fewer findings."""
        cached = self._locals_cache.get(fn)
        if cached is not None:
            return cached
        names = set(self.params_of(fn)) | set(self.kwonly_of(fn))
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                         ast.Store):
                names.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
        self._locals_cache[fn] = names
        return names

    def closure_locals(self, fn: ast.AST) -> Set[str]:
        """Names bound in functions strictly *enclosing* ``fn`` — the
        closed-over host-state candidates (module globals excluded)."""
        names: Set[str] = set()
        scope = self.enclosing_scope(fn)
        while isinstance(scope, _FUNC_NODES):
            names |= self.locals_of(scope)
            scope = self.enclosing_scope(scope)
        return names


def walk_calls(tree: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node

