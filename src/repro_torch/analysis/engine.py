"""repro_torch.analysis engine: source walker, rule registry, waiver
protocol (the counterpart of ``repro.analysis.engine``, for the port).

The port lives by a handful of cross-cutting contracts: a decode burst
never reads the device back, one RNG sub-stream registry, one write-path
boundary, immutable burst carries. Run-time checks pin *instances* of
them (the engine's bursts run under ``torch.cuda.set_sync_debug_mode
("error")`` on the paths tests drive); this engine checks the *class*:
every rule is an AST check over the whole of ``src/repro_torch``, so a
change that re-introduces the failure mode is caught wherever it lands.

Waiver protocol — some findings are intentional (the once-per-event
report read, a benchmark that measures the raw kernel). They are
silenced *in the source*, where a reviewer sees them, with a justifying
comment on the finding's line or the line above::

    rows = acc.cpu()  # repro_torch: allow(no-host-sync-in-burst): one
                      # read per scheduler event, after the burst

The marker is ``repro_torch:``, so this linter's waivers and the
reference linter's (``# repro: allow(...)``) never cover each other. A
waiver with no justification text is itself a violation
(``waiver-discipline``): the point is an auditable record of every spot
the contract is knowingly bent, never a silent escape hatch.

Pure stdlib: the linter imports neither torch nor jax.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.analysis.visitors import SyncMap

#: inline waiver: ``# repro_torch: allow(rule-a, rule-b): justification``
WAIVER_RE = re.compile(
    r"#\s*repro_torch:\s*allow\(\s*([A-Za-z0-9_\-*,\s]+?)\s*\)\s*:?\s*(.*?)"
    r"\s*$")

SKIP_DIRS = {".git", "__pycache__", ".github", ".venv", "node_modules",
             "build", "dist"}

#: engine-owned finding kinds (not waivable / not rule-registry entries).
PARSE_ERROR = "parse-error"
WAIVER_DISCIPLINE = "waiver-discipline"

#: what the linter walks when given no paths
DEFAULT_PATHS = ("src/repro_torch",)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # root-relative posix path
    line: int
    col: int
    message: str
    waived: bool = False
    justification: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> Dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line,
             "col": self.col, "message": self.message}
        if self.waived:
            d["waived"] = True
            d["justification"] = self.justification
        return d


@dataclasses.dataclass(frozen=True)
class Waiver:
    line: int
    rules: Tuple[str, ...]
    justification: str

    def covers(self, rule: str) -> bool:
        return "*" in self.rules or rule in self.rules


class SourceFile:
    """One parsed module: text, AST, waivers, and a lazily-built
    :class:`SyncMap` shared by every rule that needs region context."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text)  # SyntaxError propagates to the runner
        self.waivers: List[Waiver] = []
        for i, line in enumerate(self.lines, start=1):
            m = WAIVER_RE.search(line)
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(",")
                              if r.strip())
                self.waivers.append(Waiver(i, rules, m.group(2).strip()))
        self._sync_map: Optional[SyncMap] = None

    def sync_map(self) -> SyncMap:
        if self._sync_map is None:
            self._sync_map = SyncMap(self.tree)
        return self._sync_map

    def waiver_for(self, rule: str, line: int) -> Optional[Waiver]:
        """A waiver covers findings on its own line and on the line below
        (standalone comment above a statement)."""
        for w in self.waivers:
            if w.covers(rule) and w.line in (line, line - 1):
                return w
        return None


class Rule:
    """One invariant. Subclasses set ``name``/``contract`` and implement
    ``check`` as a generator of Findings (waiver matching happens in the
    runner)."""

    name: str = ""
    contract: str = ""

    def check(self, sf: SourceFile, ctx: "RepoContext"
              ) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, sf: SourceFile, node: ast.AST, message: str
                ) -> Finding:
        return Finding(self.name, sf.rel, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


_REGISTRY: Dict[str, Rule] = {}


def register_rule(rule: Rule) -> Rule:
    assert rule.name and rule.name not in _REGISTRY, rule.name
    _REGISTRY[rule.name] = rule
    return rule


def all_rules() -> Dict[str, Rule]:
    from repro_torch.analysis import rules as _rules  # noqa: F401
    return dict(_REGISTRY)


# --------------------------------------------------------------------------
# repo context (cross-file state shared by rules)
# --------------------------------------------------------------------------

RNG_REGISTRY_REL = "src/repro_torch/memory/rng_streams.py"


@dataclasses.dataclass(frozen=True)
class RngRegistry:
    rel: str
    names: Dict[str, int]  # CONSTANT name -> offset value
    streams: Tuple[Tuple[str, int, str, int], ...]  # (name, offset, domain, line)


class RepoContext:
    def __init__(self, root: Path):
        self.root = root
        self._rng: Optional[RngRegistry] = None
        self._rng_loaded = False

    def rng_registry(self) -> Optional[RngRegistry]:
        """Parsed view of the RNG sub-stream registry module (AST only —
        no import). None when the tree has no registry (fixture trees);
        the repo-level test asserts the real one exists."""
        if self._rng_loaded:
            return self._rng
        self._rng_loaded = True
        path = self.root / RNG_REGISTRY_REL
        if not path.is_file():
            return None
        tree = ast.parse(path.read_text())
        names: Dict[str, int] = {}
        streams: List[Tuple[str, int, str, int]] = []
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, int)):
                names[node.targets[0].id] = node.value.value
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", "") == "Stream"
                    and len(node.args) >= 3):
                sname = (node.args[0].value
                         if isinstance(node.args[0], ast.Constant) else "?")
                off_node = node.args[1]
                if isinstance(off_node, ast.Constant):
                    off = int(off_node.value)
                elif isinstance(off_node, ast.Name):
                    off = names.get(off_node.id, -1)
                else:
                    off = -1
                domain = (node.args[2].value
                          if isinstance(node.args[2], ast.Constant) else "?")
                streams.append((str(sname), off, str(domain), node.lineno))
        self._rng = RngRegistry(RNG_REGISTRY_REL, names, tuple(streams))
        return self._rng


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Report:
    root: str
    files: List[str]
    rules: List[str]
    findings: List[Finding]

    @property
    def violations(self) -> List[Finding]:
        return [f for f in self.findings if not f.waived]

    @property
    def waived(self) -> List[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def ok(self) -> bool:
        return not self.violations


def _iter_py_files(paths: Sequence[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in SKIP_DIRS for part in f.parts):
                    yield f


def find_root(start: Optional[Path] = None) -> Path:
    """Nearest ancestor holding pyproject.toml (repo root), else cwd."""
    cur = (start or Path.cwd()).resolve()
    for cand in (cur, *cur.parents):
        if (cand / "pyproject.toml").is_file():
            return cand
    return cur


def run_analysis(paths: Optional[Sequence[str]] = None,
                 root: Optional[Path] = None,
                 rules: Optional[Sequence[str]] = None) -> Report:
    """Run the rule set over ``paths`` (files or directories, resolved
    against ``root``; default ``src/repro_torch``). Returns the full
    :class:`Report` — waived findings included, marked."""
    root = (Path(root) if root is not None else find_root()).resolve()
    registry = all_rules()
    if rules:
        unknown = sorted(set(rules) - set(registry))
        if unknown:
            raise KeyError(f"unknown rule(s): {', '.join(unknown)} "
                           f"(have: {', '.join(sorted(registry))})")
        active = {n: registry[n] for n in rules}
    else:
        active = registry
    raw_paths = paths if paths else DEFAULT_PATHS
    targets = []
    for p in raw_paths:
        q = Path(p)
        targets.append(q if q.is_absolute() else root / q)
    ctx = RepoContext(root)
    findings: List[Finding] = []
    files: List[str] = []
    for f in _iter_py_files(targets):
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            sf = SourceFile(f, rel, f.read_text())
        except SyntaxError as e:
            findings.append(Finding(PARSE_ERROR, rel, e.lineno or 1, 0,
                                    f"syntax error: {e.msg}"))
            continue
        files.append(rel)
        for rule in active.values():
            for fd in rule.check(sf, ctx):
                w = sf.waiver_for(fd.rule, fd.line)
                if w is not None:
                    fd = dataclasses.replace(
                        fd, waived=True, justification=w.justification)
                findings.append(fd)
        # waiver hygiene: every waiver must justify itself (engine-owned,
        # never waivable — it IS the audit trail)
        for w in sf.waivers:
            if not w.justification:
                findings.append(Finding(
                    WAIVER_DISCIPLINE, rel, w.line, 0,
                    "waiver without justification — write `# "
                    "repro_torch: allow(rule): why this bend of the "
                    "contract is intentional`"))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return Report(root=str(root), files=files,
                  rules=sorted(active), findings=findings)
