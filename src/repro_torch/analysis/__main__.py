"""CLI: ``python -m repro_torch.analysis [paths] [--rule NAME] [--json OUT]``.

Walks ``src/repro_torch`` (or the given paths) with the full rule set (or
a ``--rule`` subset), prints the text report, optionally writes the JSON
report, and exits 1 on any unwaived violation, 2 on an unknown rule.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.analysis.engine import all_rules, find_root, run_analysis
from repro_torch.analysis.reporters import render_json, render_text


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST invariant linter for the port's sync-free-burst "
                    "/ device-operand / RNG-stream / backend-registry / "
                    "immutable-carry contracts.")
    ap.add_argument("paths", nargs="*",
                    help="files or directories, resolved against --root "
                         "(default: src/repro_torch)")
    ap.add_argument("--rule", action="append", default=None,
                    help="run only this rule (repeatable)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: nearest pyproject.toml)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the JSON report here")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="stdout format (default text)")
    ap.add_argument("--show-waived", action="store_true",
                    help="list waived findings with their justifications")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, rule in sorted(all_rules().items()):
            print(f"{name}: {rule.contract}")
        return 0

    root = Path(args.root) if args.root else find_root()
    try:
        report = run_analysis(paths=args.paths or None, root=root,
                              rules=args.rule)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    if args.format == "json":
        print(render_json(report))
    else:
        print(render_text(report, show_waived=args.show_waived))
    if args.json:
        Path(args.json).write_text(render_json(report) + "\n")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
