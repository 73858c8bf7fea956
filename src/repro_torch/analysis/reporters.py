"""Text and JSON reporters for repro_torch.analysis reports."""
from __future__ import annotations

import json
from typing import Dict

from repro_torch.analysis.engine import Report


def render_text(report: Report, *, show_waived: bool = False) -> str:
    out = []
    for f in report.violations:
        out.append(f"{f.location} [{f.rule}] {f.message}")
    if show_waived:
        for f in report.waived:
            out.append(f"{f.location} [{f.rule}] waived: "
                       f"{f.justification or '(no justification)'}")
    n_v, n_w = len(report.violations), len(report.waived)
    out.append(f"repro_torch.analysis: {n_v} violation(s), {n_w} waived, "
               f"{len(report.files)} file(s), "
               f"{len(report.rules)} rule(s) [{', '.join(report.rules)}]")
    return "\n".join(out)


def to_json_dict(report: Report) -> Dict:
    return {
        "root": report.root,
        "files_checked": len(report.files),
        "rules": report.rules,
        "counts": {"violations": len(report.violations),
                   "waived": len(report.waived)},
        "violations": [f.to_dict() for f in report.violations],
        "waived": [f.to_dict() for f in report.waived],
    }


def render_json(report: Report) -> str:
    return json.dumps(to_json_dict(report), indent=2, sort_keys=True)
