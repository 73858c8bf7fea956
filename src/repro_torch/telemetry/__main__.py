"""Timeline file validator CLI.

  PYTHONPATH=src python -m repro_torch.telemetry TIMELINE.json \
      [--schema tests/fixtures/timeline.schema.json]

Loads a Chrome trace-event JSON (the launcher's ``--trace-timeline``
output), validates it against the checked-in schema with the
dependency-free subset validator, and prints a one-line summary. Exit 0
= valid.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

from repro_torch.telemetry.export import validate_json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.telemetry")
    ap.add_argument("timeline", help="Chrome trace-event JSON file")
    ap.add_argument("--schema",
                    default="tests/fixtures/timeline.schema.json")
    args = ap.parse_args(argv)

    doc = json.loads(Path(args.timeline).read_text())
    schema = json.loads(Path(args.schema).read_text())
    try:
        validate_json(doc, schema)
    except ValueError as e:
        print(f"INVALID {args.timeline}: {e}", file=sys.stderr)
        return 1
    kinds = collections.Counter(e["ph"] for e in doc["traceEvents"])
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    lanes = {e["pid"] for e in doc["traceEvents"]}
    t_max = max((e["ts"] + e.get("dur", 0) for e in spans), default=0)
    print(f"OK {args.timeline}: {len(doc['traceEvents'])} events "
          f"({kinds['X']} spans, {kinds['C']} counter samples, "
          f"{kinds['M']} metadata) across {len(lanes)} lanes, "
          f"span horizon {t_max:g} us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
