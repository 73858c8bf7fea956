"""Paper Fig. 12: simulation waveforms of the EXTENT write circuit.

Event-level reproduction: a sequence of word writes (repetitive and
non-repetitive, mixed priorities) through the approximate store on the
device, reporting per-write energy/latency — the repetitive write shows
the immediate current cut (zero energy), the non-repetitive ones the
theta 0->180 transition cost per level.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.benchmarks import arg_parser
from repro_torch.core.approx_store import approx_write_with_stats
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device


def _word(*lanes: int, device) -> torch.Tensor:
    """One 64-bit LLC word as two 32-bit lanes (int32 views of the
    reference's uint32 words)."""
    return torch.from_numpy(
        np.asarray(lanes, np.uint32).view(np.int32)).to(device)


def run(device=None):
    dev = resolve_device(device)
    key = rng.PRNGKey(0)
    word0 = _word(0x00000000, 0x00000000, device=dev)
    wordA = _word(0xDEADBEEF, 0xCAFEF00D, device=dev)
    events = []
    stored = word0
    sequence = [
        ("write A (exact)", wordA, Priority.EXACT),
        ("repeat A (exact) -> CMP cut", wordA, Priority.EXACT),
        ("write 0 (low)", word0, Priority.LOW),
        ("repeat 0 (low) -> CMP cut", word0, Priority.LOW),
        ("write A (low)", wordA, Priority.LOW),
    ]
    for i, (name, target, level) in enumerate(sequence):
        stored, st = approx_write_with_stats(
            rng.fold_in(key, i), stored, target, level,
            per_bit_levels=False)
        events.append({
            "event": name,
            "level": int(level),
            "energy_pj": float(st.energy_pj),
            "latency_ns": float(st.latency_ns),
            "bits_flipped": int(st.bits_written),
            "bit_errors": int(st.bit_errors),
        })
    # Fig. 12's key claims
    checks = {
        "repetitive_write_is_free": events[1]["energy_pj"] == 0.0
        and events[3]["energy_pj"] == 0.0,
        "low_write_cheaper_than_exact": events[4]["energy_pj"]
        < events[0]["energy_pj"],
    }
    return {"events": events, "checks": checks}


def parser():
    return arg_parser(__doc__)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    out = run(device=args.device)
    for e in out["events"]:
        print(f"{e['event']:30s} E={e['energy_pj']:8.1f} pJ "
              f"lat={e['latency_ns']:5.2f} ns flips={e['bits_flipped']:3d} "
              f"errs={e['bit_errors']}")
    print(out["checks"])


if __name__ == "__main__":
    main()
