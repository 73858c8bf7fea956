"""Unified, device-resident write statistics for the memory substrate.

One schema for every backend: a frozen dataclass of 0-d device tensors
that the decode burst carries from step to step, that reduces across
leaves/slots/steps with ``+`` (counters and energy sum; latency takes
the max — parallel driver banks are bounded by the slowest used driver),
and that crosses to the host once, via ``host_dict()``, when a report is
assembled. Counters are int64, so ``bits_total`` stays exact however long
a run writes (the JAX package needs two int32 limbs for the same).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass(frozen=True)
class WriteStats:
    energy_pj: torch.Tensor     # f32: realized write energy
    latency_ns: torch.Tensor    # f32: slowest used driver (max-reduced)
    flips01: torch.Tensor       # i64: 0->1 writes (P->AP)
    flips10: torch.Tensor       # i64: 1->0 writes
    errors: torch.Tensor        # i64: failed flips
    soft_strikes: torch.Tensor  # i64: post-write upsets (hook not ported)
    bits_total: torch.Tensor    # i64: addressed element bits

    @classmethod
    def zero(cls, device) -> "WriteStats":
        z32 = torch.zeros((), dtype=torch.float32, device=device)
        zi = torch.zeros((), dtype=torch.int64, device=device)
        return cls(energy_pj=z32, latency_ns=z32, flips01=zi, flips10=zi,
                   errors=zi, soft_strikes=zi, bits_total=zi)

    @classmethod
    def for_bits(cls, bits: int, device, **kw) -> "WriteStats":
        """Zero stats carrying a static addressed-bit count; backends
        fill the realized fields via keyword arguments."""
        z = cls.zero(device)
        return dataclasses.replace(
            z, bits_total=torch.full((), int(bits), dtype=torch.int64,
                                     device=device), **kw)

    def __add__(self, other: "WriteStats") -> "WriteStats":
        return WriteStats(
            energy_pj=self.energy_pj + other.energy_pj,
            latency_ns=torch.maximum(self.latency_ns, other.latency_ns),
            flips01=self.flips01 + other.flips01,
            flips10=self.flips10 + other.flips10,
            errors=self.errors + other.errors,
            soft_strikes=self.soft_strikes + other.soft_strikes,
            bits_total=self.bits_total + other.bits_total,
        )

    @property
    def bits_written(self) -> torch.Tensor:
        return self.flips01 + self.flips10

    def host_dict(self) -> Dict[str, Any]:
        """Sync to the host (one transfer of seven scalars) and derive the
        report quantities."""
        h = torch.stack([self.flips01, self.flips10, self.errors,
                         self.soft_strikes, self.bits_total]).tolist()
        e = torch.stack([self.energy_pj, self.latency_ns]).tolist()
        f01, f10, errors, strikes, bits_total = (int(v) for v in h)
        bits_written = f01 + f10
        return {
            "energy_pj": float(e[0]),
            "latency_ns": float(e[1]),
            "flips01": f01,
            "flips10": f10,
            "bits_written": bits_written,
            "bits_total": bits_total,
            "bit_errors": errors,
            "soft_strikes": strikes,
            "write_skip_rate": (1.0 - bits_written / bits_total
                                if bits_total else 0.0),
            "ber_realized": errors / max(1, bits_written),
        }
