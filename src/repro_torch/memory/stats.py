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
import functools
from typing import Any, Dict

import torch


#: bytes ``popcount`` looks up at a time (its int64 index is 8x as large)
POPCOUNT_CHUNK = 1 << 26


def popcount(m: torch.Tensor) -> torch.Tensor:
    """Set bits of an integer tensor, summed to a 0-d int64 (a 256-entry
    byte table: torch has no popcount), ``POPCOUNT_CHUNK`` bytes at a
    time."""
    b = m.reshape(-1).contiguous().view(torch.uint8)
    if b.numel() <= POPCOUNT_CHUNK:
        return popcount_rows(b.reshape(1, -1))[0]
    return sum(popcount_rows(c.reshape(1, -1))[0]
               for c in b.split(POPCOUNT_CHUNK))


def popcount_rows(m: torch.Tensor) -> torch.Tensor:
    """Set bits of each row of a 2-d integer tensor: (rows,) int64."""
    table = _byte_popcount(m.device)
    b = m.contiguous().view(torch.uint8).reshape(m.shape[0], -1)
    return table[b.to(torch.int64)].sum(1)


@functools.lru_cache(maxsize=4)
def _byte_popcount(device: torch.device) -> torch.Tensor:
    """Set bits of every byte value, built on ``device`` by device ops
    (no copy from the host, so a burst may build it)."""
    v = torch.arange(256, dtype=torch.int64, device=device)
    return sum((v >> b) & 1 for b in range(8))


@dataclasses.dataclass(frozen=True)
class WriteStats:
    energy_pj: torch.Tensor     # f32: realized write energy
    latency_ns: torch.Tensor    # f32: slowest used driver (max-reduced)
    flips01: torch.Tensor       # i64: 0->1 writes (P->AP)
    flips10: torch.Tensor       # i64: 1->0 writes
    errors: torch.Tensor        # i64: failed flips
    soft_strikes: torch.Tensor  # i64: post-write soft-error upsets
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

    def packed(self) -> torch.Tensor:
        """The seven fields as one float64 (7,) device tensor (exact:
        float32 energies widen exactly, counters stay below 2^53), so a
        caller can join them to one host transfer with others."""
        return torch.stack([self.energy_pj.to(torch.float64),
                            self.latency_ns.to(torch.float64),
                            *(getattr(self, k).to(torch.float64) for k in (
                                "flips01", "flips10", "errors",
                                "soft_strikes", "bits_total"))])

    def host_dict(self) -> Dict[str, Any]:
        """Sync to the host (one transfer of seven scalars) and derive the
        report quantities."""
        return report_of(self.packed().tolist())


def report_of(h) -> Dict[str, Any]:
    """The report quantities of ``WriteStats.packed()``'s seven host
    values."""
    e, lat = float(h[0]), float(h[1])
    f01, f10, errors, strikes, bits_total = (int(v) for v in h[2:7])
    bits_written = f01 + f10
    return {
        "energy_pj": e,
        "latency_ns": lat,
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
