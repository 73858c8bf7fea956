"""Plain-PyTorch twin of the extent_write kernel (``extent_write_ref``).

The same semantics as ``repro.kernels.extent_write.ref`` over flat lane
vectors: XOR bit diff, per-bit-plane stochastic write failure drawn from
the murmur3 counter hash of (seed, flat lane index, plane), stored word
``new ^ fail_mask``, and the energy / flip / error totals.

Lanes are int32 tensors holding uint32 bit patterns. The hash runs in
int64 masked to 32 bits, because torch implements no shifts or
comparisons for ``torch.uint32`` on the CPU; 32-bit products are split
into 16-bit halves so no int64 product ever overflows. The planes are
walked one at a time, so memory stays O(lanes) for any tensor size.
Energy is the float64 sum over planes of (integer flip count x plane
energy), rounded once to float32 — exact up to that rounding.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

M32 = 0xFFFFFFFF
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
K_ELEM = 2654435761   # Knuth multiplicative hash, per flat lane index
K_BIT = 0x9E3779B9    # golden-ratio increment, per bit plane


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit constant
    ``c``, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over int64-held uint32 words."""
    x = x ^ (x >> 16)
    x = mul32(x, M1)
    x = x ^ (x >> 13)
    x = mul32(x, M2)
    return x ^ (x >> 16)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor of the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def extent_write_ref(old_u: torch.Tensor, new_u: torch.Tensor, seed: int,
                     thr01: torch.Tensor, thr10: torch.Tensor,
                     e01: torch.Tensor, e10: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``old_u``/``new_u``: (N,) int32 lanes; ``seed``: host uint32;
    ``thr01``/``thr10``: (32,) int32 thresholds (wer * 2^32 as uint32
    patterns); ``e01``/``e10``: (32,) float32 per-flip energies (pJ).
    Returns (stored (N,) int32, {energy_pj, flips01, flips10, errors})."""
    n_planes = thr01.shape[0]
    o = as_u32(old_u)
    n = as_u32(new_u)
    lane = torch.arange(o.numel(), dtype=torch.int64, device=o.device)
    base = mul32(lane, K_ELEM) ^ (int(seed) & M32)
    t01, t10 = as_u32(thr01), as_u32(thr10)
    diff = o ^ n
    fail_mask = torch.zeros_like(o)
    f01 = torch.zeros((n_planes,), dtype=torch.int64, device=o.device)
    f10 = torch.zeros_like(f01)
    err = torch.zeros((), dtype=torch.int64, device=o.device)
    for b in range(n_planes):
        flip = ((diff >> b) & 1).bool()
        to_ap = flip & ((n >> b) & 1).bool()
        u = hash_u32(base ^ ((b * K_BIT) & M32))
        fail = flip & (u < torch.where(to_ap, t01[b], t10[b]))
        fail_mask = fail_mask | (fail.to(torch.int64) << b)
        f01[b] = to_ap.sum()
        f10[b] = (flip & ~to_ap).sum()
        err = err + fail.sum()
    stored = as_i32(n ^ fail_mask)
    energy = (f01.double() * e01.double()
              + f10.double() * e10.double()).sum().to(torch.float32)
    return stored, {"energy_pj": energy, "flips01": f01.sum(),
                    "flips10": f10.sum(), "errors": err}
