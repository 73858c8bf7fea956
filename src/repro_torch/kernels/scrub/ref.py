"""Plain-PyTorch twin of the scrub kernel (``scrub_ref``).

The same semantics as ``repro.kernels.scrub.ref`` over flat lane
vectors. A scrub pass corrects the decayed bits of a stored word:
``corrected = stored ^ mask``, and every bit set in ``mask`` is
re-written toward its corrected value through the EXTENT driver. The
re-write's direction is the corrected bit's (0->1 when it is set); it
fails when the counter hash of (seed, flat lane index, plane) falls
below that direction's threshold, and pays the plane's energy whether or
not it fails. Failed corrections stay decayed: ``scrubbed = corrected ^
fail`` and the residual mask is ``fail``, retried on the next pass.

Written in the style of ``kernels/extent_write/ref.py``: lanes are int32
tensors holding uint32 bit patterns, the hash runs in int64 masked to 32
bits, the planes are walked one at a time, and the energy is the float64
sum over planes of (integer count x plane energy), rounded once to
float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.extent_write.ref import (K_BIT, K_ELEM, M32, as_i32,
                                                  as_u32, hash_u32, mul32)


def scrub_ref(stored_u: torch.Tensor, mask_u: torch.Tensor, seed: int,
              thr01: torch.Tensor, thr10: torch.Tensor,
              e01: torch.Tensor, e10: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor,
                         Dict[str, torch.Tensor]]:
    """``stored_u``/``mask_u``: (N,) int32 lanes; ``seed``: host uint32;
    ``thr01``/``thr10``: (32,) int32 thresholds (uint32 patterns, lane
    layout); ``e01``/``e10``: (32,) float32 pJ per re-written bit.
    Returns (scrubbed (N,) int32, residual (N,) int32,
    {energy_pj, flips01, flips10, errors})."""
    n_planes = thr01.shape[0]
    s = as_u32(stored_u)
    m = as_u32(mask_u)
    corrected = s ^ m
    lane = torch.arange(s.numel(), dtype=torch.int64, device=s.device)
    base = mul32(lane, K_ELEM) ^ (int(seed) & M32)
    t01, t10 = as_u32(thr01), as_u32(thr10)
    fail_mask = torch.zeros_like(s)
    f01 = torch.zeros((n_planes,), dtype=torch.int64, device=s.device)
    f10 = torch.zeros_like(f01)
    err = torch.zeros((), dtype=torch.int64, device=s.device)
    for b in range(n_planes):
        rewrite = ((m >> b) & 1).bool()
        to_ap = rewrite & ((corrected >> b) & 1).bool()
        u = hash_u32(base ^ ((b * K_BIT) & M32))
        fail = rewrite & (u < torch.where(to_ap, t01[b], t10[b]))
        fail_mask = fail_mask | (fail.to(torch.int64) << b)
        f01[b] = to_ap.sum()
        f10[b] = (rewrite & ~to_ap).sum()
        err = err + fail.sum()
    scrubbed = as_i32(corrected ^ fail_mask)
    energy = (f01.double() * e01.double()
              + f10.double() * e10.double()).sum().to(torch.float32)
    return scrubbed, as_i32(fail_mask), {
        "energy_pj": energy, "flips01": f01.sum(), "flips10": f10.sum(),
        "errors": err}
