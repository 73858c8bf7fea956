"""Lane packing and the entry of the scrub kernel.

The counterpart of ``repro.kernels.scrub.ops``. The decay mask rides in
element space (the stored dtype's same-width integer view, same shape,
maintained by ``repro_torch.reliability.lifetime``) and is lane-packed
exactly like the data, so the lane scrub sees matching lanes. The
driver operands are the write plan's lane-tiled (thr01, thr10, e01, e10)
vectors: a scrub pays write-path prices.

This module is plumbing for ``repro_torch.memory``: everything else
reaches scrubbing through ``Backend.leaf_scrub`` or
``repro_torch.reliability.scrub``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.extent_write.ops import from_lanes, to_lanes

LaneScrub = Callable[..., Tuple[torch.Tensor, torch.Tensor,
                                Dict[str, torch.Tensor]]]


def scrub_write(seed: int, stored: torch.Tensor, mask: torch.Tensor,
                vectors: Tuple[torch.Tensor, ...], impl: LaneScrub
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
    """Corrective re-write of the decayed bits of ``stored`` through the
    lane scrub ``impl`` (the twin or the CUDA wrapper). ``mask`` is the
    element-space decayed-bit mask (an integer tensor of the stored
    dtype's width and shape); ``seed`` the host uint32 hash seed.

    Returns (scrubbed, residual mask, {energy_pj, flips01, flips10,
    errors, bits_total}); ``bits_total`` counts the element bits scanned,
    never the lane padding."""
    assert stored.shape == mask.shape, (stored.shape, mask.shape)
    assert (mask.element_size() == stored.element_size()
            and not mask.dtype.is_floating_point), (mask.dtype, stored.dtype)
    scrubbed_u, residual_u, stats = impl(to_lanes(stored), to_lanes(mask),
                                         seed, *vectors)
    stats = dict(stats)
    stats["bits_total"] = stored.numel() * stored.element_size() * 8
    return (from_lanes(scrubbed_u, stored.shape, stored.dtype),
            from_lanes(residual_u, mask.shape, mask.dtype), stats)
