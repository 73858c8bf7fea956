"""Plain-PyTorch twin of the kv_quant kernel (``kv_quant_ref``).

The same semantics as ``repro.kernels.kv_quant.ref.kv_quant_ref`` over
(R, 128) float32 rows in blocks of (64, 128): per block a symmetric int8
quantise, scale = max(absmax, 1e-12) / 127 and
q = clip(round_half_even(x / scale), -127, 127), then the erased-row
store of q's two's-complement byte, in which set bit b of flat element e
fails when the counter hash ``uniform_bits(seed, e, b)`` is below
``thr[b]``. The hash is the extent_write twin's (int64 held uint32).

The reference's scale is, bit for bit, max(absmax, 1e-12) times the
float32 reciprocal of 127: XLA rewrites a division by a constant into
that product. Its x / scale is a true division. Both are reproduced."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.extent_write.ref import (K_BIT, K_ELEM, M32,
                                                  as_u32, hash_u32, mul32)

#: quantisation block (rows, columns) of the (R, 128) layout
BLOCK = (64, 128)
QMAX = 127.0
#: 1/127 rounded to float32: the reference's scale multiplies by it
QMAX_INV = float(np.float32(1.0) / np.float32(QMAX))


def kv_quant_ref(x: torch.Tensor, seed: int, thr: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x`` (R, 128) float32 with R a multiple of 64; ``seed`` a host
    uint32; ``thr`` (8,) int32 holding the per-bit uint32 thresholds.
    Returns (stored int8 (R, 128), scales (R/64, 1) f32, errors (R/64, 1)
    int32)."""
    R, C = x.shape
    br, bc = BLOCK
    gr, gc = R // br, C // bc
    absmax = x.reshape(gr, br, gc, bc).abs().amax(dim=(1, 3))
    scales = torch.clamp(absmax, min=1e-12) * QMAX_INV
    per_elem = scales.repeat_interleave(br, 0).repeat_interleave(bc, 1)
    q = torch.round(x / per_elem).clamp(-QMAX, QMAX).to(torch.int64) & 0xFF
    elem = torch.arange(R * C, dtype=torch.int64,
                        device=x.device).reshape(R, C) & M32
    base = mul32(elem, K_ELEM) ^ (int(seed) & M32)
    t = as_u32(thr)
    fail = torch.zeros_like(q)
    nerr = torch.zeros_like(q)
    for b in range(8):
        f = ((q >> b) & 1).bool() & (hash_u32(base ^ ((b * K_BIT) & M32))
                                     < t[b])
        fail |= f.to(torch.int64) << b
        nerr += f
    stored = (((q ^ fail) ^ 0x80) - 0x80).to(torch.int8)
    errors = nerr.reshape(gr, br, gc, bc).sum(dim=(1, 3)).to(torch.int32)
    return stored, scales, errors
