"""Entry point of the kv_quant kernel: fused int8 KV quantise + EXTENT
store (``kv_quant_store``) and its inverse (``kv_dequant``, plain torch,
as the reference computes it outside Pallas).

The counterpart of ``repro.kernels.kv_quant.ops``. The payload's bits are
written through the erased-row model at one driver level; the sign bit
rides one level stricter. The kernel or its twin follows the tensor's
device (``kernel.kv_quant_cuda``)."""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import write_driver
from repro_torch.core.priority import Priority
from repro_torch.kernels.kv_quant import kernel as K
from repro_torch.kernels.kv_quant.ref import BLOCK


@functools.lru_cache(maxsize=8)
def thresholds(level: Priority) -> np.ndarray:
    """(8,) uint32 per-bit failure thresholds for the int8 payload: the
    level's 0->1 WER x 2^32, the top (sign) bit one level stricter."""
    table = write_driver.level_table()
    lvl = int(Priority.coerce(level))
    codes = np.full((8,), lvl, np.int32)
    codes[7] = min(lvl + 1, int(Priority.EXACT))
    wer = np.asarray(table["wer01"])[codes]
    thr = (np.clip(wer, 0.0, 1.0) * 2 ** 32).astype(np.uint64)
    return thr.clip(0, 2 ** 32 - 1).astype(np.uint32)


@functools.lru_cache(maxsize=64)
def threshold_tensor(level: Priority, device: torch.device) -> torch.Tensor:
    """``thresholds(level)`` as (8,) int32 bit patterns on ``device``."""
    return torch.from_numpy(thresholds(level).view(np.int32)).to(device)


def kv_quant_store(key: np.ndarray, kv: torch.Tensor, *,
                   level: Priority = Priority.MID
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Dict[str, object]]:
    """Quantise and approximately store ``kv`` (any shape, float32 or
    bfloat16). ``key`` is a threefry key (``repro_torch.rng``); the
    kernel's seed is ``bits(key, (1,))``. Returns (int8 payload of
    ``kv``'s shape, per-block scales (blocks, 1) float32, stats): the
    summed bit errors (a device tensor), and the bytes stored and saved.
    Dequantise with ``kv_dequant``. MID is the default level: every
    payload bit is significant once the mantissa tail is quantised away."""
    level = Priority.coerce(level)
    seed = int(rng.bits(key, (1,))[0])
    flat = kv.reshape(-1).contiguous()
    stored, scales, errors = K.kv_quant_cuda(
        flat, seed, threshold_tensor(level, kv.device))
    n = flat.numel()
    stats = {"errors": errors.to(torch.int64).sum(), "bytes_stored": n,
             "bytes_saved": n * (kv.element_size() - 1)}
    return stored.reshape(kv.shape), scales, stats


def kv_dequant(q: torch.Tensor, scales: torch.Tensor,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of ``kv_quant_store``'s layout: each payload byte times its
    block's scale, in float32, rounded to ``out_dtype``."""
    flat = q.reshape(-1)
    n = flat.numel()
    pad = (-n) % (BLOCK[0] * BLOCK[1])
    qp = torch.cat([flat, flat.new_zeros(pad)])
    rows = qp.numel() // BLOCK[1]
    q2 = qp.reshape(rows // BLOCK[0], BLOCK[0], -1, BLOCK[1])
    out = q2.float() * scales[:, None, :, None]
    return out.reshape(-1)[:n].reshape(q.shape).to(out_dtype)
