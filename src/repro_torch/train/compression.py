"""Error-feedback int8 gradient compression (the counterpart of
``repro.train.compression``).

Gradients are quantised to int8 per leaf (symmetric; one scale per
tensor, or per leading-axis slice with ``per_channel``), and the
quantisation residual is carried in an error-feedback accumulator, so
its bias cancels over steps. The wire moves 4x fewer bytes than float32.

With ``wire_backend`` set, each int8 code tensor is also stored through
the EXTENT substrate (``memory.write`` at ``wire_level``, over a cold
buffer of zeros, leaf ``i`` keyed ``fold_in(key, i)``) before it is
dequantised: the int8 lanes of the write kernel, upsets absorbed by the
error feedback.

Over a (data, model) process mesh (``dims``: each leaf's
``sharding.rules.Cut``) each rank compresses its block of the gradient
as one process compresses the whole: a per-tensor scale takes the
largest magnitude over the ranks holding the leaf's other blocks (an
all-reduce MAX over each axis that cuts it), a per-channel scale too
over each axis that does not cut the channel axis; the residual stays
the rank's block; a wire write gathers the leaf's codes whole, writes
them under its key as one process does, and keeps the rank's block of
the stored codes, so the stored words and the ``WriteStats`` are one
process's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.core.priority import Priority

#: ``compress_grads``' key when the caller gives none (the reference's)
DEFAULT_WIRE_KEY = 0x5717


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8          # int8 wire format
    enable: bool = True
    #: per-channel (leading-axis) scales for leaves of two or more axes
    per_channel: bool = True
    #: a ``repro_torch.memory`` backend name for the wire buffer's
    #: writes (None: an exact wire)
    wire_backend: Optional[str] = None
    wire_level: Priority = Priority.HIGH


def init_state(params: Any) -> Any:
    """The error-feedback residual: zeros in float32, one per leaf."""
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def quantize(g: torch.Tensor, bits: int, *, per_channel: bool = False,
             cut=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int quantisation of ``g`` (float32): (int8 codes, scale).
    The scale is per tensor, or with ``per_channel`` and two or more axes
    per leading-axis slice, shape (d0, 1, ..., 1). The scale is a true
    float32 division by ``qmax``, as the reference's eager call
    computes it. ``cut`` (a ``sharding.rules.Cut``): ``g`` is this
    rank's block of a leaf over a process mesh, and the scale is the
    whole leaf's (its block of rows where the channels are cut)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    if per_channel and g.dim() >= 2:
        amax = torch.amax(torch.abs(g), dim=tuple(range(1, g.dim())),
                          keepdim=True)
    else:
        amax = torch.amax(torch.abs(g))
    if cut is not None:
        cut.max_(amax, rows=amax.dim() > 0)
    scale = torch.clamp(amax, min=1e-12) / qmax
    q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def wire_write(key: np.ndarray, q: torch.Tensor, cfg: CompressionConfig,
               cut=None):
    """The staging buffer's cold write of int8 codes ``q`` under ``key``
    (every code bit pays): (the stored codes, ``WriteStats``). ``cut``:
    ``q`` is this rank's block (``quantize``); the whole leaf is
    gathered and written, and this rank's block of it kept."""
    from repro_torch import memory
    whole = q if cut is None else cut.whole(q)
    stored, st = memory.write(key, torch.zeros_like(whole), whole,
                              level=cfg.wire_level, backend=cfg.wire_backend)
    if cut is not None:
        stored = cut.block(stored)
    return stored, st


def compress_grads(grads: Any, ef: Any, cfg: CompressionConfig,
                   key: Optional[np.ndarray] = None, *,
                   with_stats: bool = False,
                   dims: Optional[List[Any]] = None):
    """(grads, residual) -> (the gradients as the wire delivers them, the
    new residual), plus the wire writes' ``WriteStats`` with
    ``with_stats`` (None without a wire backend). ``key`` (a host
    threefry key) seeds the wire writes; without one a fixed key is
    used, as in the reference. ``dims`` (``MeshShards.flat_dims``): the
    leaves are this rank's blocks, compressed as the whole leaves are;
    the stats are the whole leaves', once."""
    if not cfg.enable:
        return (grads, ef, None) if with_stats else (grads, ef)

    flat_g, tdef = T.flatten_with_def(grads)
    flat_e = tdef.flatten_up_to(ef)
    dims = dims or [None] * len(flat_g)
    wire = cfg.wire_backend is not None
    stats = None
    if wire:
        from repro_torch import memory
        if key is None:
            key = rng.PRNGKey(DEFAULT_WIRE_KEY)
        stats = memory.WriteStats.zero(flat_g[0][1].device)

    out = []
    for i, ((_, g), e, d) in enumerate(zip(flat_g, flat_e, dims)):
        g32 = g.to(torch.float32) + e
        q, scale = quantize(g32, cfg.bits, per_channel=cfg.per_channel,
                            cut=d)
        if wire:
            q, st = wire_write(rng.fold_in(key, i), q, cfg, d)
            stats = stats + st
        deq = dequantize(q, scale)
        out.append((deq.to(g.dtype), g32 - deq))
    res = (tdef.unflatten([o[0] for o in out]),
           tdef.unflatten([o[1] for o in out]))
    return res + (stats,) if with_stats else res


def make_grad_transform(cfg: CompressionConfig,
                        key: Optional[np.ndarray] = None):
    """``(grads, ef) -> compress_grads(grads, ef, cfg, key=key)``."""
    def transform_with_state(grads, ef):
        return compress_grads(grads, ef, cfg, key=key)
    return transform_with_state


def wire_bytes_saved(params: Any, cfg: CompressionConfig) -> int:
    """Bytes an int8 wire removes from one all-reduce of ``params``'
    gradients."""
    if not cfg.enable:
        return 0
    flat = T.leaves(params)
    return (sum(p.numel() * p.element_size() for p in flat)
            - sum(p.numel() for p in flat))
