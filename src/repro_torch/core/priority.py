"""Priority-tagging API (paper Fig. 10/11) over nested dicts of tensors.

The slice of ``repro.core.priority`` the serving path needs: the four
driver levels, the KV-cache tagging policy, and the per-bit-plane
priority codes of a float word (sign/exponent EXACT, mantissa degrading
toward LOW at the least significant bits).

A leaf's *path* is the tuple of dict keys leading to it; policies match
on ``keystr(path)``, which renders exactly like JAX's key paths
(``"['slot0']['k']"``) so both packages tag the same leaves alike.
"""
from __future__ import annotations

import enum
from typing import Any, Tuple

import numpy as np
import torch


class Priority(enum.IntEnum):
    LOW = 0b00
    MID = 0b01
    HIGH = 0b10
    EXACT = 0b11

    @classmethod
    def coerce(cls, v) -> "Priority":
        if isinstance(v, cls):
            return v
        if isinstance(v, str):
            return cls[v.upper()]
        return cls(int(v))


def keystr(path: Tuple[Any, ...]) -> str:
    return "".join(f"[{k!r}]" for k in path)


def path_contains(path: Tuple[Any, ...], *names: str) -> bool:
    s = keystr(path)
    return any(n in s for n in names)


def kv_cache_policy(path, leaf) -> Priority:
    """KV-cache tagging: V tolerates more error than K; recurrent states
    stay exact; anything else HIGH."""
    if path_contains(path, "'v'"):
        return Priority.LOW
    if path_contains(path, "'k'"):
        return Priority.MID
    if path_contains(path, "state", "conv"):
        return Priority.EXACT
    return Priority.HIGH


def bits_of(dtype: torch.dtype) -> int:
    return dtype.itemsize * 8


def uint_type(dtype: torch.dtype) -> torch.dtype:
    return {1: torch.uint8, 2: torch.uint16, 4: torch.uint32,
            8: torch.uint64}[dtype.itemsize]


def int_type(dtype: torch.dtype) -> torch.dtype:
    """The signed integer dtype of ``dtype``'s width: the port's bit view
    of a float word (torch has no shifts or compares for uint16/uint32 on
    the CPU), the counterpart of the reference's ``uint_type`` views."""
    return {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[dtype.itemsize]


def mantissa_bits(dtype: torch.dtype) -> int:
    return {torch.bfloat16: 7, torch.float16: 10,
            torch.float32: 23}.get(dtype, 0)


def bitplane_priorities(dtype: torch.dtype,
                        tensor_level: Priority) -> np.ndarray:
    """Per-bit priority codes (LSB..MSB) for one element of ``dtype``.

    sign+exponent bits are always EXACT; mantissa bits degrade from the
    tensor's level at the top of the mantissa down to LOW at the LSBs.
    Integer dtypes: the low three quarters at tensor level, the rest EXACT.
    """
    n = bits_of(dtype)
    m = mantissa_bits(dtype)
    out = np.full((n,), int(Priority.EXACT), np.int32)
    lvl = int(tensor_level)
    if lvl == int(Priority.EXACT):
        return out
    if m == 0:
        out[: max(1, 3 * n // 4)] = lvl
        return out
    out[:m] = lvl
    out[: max(1, m // 2)] = max(int(Priority.LOW), lvl - 1)
    out[m:] = int(Priority.EXACT)
    return out
