"""Priority-tagging API: the paper's "software support" layer (Fig. 10/11).

  * ``Priority`` — the four driver levels;
  * ``tag_pytree(tree, rule)`` — map the leaves of a tree of tensors (by
    path, name or dtype) to levels; ``checkpoint_policy`` and
    ``kv_cache_policy`` are the standard rules;
  * bit-plane priorities — within one float word, sign and exponent bits
    are EXACT and the mantissa degrades toward LOW at the least
    significant bits (``bitplane_priorities``, ``priority_mask``).

A leaf's *path* is the tuple of keys leading to it (``tree.map_with_path``:
dict keys, sequence indices, NamedTuple fields); policies match on
``keystr(path)``, which renders exactly like JAX's key paths
(``"['slot0']['k']"``, ``"[0].mu['w']"``) so both packages tag the same
leaves alike.
"""
from __future__ import annotations

import enum
from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch import tree as T


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
    return "".join(f".{k.name}" if isinstance(k, T.GetAttrKey) else f"[{k!r}]"
                   for k in path)


def path_contains(path: Tuple[Any, ...], *names: str) -> bool:
    s = keystr(path)
    return any(n in s for n in names)


def tag_pytree(tree: Any, rule: Callable[[Tuple[Any, ...], Any], Any],
               default: Priority = Priority.EXACT) -> Any:
    """Tree of tensors -> same-structure tree of Priority.

    ``rule(path, leaf)`` may return a Priority / int / str / None (None ->
    default); dict keys and NamedTuple fields match by name."""
    def one(path, leaf):
        r = rule(path, leaf)
        return default if r is None else Priority.coerce(r)

    return T.map_with_path(one, tree)


def checkpoint_policy(path, leaf) -> Priority:
    """Checkpoint tagging: weights exact; optimizer second moments are the
    most error-tolerant (smoothed statistics); first moments mid."""
    if path_contains(path, ".v", "nu"):
        return Priority.LOW
    if path_contains(path, ".m", "mu"):
        return Priority.MID
    return Priority.EXACT


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


def priority_mask(dtype: torch.dtype, tensor_level: Priority
                  ) -> torch.Tensor:
    """(bits,) int32 priority-code vector (host) for broadcasting against
    unpacked bit tensors."""
    return torch.from_numpy(bitplane_priorities(dtype, tensor_level))


def priority_of(tags: Any, path_leaf) -> Priority:
    """Fetch a tag from a tagged tree by key (dict trees; anything else
    is EXACT)."""
    return tags[path_leaf] if isinstance(tags, dict) else Priority.EXACT
