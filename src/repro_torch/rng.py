"""Host-side threefry2x32 key schedule, bit-exact with JAX's default PRNG.

The serving path's key schedule never depends on data: the engine splits
its key three ways per step, the write plan folds the leaf index into the
step's write key, and each kernel seed is ``bits(key, (1,), uint32)``.
So the whole schedule runs here on the host in numpy uint32 arithmetic,
and every kernel receives its seed as a plain scalar argument — the token
loop never reads the device to derive randomness.

Matches JAX's ``threefry2x32`` implementation with
``jax_threefry_partitionable=True`` (the default since JAX 0.5) and 64-bit
types off:

  * ``PRNGKey(seed)``  -> ``[seed >> 32, seed & 0xFFFFFFFF]`` (the high word
    is 0 for 32-bit seeds);
  * ``split(key, n)``  -> row ``i`` is ``threefry2x32(key, (0, i))``;
  * ``fold_in(key, d)`` -> ``threefry2x32(key, (0, d))``;
  * ``bits(key, (1,))`` -> ``y0 ^ y1`` of ``threefry2x32(key, (0, 0))``.

Keys are ``(2,)`` numpy uint32 arrays.
"""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round Threefry-2x32 block function over uint32 count words
    ``(x0, x1)`` (arrays of one shape). Returns ``(y0, y1)``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``(num, 2)`` uint32 subkeys."""
    y0, y1 = threefry2x32(key, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def bits(key: np.ndarray, shape=(1,)) -> np.ndarray:
    """Uniform uint32 words of ``shape`` (the 32-bit partitionable draw)."""
    n = int(np.prod(shape))
    y0, y1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return (y0 ^ y1).reshape(shape)


def seed_u32(key: np.ndarray) -> int:
    """A kernel's scalar seed: ``bits(key, (1,), uint32)[0]`` as an int."""
    return int(bits(key, (1,))[0])
