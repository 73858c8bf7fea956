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
  * ``bits(key, shape)`` -> ``y0 ^ y1`` of ``threefry2x32(key, (0, i))``
    for the flat (row-major) index ``i`` of each element;
  * ``uniform(key, shape)`` -> ``f32((bits >> 9) | 0x3F800000) - 1``, the
    float32 draw of ``jax.random.uniform``;
  * ``bernoulli(key, p, shape)`` -> ``uniform < f32(p)``, the ``mode="low"``
    draw of ``jax.random.bernoulli``.

Keys are ``(2,)`` numpy uint32 arrays. The host versions are numpy; the
``*_t`` versions draw the same words on a torch device (the eager oracle
and the soft-error hook draw one word per stored bit, tens of millions
per admission): the counter runs there, in int64 ops masked to 32 bits,
while the key words stay host scalars, so a draw never reads the device.
"""
from __future__ import annotations

import numpy as np
import torch

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


def _to_unit_float(b: np.ndarray) -> np.ndarray:
    return ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)


def uniform(key: np.ndarray, shape) -> np.ndarray:
    """float32 draws in [0, 1) of ``shape``, as ``jax.random.uniform``."""
    return _to_unit_float(bits(key, shape))


def bernoulli(key: np.ndarray, p: float, shape) -> np.ndarray:
    """bool draws of ``shape``, True with probability ``p`` (as float32)."""
    return uniform(key, shape) < np.float32(p)


# --------------------------------------------------------------------------
# the same draws on a torch device
# --------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def counter_bits_t(key: np.ndarray, ctr: torch.Tensor) -> torch.Tensor:
    """``bits`` at the int64 counters ``ctr`` (flat indices below 2^32),
    on ``ctr``'s device: int64 values in [0, 2^32)."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = torch.full_like(ctr, ks[0])
    x1 = (ctr + ks[1]).bitwise_and_(M32)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            hi = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi)
            x1.bitwise_and_(M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_((ks[(i + 2) % 3] + i + 1) & M32).bitwise_and_(M32)
    return x0.bitwise_xor_(x1)


def check_count(n: int) -> None:
    assert n < 2 ** 32, f"{n} counters: the high counter word would be used"


def bits_t(key: np.ndarray, shape, device) -> torch.Tensor:
    """``bits(key, shape)`` on ``device``, as int64 values in [0, 2^32)."""
    n = int(np.prod(shape))
    check_count(n)
    ctr = torch.arange(n, dtype=torch.int64, device=device)
    return counter_bits_t(key, ctr).reshape(tuple(shape))


def unit_float_t(b: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the float32 draws ``uniform`` makes."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def uniform_t(key: np.ndarray, shape, device) -> torch.Tensor:
    return unit_float_t(bits_t(key, shape, device))


def bernoulli_t(key: np.ndarray, p: float, shape, device) -> torch.Tensor:
    return uniform_t(key, shape, device) < float(np.float32(p))
