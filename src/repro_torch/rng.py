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
    float32 draw of ``jax.random.uniform``; with ``dtype="bfloat16"`` the
    8-bit draw (the low byte of ``bits``: JAX draws 8 bits for a type of
    fewer than 8 mantissa bits) ``bf16(((b & 0xFF) >> 1) | 0x3F80) - 1``;
    then ``max(minval, u * (maxval - minval) + minval)`` in the dtype;
  * ``bernoulli(key, p, shape)`` -> ``uniform < f32(p)``, the ``mode="low"``
    draw of ``jax.random.bernoulli``;
  * ``randint(key, shape, lo, hi)`` -> int32 draws of
    ``jax.random.randint``: two ``bits`` draws off ``split(key)``,
    combined modulo the span in wrapping uint32 arithmetic;
  * ``normal(key, shape)`` -> ``sqrt(2) * erf_inv(u)`` with ``u`` the
    float32 uniform in ``[nextafter(-1, 0), 1)``, bit-exact with
    ``jax.random.normal`` on the CPU: ``erf_inv`` is XLA's single-precision
    polynomial over ``w = -log1p(-u*u)`` and ``log1p`` XLA's CPU intrinsic
    (a rational form below ``sqrt(2) - 1``, Cephes' ``log`` above), each
    multiply-add fused where XLA's compiler fuses it;
  * ``gumbel`` / ``categorical`` -> ``-log(-log(uniform(minval=tiny)))``
    and ``argmax(gumbel + logits)`` over the last axis (``mode="low"``).
    The uniforms are bit-exact; ``log`` is the platform's (XLA's float32
    ``log`` differs from numpy's and torch's in the last bit of a quarter
    to a third of the values; in bfloat16 the rounding hides it), so a
    float32 sample moves only where two candidates tie within that.

Keys are ``(2,)`` numpy uint32 arrays. The host versions are numpy (a
bfloat16 draw comes back as float32 values that bfloat16 represents:
numpy has no bfloat16); the
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
M32 = 0xFFFFFFFF


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


def _scale_unit(u: np.ndarray, minval: float, maxval: float) -> np.ndarray:
    """float32 unit draws moved to [minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    if lo == 0.0 and hi == 1.0:
        return u
    # XLA contracts the scale and shift into one fused multiply-add: the
    # float64 product is exact and the sum rounds, then rounds to float32
    # (a double rounding, which can differ from the fused one at a tie;
    # at [0, 1) and [tiny, 1) both are exact)
    return np.maximum(lo, (u.astype(np.float64) * (hi - lo)
                           + lo).astype(np.float32))


def bernoulli(key: np.ndarray, p: float, shape) -> np.ndarray:
    """bool draws of ``shape``, True with probability ``p`` (as float32)."""
    return uniform(key, shape) < np.float32(p)


I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
#: the smallest normal float32, the Gumbel draw's ``minval`` (bfloat16
#: shares float32's exponent range, so its smallest normal too)
TINY = float(np.finfo(np.float32).tiny)


def randint(key: np.ndarray, shape, minval: int, maxval: int
            ) -> np.ndarray:
    """int32 draws in ``[minval, maxval)``, as ``jax.random.randint``.
    ``maxval <= minval`` gives ``minval``. Bounds outside int32 raise
    ``OverflowError``, as JAX's do with 64-bit types off (so its
    ``maxval_out_of_range`` widening of the span never applies)."""
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not I32_MIN <= v <= I32_MAX:
            raise OverflowError(f"randint bound {v} is outside int32")
    k1, k2 = split(key, 2)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = np.uint32(1 if maxval <= minval else (maxval - minval) & M32)
    with np.errstate(over="ignore"):
        # (a * b) % N = ((a % N) * (b % N)) % N, every product wrapping
        # at 32 bits as JAX's uint32 lax ops do (at spans of 2^16 and
        # more the multiplier wraps to 0)
        multiplier = np.uint32(2 ** 16) % span
        multiplier = (multiplier * multiplier) % span
        offset = ((higher % span) * multiplier + lower % span) % span
    out = (np.int64(minval) + offset.astype(np.int64)) & M32
    return out.astype(np.uint32).view(np.int32).reshape(shape)


def _dtype_name(dtype) -> str:
    """'float32' / 'bfloat16' of a torch or numpy dtype or its name."""
    name = str(dtype).replace("torch.", "")
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported draw dtype {dtype}")
    return name


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    kept as float32 (finite inputs)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
             ) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def _bf16_bits(key: np.ndarray, shape) -> np.ndarray:
    """The bfloat16 draw's unit floats in [0, 1) as float32 values."""
    b = bits(key, shape) & np.uint32(0xFF)
    return (((b >> np.uint32(1)) | np.uint32(0x3F80)) << np.uint32(16)
            ).view(np.float32) - np.float32(1.0)


def uniform(key: np.ndarray, shape, dtype="float32", minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """Draws in [minval, maxval) of ``shape``, as ``jax.random.uniform``
    in ``dtype`` (float32 or bfloat16, each step rounded to it)."""
    if _dtype_name(dtype) == "float32":
        return _scale_unit(_to_unit_float(bits(key, shape)), minval, maxval)
    r = _round_bf16
    lo, hi = r(np.float32(minval)), r(np.float32(maxval))
    u = _bf16_bits(key, shape)
    return np.maximum(lo, r(r(u * r(hi - lo)) + lo))


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once. The float64 product is exact;
    the float64 sum rounds again only where it lands exactly halfway
    between two float32 values (low 29 mantissa bits ``0x10000000``), and
    there the sum's own rounding error decides the side, as the true
    fused operation would."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(
        b, np.float32).astype(np.float64)
    c = np.broadcast_to(np.asarray(c, np.float32).astype(np.float64),
                        p.shape)
    s = p + c
    r = s.astype(np.float32)
    tie = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)
    if tie.any():
        ps, cs, ss = p[tie], c[tie], s[tie]
        t = ss - ps
        err = (ps - (ss - t)) + (cs - t)  # ss + err == ps + cs exactly
        r = np.array(r)
        r[tie] = np.where(err == 0, r[tie], np.where(
            err > 0, np.nextafter(ss, np.inf), np.nextafter(ss, -np.inf)
        ).astype(np.float32))
    return r


def _f32(*vals):
    return [np.float32(v) for v in vals]


# XLA's CPU float32 log (Cephes' logf): polynomial, ln2 split in two
_LOG_P = _f32(7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
              -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
              2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4, 0.693359375)
# XLA's log1p below sqrt(2) - 1: Cephes' rational form, highest power first
_LOG1P_DEN = _f32(1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
                  2.2176239823732856465394E2, 3.0909872225312059774938E2,
                  2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_NUM = _f32(4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
                  6.5787325942061044846969E0, 2.9911919328553073277375E1,
                  6.0949667980987787057556E1, 5.7112963590585538103336E1,
                  2.0039553499201281259648E1)
# XLA's single-precision erf_inv (Giles), for w < 5 and w >= 5
_ERFINV_LT5 = _f32(2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = _f32(-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)


def xla_log(v: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` of positive finite ``v``."""
    v = np.maximum(np.asarray(v, np.float32), np.float32(2.0 ** -126))
    b = v.view(np.uint32)
    m = ((b & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(np.float32)
    e = ((b >> np.uint32(23)).astype(np.int32) - 126).astype(np.float32)
    small = m < np.float32(0.707106781186547524)
    e = e - small.astype(np.float32)
    t = (m - np.float32(1)) + np.where(small, m, np.float32(0))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(_fma(y, x3, y1), x3, y2), x3, e * _LOG_Q1)
    t = _fma(-x2, np.float32(0.5), t)
    return _fma(e, _LOG_Q2, t + y)


def xla_log1p(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p`` of ``x`` in (-1, 0]."""
    x = np.asarray(x, np.float32)
    x2 = x * x
    num = den = np.zeros_like(x)
    for c in _LOG1P_DEN:
        den = _fma(den, x, c)
    for c in _LOG1P_NUM:
        num = _fma(num, x, c)
    small = x + _fma(x2, np.float32(-0.5), (x * x2) * (num / den))
    return np.where(np.abs(x) < np.float32(0.41421356237309504880), small,
                    xla_log(x + np.float32(1)))


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` of ``x`` in [-1, 1]."""
    x = np.asarray(x, np.float32)
    w = -xla_log1p(-(x * x))
    lt = w < np.float32(5)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, a, b))
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x)


def normal(key: np.ndarray, shape, dtype="float32") -> np.ndarray:
    """float32 standard normal draws of ``shape``, as
    ``jax.random.normal`` computes them on the CPU."""
    if _dtype_name(dtype) != "float32":
        raise ValueError("normal draws float32 only")
    return _normal_of_bits(bits(key, shape))


def _normal_of_bits(b: np.ndarray) -> np.ndarray:
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = _scale_unit(_to_unit_float(b), lo, 1.0)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)


# --------------------------------------------------------------------------
# draws for a stack of keys: what ``vmap`` over ``split(key, n)`` draws
# --------------------------------------------------------------------------


def bits_keys(keys: np.ndarray, shape=(1,)) -> np.ndarray:
    """``bits(k, shape)`` for every key ``k`` of the ``(n, 2)`` stack
    ``keys``, as one ``(n, *shape)`` array: the block function runs on
    the key words as columns, so the n draws are one numpy pass."""
    keys = np.asarray(keys, np.uint32)
    m = int(np.prod(shape))
    y0, y1 = threefry2x32((keys[:, :1], keys[:, 1:]), np.zeros(m, np.uint32),
                          np.arange(m, dtype=np.uint32))
    return (y0 ^ y1).reshape((len(keys),) + tuple(shape))


def split_keys(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """``split(k, num)`` for every key of the ``(n, 2)`` stack:
    ``(n, num, 2)`` uint32 subkeys."""
    keys = np.asarray(keys, np.uint32)
    y0, y1 = threefry2x32((keys[:, :1], keys[:, 1:]),
                          np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=-1)


def normal_keys(keys: np.ndarray, shape=()) -> np.ndarray:
    """``normal(k, shape)`` for every key of the ``(n, 2)`` stack, as one
    float32 ``(n, *shape)`` array: ``vmap(lambda k: normal(k, shape))``
    over the stack, each row bit-exact with its own key's draw."""
    return _normal_of_bits(bits_keys(keys, shape))


def gumbel(key: np.ndarray, shape, dtype="float32") -> np.ndarray:
    """``jax.random.gumbel(..., mode="low")``: -log(-log(u)), u drawn in
    [tiny, 1), each step rounded to ``dtype``."""
    u = uniform(key, shape, dtype, minval=TINY)
    r = _round_bf16 if _dtype_name(dtype) == "bfloat16" else (lambda x: x)
    return -r(np.log(-r(np.log(u))))


def categorical(key: np.ndarray, logits: np.ndarray, dtype="float32"
                ) -> np.ndarray:
    """``jax.random.categorical`` over the last axis: the index of the
    largest ``gumbel + logits`` (the sum rounded to ``dtype``)."""
    logits = np.asarray(logits, np.float32)
    g = gumbel(key, logits.shape, dtype) + logits
    if _dtype_name(dtype) == "bfloat16":
        g = _round_bf16(g)
    return np.argmax(g, axis=-1)


# --------------------------------------------------------------------------
# the same draws on a torch device
# --------------------------------------------------------------------------


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


def uniform_t(key: np.ndarray, shape, device, dtype=torch.float32,
              minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``uniform(key, shape, dtype, minval, maxval)`` on ``device`` as a
    tensor of ``dtype``; the bounds are host scalars."""
    b = bits_t(key, shape, device)
    if _dtype_name(dtype) == "float32":
        u = unit_float_t(b)
        if minval == 0.0 and maxval == 1.0:
            return u
        lo, hi = np.float32(minval), np.float32(maxval)
        # the fused multiply-add, as the host draw emulates it
        return torch.clamp_min((u.double() * float(hi - lo) + float(lo)
                                ).float(), float(lo))
    u = (((b & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(
        torch.bfloat16) - 1.0
    lo, hi = (torch.tensor(v, dtype=torch.bfloat16)
              for v in (minval, maxval))
    return torch.maximum(lo, u * (hi - lo) + lo)


def gumbel_t(key: np.ndarray, shape, device, dtype=torch.float32
             ) -> torch.Tensor:
    """``gumbel`` on ``device`` in ``dtype`` (torch rounds each step)."""
    u = uniform_t(key, shape, device, dtype, minval=TINY)
    return -torch.log(-torch.log(u))


def categorical_t(key: np.ndarray, logits: torch.Tensor) -> torch.Tensor:
    """``categorical`` drawn on the logits' device in their dtype: the
    draw reads nothing back, so a sampled decode burst stays sync-free."""
    g = gumbel_t(key, logits.shape, logits.device, logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def bernoulli_t(key: np.ndarray, p: float, shape, device) -> torch.Tensor:
    return uniform_t(key, shape, device) < float(np.float32(p))
