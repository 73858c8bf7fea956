"""Approximate tensor write oracle: EXTENT's write path at tensor granularity.

The counterpart of ``repro.core.approx_store``. ``oracle_write(key, old,
new, <per-bit driver vectors>)`` models one STT-RAM array write of
``new`` over stored ``old``:

  1. **redundant-write elimination / self-termination (CMP)** — bits where
     new == old draw no energy and are never at risk;
  2. **stochastic write failure** — every *flipping* bit independently fails
     with WER(level, direction); a failed bit RETAINS its old value;
  3. **per-transition energy/latency accounting** from the realized flips.

It draws one float32 uniform per (element, bit) from the threefry stream
of ``key``, the words ``jax.random.uniform(key, shape + (nbits,))`` draws
(``repro_torch.rng``), so stored words, flips and errors are bit-exact
with the JAX oracle on any device. The draws run in chunks of
``CHUNK_DRAWS`` counters, so a full-width admission leaf (42.5 M draws)
needs a few hundred MB of temporaries, not tens of GB. Energy is the
float64 sum over planes of (integer flip count x plane energy), rounded
once to float32, as the lane twins do; the JAX oracle sums (elements x
bits) float32 terms, so the two agree to float32 reduction order.

``inject_soft_errors`` is the paper's radiation-induced upset model
(flip each stored bit with probability ``ber``); the hardened driver
(``protect_exponent``) makes the sign/exponent planes immune and draws
only the others — the same words the JAX version draws for them.

``approx_write_with_stats`` keeps the seed-era (level, table) signature
over ``oracle_write``; ``ApproxStore`` is the name->tensor shim over
``repro_torch.memory.write``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import write_driver
from repro_torch.core.priority import (Priority, bitplane_priorities, bits_of,
                                       int_type)

#: counters drawn per chunk: 2^24 int64 words are 128 MB a temporary
CHUNK_DRAWS = 1 << 24


class WriteStats(NamedTuple):
    """Legacy stats layout (seed API) returned by
    ``approx_write_with_stats``; superseded by
    ``repro_torch.memory.WriteStats``."""
    energy_pj: torch.Tensor
    latency_ns: torch.Tensor
    bits_written: torch.Tensor
    bits_total: torch.Tensor
    bit_errors: torch.Tensor
    flips_0to1: torch.Tensor
    flips_1to0: torch.Tensor


def _words(x: torch.Tensor) -> torch.Tensor:
    """Flat int64 view of ``x``'s element bits (sign-extended; bit ``b``
    of an element is ``(w >> b) & 1`` for every ``b`` below its width)."""
    return x.reshape(-1).view(int_type(x.dtype)).to(torch.int64)


def _from_words(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """int64 words (low ``nbits`` meaningful) -> a tensor like ``like``."""
    nbits = bits_of(like.dtype)
    if nbits < 64:
        w = w & ((1 << nbits) - 1)
        w = w - ((w >> (nbits - 1)) << nbits)
    return w.to(int_type(like.dtype)).view(like.dtype).reshape(like.shape)


def _chunks(n_el: int, per_el: int):
    rng.check_count(n_el * per_el)
    step = max(1, CHUNK_DRAWS // max(per_el, 1))
    for e0 in range(0, n_el, step):
        yield e0, min(n_el, e0 + step)


def plane_energy(f01: torch.Tensor, f10: torch.Tensor, e01: torch.Tensor,
                 e10: torch.Tensor) -> torch.Tensor:
    """Energy of per-plane integer flip counts at per-plane prices: the
    float64 sum rounded once to float32."""
    return (f01.double() * e01.double()
            + f10.double() * e10.double()).sum().to(torch.float32)


def oracle_write(key: np.ndarray, old: torch.Tensor, new: torch.Tensor,
                 wer01: torch.Tensor, wer10: torch.Tensor,
                 e01: torch.Tensor, e10: torch.Tensor, lat: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Eager bit-unpacked EXTENT write with per-bit-plane operands
    (``(nbits,)`` float32 tensors on the data's device; ``key`` a host
    threefry key).

    Returns (stored, stats dict of 0-d tensors: energy_pj f32,
    latency_ns f32, flips01/flips10/errors i64, bits_total f32).
    Reads nothing back from the device."""
    assert old.shape == new.shape and old.dtype == new.dtype, (
        old.shape, new.shape, old.dtype, new.dtype)
    nbits = bits_of(old.dtype)
    dev = old.device
    o, n = _words(old), _words(new)
    shift = torch.arange(nbits, dtype=torch.int64, device=dev)
    fail_mask = torch.zeros_like(o)
    f01 = torch.zeros((nbits,), dtype=torch.int64, device=dev)
    f10 = torch.zeros_like(f01)
    errors = torch.zeros((), dtype=torch.int64, device=dev)
    for e0, e1 in _chunks(o.numel(), nbits):
        oc, nc = o[e0:e1, None], n[e0:e1, None]
        flip = (((oc ^ nc) >> shift) & 1).bool()
        to_ap = flip & ((nc >> shift) & 1).bool()
        ctr = torch.arange(e0 * nbits, e1 * nbits, dtype=torch.int64,
                           device=dev).view(e1 - e0, nbits)
        u = rng.unit_float_t(rng.counter_bits_t(key, ctr))
        fail = flip & (u < torch.where(to_ap, wer01, wer10))
        fail_mask[e0:e1] = (fail.to(torch.int64) << shift).sum(-1)
        f01 += to_ap.sum(0)
        f10 += (flip & ~to_ap).sum(0)
        errors += fail.sum()
    stored = _from_words(n ^ fail_mask, old)
    energy = plane_energy(f01, f10, e01, e10)
    latency = torch.where(f01 + f10 > 0, lat, torch.zeros_like(lat)).max()
    return stored, {
        "energy_pj": energy, "latency_ns": latency,
        "flips01": f01.sum(), "flips10": f10.sum(), "errors": errors,
        "bits_total": torch.full((), float(old.numel() * nbits),
                                 dtype=torch.float32, device=dev)}


def approx_write_with_stats(key: np.ndarray, old: torch.Tensor,
                            new: torch.Tensor, level,
                            table: Optional[Dict[str, np.ndarray]] = None,
                            *, per_bit_levels: bool = True
                            ) -> Tuple[torch.Tensor, WriteStats]:
    """Write ``new`` over ``old`` through the driver at ``level`` (the
    seed-era signature): resolves (level, table) to per-bit vectors —
    refined per bit plane by the priority policy with ``per_bit_levels``
    — and delegates to ``oracle_write``."""
    if table is None:
        table = write_driver.level_table()
    nbits = bits_of(old.dtype)
    if per_bit_levels:
        codes = bitplane_priorities(old.dtype, Priority.coerce(level))
    else:
        codes = np.full((nbits,), int(level), np.int32)
    vec = [torch.from_numpy(np.asarray(table[k], np.float32)[codes]).to(
        old.device) for k in ("wer01", "wer10", "e01", "e10", "lat")]
    stored, d = oracle_write(key, old, new, *vec)
    return stored, WriteStats(
        energy_pj=d["energy_pj"], latency_ns=d["latency_ns"],
        bits_written=d["flips01"] + d["flips10"],
        bits_total=d["bits_total"], bit_errors=d["errors"],
        flips_0to1=d["flips01"], flips_1to0=d["flips10"])


def approx_write(key, old, new, level, table=None, **kw) -> torch.Tensor:
    return approx_write_with_stats(key, old, new, level, table, **kw)[0]


# ---------------------------------------------------------------------------
# soft errors + hardened mode (paper §III: parallel-transistor hardening)
# ---------------------------------------------------------------------------

def _strike_planes(dtype: torch.dtype, protect_exponent: bool,
                   device: torch.device) -> torch.Tensor:
    """The bit planes that can strike: all, or with ``protect_exponent``
    those the LOW bit-plane policy does not pin EXACT — always the low
    planes, so this is an ``arange`` made on the device (no copy from the
    host, so it may run inside a sync-free burst)."""
    codes = bitplane_priorities(dtype, Priority.LOW)
    n = codes.size
    if protect_exponent:
        n = int(np.argmax(codes == int(Priority.EXACT)))
        assert (codes[n:] == int(Priority.EXACT)).all(), codes
    return torch.arange(n, dtype=torch.int64, device=device)


def soft_error_strikes(key: np.ndarray, x: torch.Tensor, ber: float,
                       protect_exponent: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``inject_soft_errors`` and its strike count (0-d int64): the
    popcount of ``x ^ result``. Each strikable (element, plane) pair
    draws the word at counter ``element * nbits + plane``, as
    ``jax.random.bernoulli(key, ber, x.shape + (nbits,))`` does."""
    nbits = bits_of(x.dtype)
    planes = _strike_planes(x.dtype, bool(protect_exponent), x.device)
    w = _words(x)
    mask = torch.zeros_like(w)
    strikes = torch.zeros((), dtype=torch.int64, device=x.device)
    p32 = float(np.float32(ber))
    for e0, e1 in _chunks(w.numel(), planes.numel()):
        ctr = (torch.arange(e0, e1, dtype=torch.int64, device=x.device)
               [:, None] * nbits + planes)
        hit = rng.unit_float_t(rng.counter_bits_t(key, ctr)) < p32
        mask[e0:e1] = (hit.to(torch.int64) << planes).sum(-1)
        strikes += hit.sum()
    return _from_words(w ^ mask, x), strikes


def inject_soft_errors(key: np.ndarray, x: torch.Tensor, ber: float,
                       protect_exponent: bool = False) -> torch.Tensor:
    """Radiation-induced retention upsets: flip each stored bit w.p.
    ``ber``. With ``protect_exponent`` (the hardened-driver analogue)
    sign/exponent bits are immune — only mantissa payload bits strike."""
    return soft_error_strikes(key, x, ber, protect_exponent)[0]


# ---------------------------------------------------------------------------
# stateful convenience wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ApproxStore:
    """name->tensor shim over ``repro_torch.memory.write`` (the seed-era
    ``store, value = store.write(key, name, new, level)`` API). Stats
    accumulate on the device; the report properties read them."""
    data: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    backend: str = "oracle"
    stats: Any = None  # repro_torch.memory.WriteStats

    def write(self, key: np.ndarray, name: str, new: torch.Tensor,
              level: Priority = Priority.EXACT
              ) -> Tuple["ApproxStore", torch.Tensor]:
        from repro_torch import memory
        old = self.data.get(name, torch.zeros_like(new))
        stored, st = memory.write(key, old, new, level=level,
                                  backend=self.backend)
        data = dict(self.data)
        data[name] = stored
        stats = st if self.stats is None else self.stats + st
        return dataclasses.replace(self, data=data, stats=stats), stored

    def read(self, name: str) -> torch.Tensor:
        return self.data[name]

    @property
    def energy_pj(self) -> float:
        return 0.0 if self.stats is None else float(self.stats.energy_pj)

    @property
    def latency_ns(self) -> float:
        return 0.0 if self.stats is None else float(self.stats.latency_ns)

    @property
    def bits_written(self) -> int:
        return 0 if self.stats is None else int(self.stats.bits_written)

    @property
    def bit_errors(self) -> int:
        return 0 if self.stats is None else int(self.stats.errors)
