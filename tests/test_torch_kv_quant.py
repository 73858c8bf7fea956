"""The port's kv_quant entry point against the JAX reference's.

On CPU tensors ``repro_torch.kernels.kv_quant.kv_quant_store`` runs the
kernel's twin (the CUDA kernel itself is held against it on the card by
``chip_smoke.py``); the reference runs its Pallas kernel in interpret
mode. The same threefry key goes to both. Held exactly: the int8
payload, the per-block scales bit for bit, the summed bit errors and the
thresholds; the dequantised mean relative error to 1e-6. Inputs are
drawn with numpy from fixed seeds; the adversarial ones come from
``chip_smoke.kv_quant_cases``, which ``chip_smoke.py`` also feeds to the
kernel on the card. A numpy emulation of the CUDA kernel's
integer and rounding arithmetic (folded draws, the compare without the
last xorshift, the carry-collected fail words, rounding by adding
1.5 * 2^23) is held equal to the twin."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.priority import Priority as JPriority
from repro.kernels.kv_quant import kv_dequant as jdequant
from repro.kernels.kv_quant import kv_quant_store as jstore
from repro.kernels.kv_quant.ops import _thresholds as jthresholds
from repro_torch import rng
from repro_torch.core.priority import Priority
from repro_torch.kernels.extent_write.ref import K_BIT, K_ELEM, M1, M2, M32
from repro_torch.kernels.kv_quant import (kernel, kv_dequant, kv_quant_ref,
                                          kv_quant_store, ops)
from repro_torch.kernels.kv_quant.ref import BLOCK, QMAX_INV

LEVELS = [Priority.LOW, Priority.MID, Priority.HIGH, Priority.EXACT]
#: (name, shape, dtype): the benchmark's (64, 128) bf16 tensor, a ragged
#: f32 tensor (21,000 elements, not a multiple of 8192), and a reduced
#: hybrid att leaf (1 layer, 2 slots, ring 16, 1 KV head of 16)
CASES = [("bench", (64, 128), "bfloat16"), ("ragged", (3, 1000, 7),
                                              "float32"),
         ("hybrid_att", (1, 2, 16, 1, 16), "float32")]
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ADVERSARIAL = _chip_smoke().kv_quant_cases()


def _pair(shape, dtype, seed):
    """The same values as a jnp array and a torch tensor (bf16 bits
    crossed as 16-bit patterns)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 2.0
    j = jnp.asarray(x).astype(dtype)
    if dtype == "bfloat16":
        t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(x.copy())
    return j, t


def _rel_err(deq, x):
    x = np.asarray(x, np.float32)
    return float(np.mean(np.abs(np.asarray(deq, np.float32) - x))
                 / np.mean(np.abs(x)))


@pytest.mark.parametrize("level", LEVELS, ids=lambda p: p.name)
def test_thresholds_equal_reference(level):
    np.testing.assert_array_equal(
        ops.thresholds(level), np.asarray(jthresholds(JPriority(int(level)))))


@pytest.mark.parametrize("level", LEVELS, ids=lambda p: p.name)
@pytest.mark.parametrize("name,shape,dtype", CASES,
                         ids=[c[0] for c in CASES])
def test_store_matches_reference(name, shape, dtype, level):
    seed = 100 + 10 * CASES.index((name, shape, dtype)) + int(level)
    j, t = _pair(shape, dtype, seed)
    jq, js, jst = jstore(jax.random.PRNGKey(seed), j,
                         level=JPriority(int(level)))
    tq, ts, tst = kv_quant_store(rng.PRNGKey(seed), t, level=level)
    assert tq.dtype == torch.int8 and tuple(tq.shape) == shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert int(tst["errors"]) == int(jst["errors"])
    assert tst["bytes_stored"] == int(jst["bytes_stored"])
    assert tst["bytes_saved"] == int(jst["bytes_saved"])
    if level == Priority.EXACT:
        assert int(tst["errors"]) == 0
    rel_t = _rel_err(kv_dequant(tq, ts, torch.float32).numpy(), j)
    rel_j = _rel_err(jdequant(jq, js, out_dtype=jnp.float32), j)
    assert abs(rel_t - rel_j) <= 1e-6
    deq_t = kv_dequant(tq, ts)
    assert deq_t.dtype == torch.bfloat16 and tuple(deq_t.shape) == shape


def test_mid_errors_and_quantisation_floor():
    """MID fails some payload bits and stays near the pure-quantisation
    error; EXACT is pure quantisation (|err| <= scale / 2)."""
    _, t = _pair((256, 256), "bfloat16", 3)
    qe, se, ste = kv_quant_store(rng.PRNGKey(2), t, level=Priority.EXACT)
    qm, sm, stm = kv_quant_store(rng.PRNGKey(2), t, level=Priority.MID)
    x = t.float()
    err = (kv_dequant(qe, se, torch.float32) - x).abs()
    assert int(ste["errors"]) == 0 and int(stm["errors"]) > 0
    assert float(err.max()) <= float(se.max()) * 0.5 + 1e-5
    rel_e = _rel_err(kv_dequant(qe, se, torch.float32), x)
    rel_m = _rel_err(kv_dequant(qm, sm, torch.float32), x)
    assert rel_e < rel_m < 2.0 * rel_e


def test_twin_pads_like_the_reference():
    """Padding quantises to 0 and never fails; the CPU wrapper neither
    counts a launch nor reads past the tensor."""
    flat = torch.from_numpy(np.random.default_rng(4).standard_normal(
        100).astype(np.float32))
    thr = torch.from_numpy(ops.thresholds(Priority.LOW).view(np.int32))
    before = kernel.kv_quant_cuda.launches
    q, s, e = kernel.kv_quant_cuda(flat, 7, thr)
    assert kernel.kv_quant_cuda.launches == before
    q2, s2, e2 = kv_quant_ref(kernel.pad_rows(flat), 7, thr)
    assert q2.shape == (64, 128) and s2.shape == (1, 1) and e2.shape == (1, 1)
    assert not q2.reshape(-1)[100:].any()
    torch.testing.assert_close(q, q2.reshape(-1)[:100], rtol=0, atol=0)
    assert int(e) == int(e2)


def test_wrapper_never_takes_the_twin_off_cpu():
    x = torch.empty((8,), device="meta")
    thr = torch.empty((8,), dtype=torch.int32, device="meta")
    before = kernel.kv_quant_cuda.launches
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.kv_quant_cuda(x, 1, thr)
    assert kernel.kv_quant_cuda.launches == before


@pytest.mark.parametrize("level", LEVELS, ids=lambda p: p.name)
@pytest.mark.parametrize("name,x,dtype", ADVERSARIAL,
                         ids=[c[0] for c in ADVERSARIAL])
def test_adversarial_store_matches_reference(name, x, dtype, level):
    """Half-integer quotients, an all-zero block, -1 payloads, absmax
    below 1e-12, signed zeros, +-absmax and lengths around one block:
    payload, scales and error count exact against the reference."""
    seed = 300 + 10 * [c[0] for c in ADVERSARIAL].index(name) + int(level)
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js, jst = jstore(jax.random.PRNGKey(seed), j,
                         level=JPriority(int(level)))
    tq, ts, tst = kv_quant_store(rng.PRNGKey(seed), t, level=level)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert int(tst["errors"]) == int(jst["errors"])
    if name == "zero_block":
        assert not tq.any() and int(tst["errors"]) == 0
    if name == "minus_one_block":
        # payloads 127 then -1 (0xFF): every failed bit is a cleared one
        sent = np.full(x.size, 0xFF, np.uint8)
        sent[0] = 127
        flipped = np.unpackbits(sent ^ tq.numpy().view(np.uint8))
        assert int(flipped.sum()) == int(tst["errors"])


def _fold(v):
    return v ^ (v >> np.uint64(16))


def _mul(x, c):
    return (x * np.uint64(c)) & np.uint64(M32)


def _kernel_emulation(x: np.ndarray, seed: int, thr: np.ndarray):
    """The CUDA kernel's arithmetic in numpy: per 8192-element block the
    scale, q by the 1.5 * 2^23 add, folded draws compared on draw_key,
    and fail words collected as 2 acc + (u >= thr) over elements 3..0
    and planes 7..0 of every 4-element word."""
    n = x.size
    bn = BLOCK[0] * BLOCK[1]
    xp = np.zeros(-(-n // bn) * bn, np.float32)
    xp[:n] = x
    xb = xp.reshape(-1, bn)
    scale = (np.maximum(np.abs(xb).max(1), np.float32(1e-12))
             * np.float32(QMAX_INV)).astype(np.float32)
    y = np.clip(xb / scale[:, None], np.float32(-127), np.float32(127))
    qf = (y + np.float32(12582912.0)).astype(np.float32).view(np.uint32)
    q = (qf.reshape(-1) & 0xFF).astype(np.uint64)
    m = _mul(np.arange(xp.size, dtype=np.uint64), K_ELEM)
    fm = _fold(m)
    u64 = np.uint64
    ge = np.empty((xp.size, 8), bool)
    for b in range(8):
        key = _fold(u64(seed)) ^ _fold(u64((b * K_BIT) & M32))
        mid = _mul(_mul(fm ^ key, M1) ^ (_mul(fm ^ key, M1) >> u64(13)), M2)
        t = u64(thr[b])
        ge[:, b] = (mid ^ (t >> u64(16))) >= t
    acc = np.zeros(xp.size // 4, np.uint64)
    ge4 = ge.reshape(-1, 4, 8)
    for i in range(3, -1, -1):
        for b in range(7, -1, -1):
            acc = (acc * u64(2) + ge4[:, i, b]) & u64(M32)
    qw = (q.reshape(-1, 4) << (u64(8) * np.arange(4, dtype=np.uint64))
          ).sum(1)
    fail = qw & ~acc & u64(M32)
    fail_b = (fail[:, None] >> (u64(8) * np.arange(4, dtype=np.uint64))
              ) & u64(0xFF)
    stored = (q ^ fail_b.reshape(-1)).astype(np.uint8).view(np.int8)
    bits = np.unpackbits(fail_b.astype(np.uint8).reshape(-1, 1), axis=1)
    errors = bits.reshape(-1, bn * 8).sum(1)
    return stored[:n], scale, errors


@pytest.mark.parametrize("level", [Priority.LOW, Priority.MID],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("name,x,dtype", ADVERSARIAL,
                         ids=[c[0] for c in ADVERSARIAL])
def test_kernel_arithmetic_equals_twin(name, x, dtype, level):
    """The kernel's rewritten arithmetic gives the twin's payload, scales
    and error counts bit for bit."""
    thr = ops.thresholds(level)
    flat = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s, e = kv_quant_ref(kernel.pad_rows(flat), 99,
                           torch.from_numpy(thr.view(np.int32)))
    eq, es, ee = _kernel_emulation(flat.float().numpy(), 99, thr)
    np.testing.assert_array_equal(eq, q.reshape(-1)[:x.size].numpy())
    np.testing.assert_array_equal(es.view(np.int32),
                                  s.reshape(-1).numpy().view(np.int32))
    np.testing.assert_array_equal(ee, e.reshape(-1).numpy())


def test_rounding_by_adding_1p5_2p23():
    """(y + 1.5 * 2^23)'s low byte is rint(y)'s two's-complement byte,
    half to even, for every |y| <= 127.5: half-integers, their float32
    neighbours, signed zeros and random values."""
    half = np.arange(-255, 256, dtype=np.float32) * np.float32(0.5)
    y = np.concatenate([
        half, np.nextafter(half, np.float32(np.inf)),
        np.nextafter(half, np.float32(-np.inf)),
        np.array([0.0, -0.0, 127.0, -127.0], np.float32),
        np.random.default_rng(5).uniform(-127.5, 127.5, 100_000)
        .astype(np.float32)])
    low = (y + np.float32(12582912.0)).astype(np.float32).view(
        np.uint32) & 0xFF
    np.testing.assert_array_equal(low, np.rint(y).astype(np.int64) & 0xFF)


def test_draw_count_reads_integer_opcodes_from_sass():
    """The bound's instructions per draw are counted from a cuobjdump
    listing: integer opcodes with their modifiers, predicated or not;
    moves, loads, stores and control flow are not counted. Each is
    billed to its pipe: IMAD and its forms to the FMA pipe, the rest to
    the integer ALU."""
    from repro_torch.kernels import build as B
    sass = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   LOP3.LUT R0, R0, c[0x0][0x210], RZ, 0x3c, !PT ;
        /*0030*/                   IMAD R0, R0, -0x7a143595, RZ ;
        /*0040*/                   SHF.R.U32.HI R3, RZ, 0xd, R0 ;
        /*0050*/                   LOP3.LUT R3, R3, R0, RZ, 0x3c, !PT ;
        /*0060*/                   IMAD R3, R3, -0x3d4d51cb, RZ ;
        /*0070*/                   LOP3.LUT R3, R3, c[0x0][0x214], RZ, 0x3c, !PT ;
        /*0080*/                   ISETP.GE.U32.AND P0, PT, R3, c[0x0][0x218], PT ;
        /*0090*/               @P0 EXIT ;
        /*00a0*/                   IMAD.MOV.U32 R5, RZ, RZ, 0x1 ;
        /*00b0*/                   LDC.64 R2, c[0x0][0x220] ;
        /*00c0*/                   STG.E desc[UR4][R2.64], R5 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
    """
    assert B.int_ops(sass) == ["LOP3.LUT", "IMAD", "SHF.R.U32.HI",
                               "LOP3.LUT", "IMAD", "LOP3.LUT",
                               "ISETP.GE.U32.AND"]
    assert B.int_ops("        /*0100*/ @!P1 IADD3 R0, R1, 0x1, RZ ;") == [
        "IADD3"]
    assert [B.pipe(op) for op in B.int_ops(sass)] == [
        "alu", "fma", "alu", "alu", "fma", "alu", "alu"]
    assert [B.pipe(op) for op in ("IMAD.X", "IMAD.HI.U32", "IMAD.WIDE.U32",
                                  "IADD3.X", "LEA.HI", "VIADD")] == [
        "fma", "fma", "fma", "alu", "alu", "alu"]


@pytest.mark.parametrize("alu,fma,clocks,pipe", [
    (5, 3, 5 / 64, "alu"), (2, 6, 6 / 64, "fma"), (4, 4, 4 / 64, "alu")])
def test_draw_clocks_take_the_busier_pipe(alu, fma, clocks, pipe):
    """chip_smoke's integer term: a draw takes the larger of its ALU and
    its FMA-pipe instructions over 64 lanes a clock per SM, not all of its
    instructions over the ALU's lanes."""
    assert _chip_smoke().draw_clocks(alu, fma) == (clocks, pipe)


def test_folded_draw_identities():
    """counter_hash.cuh's folded draw: fmix32's first xorshift folded out
    of (index * kElem) ^ seed ^ (plane * kBit) gives the twin's hash, and
    the compare without the last xorshift, (m ^ (thr >> 16)) < thr, is
    the compare of m ^ (m >> 16), also for every m whose upper half is
    thr's or next to it (the only m where the two words differ)."""
    from repro_torch.kernels.extent_write.ref import hash_u32
    u64 = np.uint64
    r = np.random.default_rng(21)
    idx = r.integers(0, 2 ** 32, 20_000, dtype=np.uint64)
    for seed in (0, 1, 0x5EED, 0xFFFFFFFF, int(r.integers(0, 2 ** 32))):
        for b in range(8):
            full = hash_u32(torch.from_numpy(
                (_mul(idx, K_ELEM) ^ u64(seed) ^ u64((b * K_BIT) & M32))
                .astype(np.int64))).numpy().astype(np.uint64)
            folded = (_fold(_mul(idx, K_ELEM)) ^ _fold(u64(seed))
                      ^ _fold(u64((b * K_BIT) & M32)))
            x = _mul(folded, M1)
            mid = _mul(x ^ (x >> u64(13)), M2)
            np.testing.assert_array_equal(mid ^ (mid >> u64(16)), full)
    thrs = sorted({int(t) for lv in Priority for t in ops.thresholds(lv)}
                  | {0, 1, 0xFFFF, 0x10000, 0x10001, 0x1FFFF, M32,
                     0x80000000})
    low = r.integers(0, 2 ** 16, 4096, dtype=np.uint64)
    for t in thrs:
        m = np.concatenate([
            u64(((t >> 16) + d) % 2 ** 16 << 16) | low for d in (-1, 0, 1)]
            + [r.integers(0, 2 ** 32, 4096, dtype=np.uint64)])
        t = u64(t)
        np.testing.assert_array_equal((m ^ (t >> u64(16))) < t,
                                      (m ^ (m >> u64(16))) < t)
