"""The port's kv_quant entry point against the JAX reference's.

On CPU tensors ``repro_torch.kernels.kv_quant.kv_quant_store`` runs the
kernel's twin (the CUDA kernel itself is held against it on the card by
``chip_smoke.py``); the reference runs its Pallas kernel in interpret
mode. The same threefry key goes to both. Held exactly: the int8
payload, the per-block scales bit for bit, the summed bit errors and the
thresholds; the dequantised mean relative error to 1e-6. Inputs are
drawn with numpy from fixed seeds."""
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
from repro_torch.kernels.kv_quant import (kernel, kv_dequant, kv_quant_ref,
                                          kv_quant_store, ops)

LEVELS = [Priority.LOW, Priority.MID, Priority.HIGH, Priority.EXACT]
#: (name, shape, dtype): the benchmark's (64, 128) bf16 tensor, a ragged
#: f32 tensor (21,000 elements, not a multiple of 8192), and a reduced
#: hybrid att leaf (1 layer, 2 slots, ring 16, 1 KV head of 16)
CASES = [("bench", (64, 128), "bfloat16"), ("ragged", (3, 1000, 7),
                                              "float32"),
         ("hybrid_att", (1, 2, 16, 1, 16), "float32")]


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
