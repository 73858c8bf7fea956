"""The port's driver calibration, priority policy and lane vectors against
the JAX reference: every threshold and energy bit-equal.

The reference's serving path calibrates the level table inside
``jax.ensure_compile_time_eval`` (``repro.memory.plan.leaf_vectors``),
which evaluates ``jnp.linspace`` by true division; a bare
``level_table()`` call outside it multiplies by ``1/63`` and differs in
the last bit of some energies. The port reproduces the serving path's
table, so the reference side is computed the same way here, uncached
(the reference's ``lru_cache`` would hand back whichever variant some
other test computed first)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import priority as jprio
from repro.core import write_driver as jwd
from repro.kernels.extent_write import ops as jops
from repro_torch.core import priority as tprio
from repro_torch.core import write_driver as twd
from repro_torch.kernels.extent_write import ops as tops

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
          (torch.float16, jnp.float16), (torch.int8, jnp.int8),
          (torch.int32, jnp.int32)]


def _ref_table():
    with jax.ensure_compile_time_eval():
        t = jwd.level_table.__wrapped__(jwd.DriverConfig())
    return {k: np.asarray(v) for k, v in t.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def test_level_table_bit_equal():
    ref = _ref_table()
    port = twd.level_table()
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].dtype == np.float32
        np.testing.assert_array_equal(_bits(port[k]), _bits(ref[k]), k)


@pytest.mark.parametrize("level", list(range(4)))
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: str(d[0]))
def test_bitplane_priorities_equal(dtypes, level):
    dt_t, dt_j = dtypes
    np.testing.assert_array_equal(
        tprio.bitplane_priorities(dt_t, tprio.Priority(level)),
        jprio.bitplane_priorities(dt_j, jprio.Priority(level)))


@pytest.mark.parametrize("level", list(range(4)))
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: str(d[0]))
def test_level_vectors_bit_equal(dtypes, level, monkeypatch):
    dt_t, dt_j = dtypes
    ref_table = _ref_table()
    monkeypatch.setattr(jwd, "level_table", lambda cfg=None: ref_table)
    ref = jops.level_vectors.__wrapped__(dt_j, jprio.Priority(level))
    port = tops.level_vectors(dt_t, tprio.Priority(level))
    for name, a, b in zip(("thr01", "thr10", "e01", "e10"), port, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape == (32,), name
        np.testing.assert_array_equal(_bits(a), _bits(b), name)


@pytest.mark.parametrize("path,want", [
    (("slot0", "k"), "MID"), (("slot0", "v"), "LOW"),
    (("state",), "EXACT"), (("conv",), "EXACT"), (("other",), "HIGH")])
def test_kv_cache_policy_matches(path, want):
    jpath = tuple(jax.tree_util.DictKey(k) for k in path)
    assert tprio.kv_cache_policy(path, None).name == want
    assert jprio.kv_cache_policy(jpath, None).name == want


def test_extent_table_resolution_matches():
    from repro.core.extent_table import QualityController as JQC
    from repro_torch.core.extent_table import QualityController as TQC
    seq = [("chat", "high"), ("batch", None), ("chat", None),
           ("batch", "low"), ("x", "exact"), ("batch", None)]
    qt, qj = TQC(), JQC()
    got = [qt.resolve_request(b, tprio.Priority.coerce(h) if h else None)
           .name for b, h in seq]
    want = [qj.resolve_request(b, jprio.Priority.coerce(h) if h else None)
            .name for b, h in seq]
    assert got == want
    assert qt.table.stats()["hits"] == qj.table.stats()["hits"]


@pytest.mark.parametrize("t_k", [250.0, 300.0, 350.0, 400.0])
def test_delta_of_t_bit_equal(t_k):
    from repro.core import mtj as jmtj
    from repro_torch.core import mtj as tmtj
    a = tmtj.delta_of_t(tmtj.DEFAULT_MTJ, t_k)
    b = np.asarray(jmtj.delta_of_t(jmtj.DEFAULT_MTJ, t_k))
    assert a.dtype == np.float32
    np.testing.assert_array_equal(_bits(a), _bits(b))
