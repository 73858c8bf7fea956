"""The extent_write twin, the backends and the write plan of the port
against the JAX reference's lane path (``use_kernel=False``, the jnp twin
of the Pallas kernel), under the same threefry keys.

Stored words and every count are exact. Energy is held at rtol=1e-5: the
port sums (integer flip count x plane energy) over planes in float64 and
rounds once, the reference sums per-bit float32 energies, and the two
orders differ by float32 rounding (~1e-7 relative here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.priority import Priority as JP
from repro.kernels.extent_write import ops as jops
from repro.memory import WritePlan as JPlan
from repro_torch import rng
from repro_torch.core.priority import Priority as TP
from repro_torch.kernels.extent_write import kernel as tkernel
from repro_torch.kernels.extent_write import ops as tops
from repro_torch.kernels.extent_write import ref as tref
from repro_torch.memory import WritePlan as TPlan
from repro_torch.memory import get_backend, leaf_vectors

RTOL = 1e-5
CPU = torch.device("cpu")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}
SHAPES = [(1,), (7, 19), (3, 5, 11), (2, 3, 4, 5), (129,), (300,)]


def _pair(shape, dt, seed):
    """numpy (old, new) of one dtype; a quarter of elements unchanged."""
    r = np.random.default_rng(seed)
    if dt == "int8":
        old = r.integers(-128, 128, shape).astype(np.int8)
        new = r.integers(-128, 128, shape).astype(np.int8)
    else:
        old = r.standard_normal(shape).astype(np.float32)
        new = r.standard_normal(shape).astype(np.float32)
    keep = r.random(shape) < 0.25
    return old, np.where(keep, old, new)


def _both(a, dt):
    """numpy array -> (torch tensor, jax array) of the dtype ``dt``."""
    tdt, jdt = DTYPES[dt]
    return torch.from_numpy(a.copy()).to(tdt), jnp.asarray(a).astype(jdt)


def _bits_np(x):
    """torch tensor or jax array -> numpy integer view of its bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8 if x.element_size() == 1 else
                              np.uint16 if x.element_size() == 2
                              else np.uint32)
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _vectors(dt, level):
    jv = jops.level_vectors(DTYPES[dt][1], JP(level))
    tv = leaf_vectors(DTYPES[dt][0], TP(level), CPU)
    return jv, (tv.thr01, tv.thr10, tv.le01, tv.le10)


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_twin_matches_reference(dt, shape, level):
    seed = 31 * SHAPES.index(shape) + 7 * level + len(dt)
    old, new = _pair(shape, dt, seed)
    (ot, oj), (nt, nj) = _both(old, dt), _both(new, dt)
    jv, tv = _vectors(dt, level)
    key = jax.random.PRNGKey(seed)
    sj, stj = jops.extent_write(key, oj, nj, vectors=jv, use_kernel=False)
    st, stt = tops.extent_write(rng.seed_u32(rng.PRNGKey(seed)), ot, nt,
                                tv, tref.extent_write_ref)
    assert st.dtype == ot.dtype and st.shape == ot.shape
    np.testing.assert_array_equal(_bits_np(st), _bits_np(sj))
    for k in ("flips01", "flips10", "errors"):
        assert int(stt[k]) == int(stj[k]), k
    np.testing.assert_allclose(float(stt["energy_pj"]),
                               float(stj["energy_pj"]), rtol=RTOL)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_lane_packing_round_trip(dt):
    old, _ = _pair((3, 5, 7), dt, 5)
    t, j = _both(old, dt)
    lanes = tops.to_lanes(t)
    assert lanes.dtype == torch.int32
    assert lanes.numel() == -(-t.numel() * t.element_size() // 4)
    np.testing.assert_array_equal(
        lanes.numpy().view(np.uint32),
        np.asarray(jops._to_lanes(j)[0]))
    back = tops.from_lanes(lanes, t.shape, t.dtype)
    np.testing.assert_array_equal(_bits_np(back), _bits_np(t))


@pytest.mark.parametrize("name", ["lanes_ref", "cuda"])
def test_backends_on_cpu_run_the_twin(name):
    """On CPU tensors the ``cuda`` backend's wrapper runs the twin and
    counts no launch."""
    old, new = _pair((4, 9), "bf16", 3)
    (ot, _), (nt, _) = _both(old, "bf16"), _both(new, "bf16")
    lv = leaf_vectors(torch.bfloat16, TP.LOW, CPU)
    before = tkernel.extent_write_cuda.launches
    key = rng.PRNGKey(9)
    s1, st1 = get_backend(name).leaf_write(key, ot, nt, lv)
    s2, st2 = get_backend("lanes_ref").leaf_write(key, ot, nt, lv)
    assert tkernel.extent_write_cuda.launches == before
    assert torch.equal(s1.view(torch.int16), s2.view(torch.int16))
    h1, h2 = st1.host_dict(), st2.host_dict()
    assert h1 == h2
    assert h1["bits_total"] == 4 * 9 * 16


def _cache(seed, shape=(2, 3, 6, 2, 4)):
    r = np.random.default_rng(seed)
    return {"slot0": {"k": r.standard_normal(shape).astype(np.float32),
                      "v": r.standard_normal(shape).astype(np.float32)}}


AXES = {"slot0": {"k": ("layers", "batch", "kv_seq", "kv_heads",
                        "head_dim"),
                  "v": ("layers", "batch", "kv_seq", "kv_heads",
                        "head_dim")}}


def _plans(floor):
    from repro_torch import tree as T
    old = _cache(1)
    jplan = JPlan.for_tree(jax.tree.map(jnp.asarray, old),
                           backend="lanes_ref", axes=AXES)
    tplan = TPlan.for_tree(T.tree_map(torch.from_numpy, old), device=CPU,
                           backend="lanes_ref", axes=AXES)
    return jplan, tplan, jplan.vectors_for(JP(floor)), \
        tplan.vectors_for(TP(floor))


def _check_stats(st_t, st_j):
    h = st_t.host_dict()
    hj = st_j.host_dict()
    for k in ("flips01", "flips10", "bit_errors", "bits_total",
              "bits_written"):
        assert h[k] == hj[k], k
    np.testing.assert_allclose(h["energy_pj"], hj["energy_pj"], rtol=RTOL)
    assert h["latency_ns"] == pytest.approx(hj["latency_ns"], rel=1e-7)


@pytest.mark.parametrize("floor", [0, 2])
def test_plan_write_matches_reference(floor):
    """Whole-tree write: leaf ``i`` (sorted keys: k then v) folds ``i``."""
    from repro_torch import tree as T
    jplan, tplan, jvec, tvec = _plans(floor)
    old, new = _cache(1), _cache(2)
    key_j, key_t = jax.random.PRNGKey(4), rng.PRNGKey(4)
    sj, stj = jplan.write(key_j, jax.tree.map(jnp.asarray, old),
                          jax.tree.map(jnp.asarray, new), jvec)
    st, stt = tplan.write(key_t, T.tree_map(torch.from_numpy, old),
                          T.tree_map(torch.from_numpy, new), tvec)
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(_bits_np(st["slot0"][leaf]),
                                      _bits_np(sj["slot0"][leaf]))
    _check_stats(stt, stj)


def test_plan_write_columns_matches_reference():
    """Decode column write: the hash runs over the gathered column's flat
    lane index, per-slot positions wrap around the ring."""
    from repro_torch import tree as T
    jplan, tplan, jvec, tvec = _plans(0)
    old = _cache(1)
    new = {"slot0": {k: v.copy() for k, v in old["slot0"].items()}}
    pos = np.array([3, 8, 5], np.int32)   # 8 wraps to ring slot 2
    r = np.random.default_rng(6)
    for leaf in ("k", "v"):
        for b, p in enumerate(pos):
            new["slot0"][leaf][:, b, p % 6] = r.standard_normal(
                new["slot0"][leaf][:, b, p % 6].shape)
    sj, stj = jplan.write_columns(
        jax.random.PRNGKey(8), jax.tree.map(jnp.asarray, old),
        jax.tree.map(jnp.asarray, new), jnp.asarray(pos), jvec)
    st, stt = tplan.write_columns(
        rng.PRNGKey(8), T.tree_map(torch.from_numpy, old),
        T.tree_map(torch.from_numpy, new),
        torch.from_numpy(pos.astype(np.int64)), tvec)
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(_bits_np(st["slot0"][leaf]),
                                      _bits_np(sj["slot0"][leaf]))
    _check_stats(stt, stj)

