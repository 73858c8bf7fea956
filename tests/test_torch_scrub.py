"""The scrub twin, its plumbing and the backends' ``leaf_scrub`` against
the JAX reference, under the same threefry keys.

The twin is held against the Pallas scrub kernel run in interpret mode
(``use_kernel=True, interpret=True``) on small lane counts, and against
the reference's jnp twin (``use_kernel=False``) on larger ones. Scrubbed
words, residual masks and every count are exact. Energy is held at
rtol=1e-5: the port sums (integer count x plane energy) over planes in
float64 and rounds once, the reference sums per-bit float32 energies
(largest error measured: 1.9e-6 relative, over dense int8 masks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.priority import Priority as JP
from repro.kernels.extent_write import ops as jops
from repro.kernels.scrub import scrub_write as jscrub_write
from repro.memory import get_backend as jget_backend
from repro.memory import leaf_vectors as jleaf_vectors
from repro_torch import rng
from repro_torch.core.priority import Priority as TP
from repro_torch.core.priority import int_type
from repro_torch.kernels.scrub import kernel as skernel
from repro_torch.kernels.scrub import ops as sops
from repro_torch.kernels.scrub import ref as sref
from repro_torch.memory import get_backend, leaf_vectors

RTOL = 1e-5
CPU = torch.device("cpu")
DTYPES = {"f32": (torch.float32, jnp.float32, np.uint32),
          "bf16": (torch.bfloat16, jnp.bfloat16, np.uint16),
          "int8": (torch.int8, jnp.int8, np.uint8)}
#: (dtype, shape, run the Pallas kernel in interpret mode): the
#: interpreter compiles per shape in seconds, so it takes one small
#: ragged shape of each dtype; the jnp twin takes the rest
CASES = [("f32", (7, 19), True), ("bf16", (3, 5, 11), True),
         ("int8", (13,), True)] + [
    (dt, shape, False) for dt in DTYPES
    for shape in ((1,), (2, 3, 4, 5), (64, 33))]


def _data(shape, dt, seed, density):
    """numpy (stored, mask): random words and a mask with about
    ``density`` of its bits set."""
    r = np.random.default_rng(seed)
    ut = DTYPES[dt][2]
    nbits = np.dtype(ut).itemsize * 8
    if dt == "int8":
        stored = r.integers(-128, 128, shape).astype(np.int8)
    else:
        stored = r.standard_normal(shape).astype(np.float32)
    bits = r.random(shape + (nbits,)) < density
    mask = (bits * (1 << np.arange(nbits, dtype=np.uint64))).sum(-1)
    return stored, mask.astype(ut)


def _torch(stored, mask, dt):
    tdt = DTYPES[dt][0]
    s = torch.from_numpy(stored.copy()).to(tdt)
    m = torch.from_numpy(mask.view(np.dtype(mask.dtype.str.replace(
        "u", "i"))).copy())
    assert m.dtype == int_type(tdt)
    return s, m


def _jax(stored, mask, dt):
    return jnp.asarray(stored).astype(DTYPES[dt][1]), jnp.asarray(mask)


def _bits_np(x):
    if isinstance(x, torch.Tensor):
        x = x.view(int_type(x.dtype)).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _vectors(dt, level):
    jv = jops.level_vectors(DTYPES[dt][1], JP(level))
    tv = leaf_vectors(DTYPES[dt][0], TP(level), CPU)
    return jv, (tv.thr01, tv.thr10, tv.le01, tv.le10)


def _check(out_t, out_j, rel_errs=None):
    (st, rt, stt), (sj, rj, stj) = out_t, out_j
    np.testing.assert_array_equal(_bits_np(st), _bits_np(sj))
    np.testing.assert_array_equal(_bits_np(rt), _bits_np(rj))
    for k in ("flips01", "flips10", "errors"):
        assert int(stt[k]) == int(stj[k]), k
    assert stt["bits_total"] == int(stj["bits_total"])
    e_t, e_j = float(stt["energy_pj"]), float(stj["energy_pj"])
    np.testing.assert_allclose(e_t, e_j, rtol=RTOL)
    if rel_errs is not None and e_j:
        rel_errs.append(abs(e_t - e_j) / e_j)


@pytest.mark.parametrize("level", [0, 1, 3])
@pytest.mark.parametrize("dt,shape,interp", CASES, ids=str)
def test_twin_matches_reference_kernel(dt, shape, interp, level):
    seed = 17 * CASES.index((dt, shape, interp)) + 5 * level
    stored, mask = _data(shape, dt, seed, density=0.3)
    jv, tv = _vectors(dt, level)
    out_j = jscrub_write(jax.random.PRNGKey(seed), *_jax(stored, mask, dt),
                         vectors=jv, use_kernel=interp,
                         interpret=True if interp else None)
    out_t = sops.scrub_write(rng.seed_u32(rng.PRNGKey(seed)),
                             *_torch(stored, mask, dt), tv, sref.scrub_ref)
    assert out_t[0].dtype == DTYPES[dt][0] and out_t[0].shape == shape
    _check(out_t, out_j)
    if level == 3:  # EXACT thresholds: every correction lands
        assert not _bits_np(out_t[1]).any()


def test_zero_mask_is_free_and_sparse_mask_is_exact():
    """An all-zero mask leaves the words as they were at no cost; a mask
    as sparse as the serving path's agrees with the reference too."""
    stored, _ = _data((6, 40), "bf16", 1, 0.0)
    jv, tv = _vectors("bf16", 0)
    zero = np.zeros((6, 40), np.uint16)
    st, rt, stt = sops.scrub_write(5, *_torch(stored, zero, "bf16"), tv,
                                   sref.scrub_ref)
    assert np.array_equal(_bits_np(st), _bits_np(_torch(stored, zero,
                                                        "bf16")[0]))
    assert not _bits_np(rt).any()
    assert [int(stt[k]) for k in ("flips01", "flips10", "errors")] == \
        [0, 0, 0] and float(stt["energy_pj"]) == 0.0
    stored, mask = _data((40, 96), "bf16", 2, 0.01)
    _check(sops.scrub_write(rng.seed_u32(rng.PRNGKey(3)),
                            *_torch(stored, mask, "bf16"), tv,
                            sref.scrub_ref),
           jscrub_write(jax.random.PRNGKey(3), *_jax(stored, mask, "bf16"),
                        vectors=jv, use_kernel=False))


def test_energy_error_is_far_below_tolerance():
    """The measured worst relative energy error over dense masks of every
    dtype stays below 5e-6 (the tolerance is 1e-5; measured: 1.9e-6)."""
    errs = []
    for i, dt in enumerate(DTYPES):
        stored, mask = _data((37, 29), dt, 40 + i, density=0.5)
        jv, tv = _vectors(dt, 0)
        _check(sops.scrub_write(rng.seed_u32(rng.PRNGKey(i)),
                                *_torch(stored, mask, dt), tv,
                                sref.scrub_ref),
               jscrub_write(jax.random.PRNGKey(i), *_jax(stored, mask, dt),
                            vectors=jv, use_kernel=False), errs)
    assert max(errs) < 5e-6, errs


@pytest.mark.parametrize("name", ["lanes_ref", "cuda", "exact"])
def test_backend_leaf_scrub_matches_reference(name):
    """``leaf_scrub`` of every port backend against the reference backend
    of the same contract (the ``cuda`` wrapper runs the twin on CPU
    tensors and counts no launch); WriteStats agree."""
    stored, mask = _data((3, 4, 10), "bf16", 8, 0.2)
    jname = "exact" if name == "exact" else "lanes_ref"
    jlv = jleaf_vectors(jnp.bfloat16, JP.MID)
    tlv = leaf_vectors(torch.bfloat16, TP.MID, CPU)
    before = skernel.scrub_cuda.launches
    st, rt, wt = get_backend(name).leaf_scrub(
        rng.PRNGKey(12), *_torch(stored, mask, "bf16"), tlv)
    sj, rj, wj = jget_backend(jname).leaf_scrub(
        jax.random.PRNGKey(12), *_jax(stored, mask, "bf16"), jlv)
    assert skernel.scrub_cuda.launches == before
    np.testing.assert_array_equal(_bits_np(st), _bits_np(sj))
    np.testing.assert_array_equal(_bits_np(rt), _bits_np(rj))
    h, hj = wt.host_dict(), wj.host_dict()
    for k in ("flips01", "flips10", "bit_errors", "bits_total"):
        assert h[k] == hj[k], k
    np.testing.assert_allclose(h["energy_pj"], hj["energy_pj"], rtol=RTOL)
    assert h["latency_ns"] == pytest.approx(hj["latency_ns"], rel=1e-7)
    if name == "exact":
        assert h["energy_pj"] == 0.0 and not _bits_np(rt).any()


def test_scrub_wrapper_never_takes_the_twin_off_cpu():
    """Only a CPU tensor selects the twin; any other device launches the
    kernel or raises (here: 'meta', which no kernel takes)."""
    x = torch.empty((8,), dtype=torch.int32, device="meta")
    v = torch.empty((32,), dtype=torch.int32, device="meta")
    e = torch.empty((32,), dtype=torch.float32, device="meta")
    before = skernel.scrub_cuda.launches
    with pytest.raises(ValueError, match="unsupported device"):
        skernel.scrub_cuda(x, x, 1, v, v, e, e)
    assert skernel.scrub_cuda.launches == before


def test_both_kernels_build_through_one_helper():
    """The build helper finds each kernel's source in ``csrc/`` and puts
    every library in one ignored build directory."""
    from repro_torch.kernels import build as B
    for name in ("extent_write", "scrub"):
        assert B.source(name).is_file()
    assert B.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
