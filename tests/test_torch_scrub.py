"""The scrub twin, its plumbing and the backends' ``leaf_scrub`` against
the JAX reference, under the same threefry keys.

The twin is held against the Pallas scrub kernel run in interpret mode
(``use_kernel=True, interpret=True``) on small lane counts, and against
the reference's jnp twin (``use_kernel=False``) on larger ones. Scrubbed
words, residual masks and every count are exact. Energy is held at
rtol=1e-5: the port sums (integer count x plane energy) over planes in
float64 and rounds once, the reference sums per-bit float32 energies
(largest error measured: 1.9e-6 relative, over dense int8 masks).

The CUDA kernel (``csrc/scrub.cu``) runs only on the card, where
``chip_smoke.py`` holds it against the twin. Here its walk is emulated
in numpy (the warp's OR of masks; runs of its set planes, highest first,
one pass for each kind of plane: both directions can fail, only 0->1,
only 1->0; folded draws collected as 2 acc + carry; bit-sliced plane
counts flushed through a 32 x 32 bit transpose; the per-block partials)
and held equal to the twin, and the partials go through
``ref.stats_from_partials`` to the twin's stats exactly."""
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
from repro_torch.kernels.extent_write.ref import K_BIT, K_ELEM, M1, M2, M32
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


@pytest.fixture
def one_thread():
    """One intra-op thread: the suite runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (dtype, shape, mask density): every bit of every lane set, the longest
#: walk, and float32 at a checkpoint restore's density (~13 of 32 bits)
DENSE = [("f32", (7, 19), 1.0), ("bf16", (3, 5, 11), 1.0),
         ("f32", (7, 19), 13 / 32)]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("dt,shape,density", DENSE, ids=str)
def test_twin_matches_reference_kernel_on_dense_masks(dt, shape, density):
    """All-ones and dense float32 masks: the twin against the Pallas
    kernel in interpret mode, words, residual and counts exact, energy
    at RTOL."""
    seed = 61 + DENSE.index((dt, shape, density))
    stored, mask = _data(shape, dt, seed, density)
    if density == 1.0:
        assert (mask == np.iinfo(mask.dtype).max).all()
    jv, tv = _vectors(dt, 0)
    out_j = jscrub_write(jax.random.PRNGKey(seed), *_jax(stored, mask, dt),
                         vectors=jv, use_kernel=True, interpret=True)
    out_t = sops.scrub_write(rng.seed_u32(rng.PRNGKey(seed)),
                             *_torch(stored, mask, dt), tv, sref.scrub_ref)
    _check(out_t, out_j)


def _lanes(dt, shape, seed, density):
    """(stored, mask) as int32 lane tensors."""
    s, m = _torch(*_data(shape, dt, seed, density), dt)
    return sops.to_lanes(s), sops.to_lanes(m)


def _plane_counts(s_u, m_u):
    """Per-plane 0->1 and 1->0 re-writes of (stored, mask) lanes, numpy
    int64 (32,) each."""
    m = m_u.numpy().view(np.uint32).astype(np.uint64)
    cor = (s_u.numpy().view(np.uint32).astype(np.uint64)) ^ m
    b = np.arange(32, dtype=np.uint64)
    a01 = ((m & cor)[:, None] >> b) & np.uint64(1)
    a10 = ((m & ~cor)[:, None] >> b) & np.uint64(1)
    return a01.sum(0).astype(np.int64), a10.sum(0).astype(np.int64)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("blocks", [1, 3, 1056])
@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
def test_stats_from_partials_split_over_blocks(dt, blocks):
    """Per-plane partials from the twin's own counts, split at random over
    ``blocks`` rows, give exactly the twin's stats: the energy bit for bit
    (``plane_energy`` of the summed counts, within one float32 rounding of
    the float64 sum), flips and errors."""
    seed = 5 * blocks + len(dt)
    s_u, m_u = _lanes(dt, (41, 23), seed, 0.4)
    _, tv = _vectors(dt, 0)
    _, _, st = sref.scrub_ref(s_u, m_u, seed, *tv)
    f01, f10 = _plane_counts(s_u, m_u)
    assert (int(st["flips01"]), int(st["flips10"])) == (f01.sum(),
                                                        f10.sum())
    total = np.concatenate([f01, f10, [int(st["errors"])]])
    r = np.random.default_rng(seed)
    cuts = np.sort(r.integers(0, total[None] + 1, (blocks - 1, 65)), 0)
    edges = np.concatenate([np.zeros((1, 65), np.int64), cuts,
                            total[None]])
    parts = torch.from_numpy(np.diff(edges, axis=0).astype(np.int32))
    assert parts.shape == (blocks, 65) and (parts >= 0).all()
    got = sref.stats_from_partials(parts, tv[2], tv[3])
    for k in ("flips01", "flips10", "errors"):
        assert got[k].dtype == torch.int64 and int(got[k]) == int(st[k])
    assert got["energy_pj"].dtype == torch.float32
    assert got["energy_pj"].item() == st["energy_pj"].item()
    counts = torch.from_numpy(np.concatenate([f01, f10]))
    prices = torch.cat([tv[2], tv[3]])
    assert sref.plane_energy(counts, prices).item() == \
        st["energy_pj"].item()
    want = (f01 * tv[2].double().numpy() + f10 * tv[3].double().numpy())
    np.testing.assert_allclose(got["energy_pj"].item(), want.sum(),
                               rtol=2 ** -24)


U64 = np.uint64


def _fold(v):
    return v ^ (v >> U64(16))


def _mul(x, c):
    return (x * U64(c)) & U64(M32)


def _popc(x):
    return ((x[..., None] >> np.arange(32, dtype=np.uint64)) & U64(1)).sum(-1)


def _transpose32(x):
    """scrub.cu's transpose32 over the 32 words of a warp (one a lane),
    shuffle by shuffle."""
    lane = np.arange(32)
    m = 0x0000FFFF
    for s in (16, 8, 4, 2, 1):
        if s != 16:
            m ^= (m << s) & M32
        y = x[lane ^ s]
        mu, nm = U64(m), U64(~m & M32)
        x = np.where(lane & s, (x & nm) | ((y >> U64(s)) & mu),
                     (x & mu) | ((y << U64(s)) & nm))
    return x


def _count(c, w):
    """scrub.cu's count: a thread's 4 or 8 words (per lane of the warp)
    into the bit-sliced counts c (slices x lanes)."""
    def full_add(j, a, b):
        carry = (c[j] & a) | (c[j] & b) | (a & b)
        c[j] ^= a ^ b
        return carry
    k1 = [full_add(0, w[:, 2 * i], w[:, 2 * i + 1])
          for i in range(w.shape[1] // 2)]
    k, j = full_add(1, k1[0], k1[1]), 2
    if w.shape[1] == 8:
        k, j = full_add(2, k, full_add(1, k1[2], k1[3])), 3
    for j in range(j, len(c)):
        c[j], k = c[j] ^ k, c[j] & k
    assert not k.any()


def _flush(c, count):
    for j in range(len(c)):
        if c[j].any():
            count += _popc(_transpose32(c[j])).astype(np.int64) << j
        c[j] = 0


def _kernel_emulation(s, m, seed, t01, t10, lead, grid, vecs):
    """The CUDA kernel's arithmetic in numpy, warp by warp of its
    grid-stride loop: lanes ``s``/``m`` (uint64 holding uint32), vectors
    on a grid ``lead`` lanes before lane 0, thread t of a warp's trip
    taking vectors v0 + 32 j + t, j < ``vecs`` (the kernel's kVecs). Every
    live trip takes the walk; the kernel's per-bit route for sparse trips
    draws each set bit as the twin does. Returns (scrubbed, residual,
    per-block partials (grid, 65))."""
    n = s.size
    n_vec = -(-(n + lead) // 4)
    out_s, out_r = np.zeros(n, U64), np.zeros(n, U64)
    parts = np.zeros((grid, 65), np.int64)
    can01 = sum(1 << b for b in range(32) if t01[b])
    can10 = sum(1 << b for b in range(32) if t10[b])
    key = [int(_fold(U64(seed)) ^ _fold(U64((b * K_BIT) & M32)))
           for b in range(32)]
    # (32, 4 vecs): thread t's lanes, vector j's lane k at 4 j + k
    off = (128 * np.arange(vecs)[:, None] + np.arange(4)).reshape(-1)
    lanes = 4 * np.arange(32)[:, None] + off
    for blk in range(grid):
        for warp in range(8):
            c01, c10 = np.zeros((8, 32), U64), np.zeros((8, 32), U64)
            n01, n10 = np.zeros(32, np.int64), np.zeros(32, np.int64)
            nerr, live = 0, 0
            v0 = (blk * 256 + warp * 32) * vecs
            while v0 < n_vec:
                e = 4 * v0 + lanes - lead
                ok = (e >= 0) & (e < n)
                idx = np.clip(e, 0, n - 1)
                ss = np.where(ok, s[idx], U64(0))
                mm = np.where(ok, m[idx], U64(0))
                planes = int(np.bitwise_or.reduce(mm.reshape(-1)))
                v0 += grid * 256 * vecs
                if planes == 0:
                    out_s[idx[ok]], out_r[idx[ok]] = ss[ok], 0
                    continue
                cor = ss ^ mm
                fl = _fold(_mul(e.astype(U64) & U64(M32), K_ELEM))
                fail = np.zeros_like(mm)
                for mode, kind in ((0, can01 & can10), (1, can01 & ~can10),
                                   (2, ~can01 & can10)):
                    todo = planes & kind
                    while todo:  # runs of adjacent planes, highest first
                        hi = todo.bit_length() - 1
                        lo = (~todo & ((1 << hi) - 1)).bit_length()
                        run = ((1 << (hi + 1)) - 1) & ~((1 << lo) - 1)
                        todo &= ~run
                        a01, a10 = np.zeros_like(mm), np.zeros_like(mm)
                        for b in range(hi, lo - 1, -1):
                            x = _mul(fl ^ U64(key[b]), M1)
                            x = _mul(x ^ (x >> U64(13)), M2)
                            t, h = U64(t01[b]), U64(t10[b])
                            if mode == 0:
                                u = x ^ (x >> U64(16))
                                g01, g10 = u >= t, u >= h
                            else:
                                g01 = (x ^ (t >> U64(16))) >= t
                                g10 = (x ^ (h >> U64(16))) >= h
                            a01 = (a01 * U64(2) + g01) & U64(M32)
                            a10 = (a10 * U64(2) + g10) & U64(M32)
                        f01 = cor & ~(a01 << U64(lo)) & U64(M32)
                        f10 = ~cor & ~(a10 << U64(lo)) & U64(M32)
                        f = (f01 | f10, f01, f10)[mode]
                        fail |= mm & U64(run) & f
                nerr += int(_popc(fail).sum())
                _count(c01, mm & cor)
                _count(c10, mm & ~cor & U64(M32))
                out_s[idx[ok]], out_r[idx[ok]] = (cor ^ fail)[ok], fail[ok]
                live += 1
                if live == 255 // (4 * vecs):
                    _flush(c01, n01)
                    _flush(c10, n10)
                    live = 0
            _flush(c01, n01)
            _flush(c10, n10)
            parts[blk] += np.concatenate([n01, n10, [nerr]])
    return out_s, out_r, parts


#: (dtype, shape, density, planes, lead, grid, vectors a thread): dense
#: and sparse masks, vectors off stored's 16-byte grid, and one block of
#: many trips (the bit-sliced counts flushed every 63 or 31 live trips)
EMULATED = [("f32", (7, 19), 1.0, 32, 0, None, 1),
            ("bf16", (3, 5, 11), 0.4, 32, 1, None, 2),
            ("int8", (13, 21), 0.3, 32, 3, None, 1),
            ("f32", (50, 41), 0.001, 32, 2, None, 2),
            ("f32", (300, 300), 0.2, 4, 0, 1, 1),
            ("f32", (300, 300), 0.2, 4, 1, 1, 2)]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("level", [0, 1, 3])
@pytest.mark.parametrize("dt,shape,density,planes,lead,grid,vecs",
                         EMULATED, ids=str)
def test_kernel_arithmetic_equals_twin(dt, shape, density, planes, lead,
                                       grid, vecs, level):
    """The emulated kernel gives the twin's scrubbed words and residual
    masks bit for bit, and its per-block partials give the twin's stats
    through ``stats_from_partials``: energy equal, flips and errors
    exact."""
    seed = 97 * EMULATED.index((dt, shape, density, planes, lead, grid,
                                vecs))
    stored, mask = _data(shape, dt, seed + level, density)
    mask &= np.array((1 << planes) - 1).astype(mask.dtype)
    s_u, m_u = (sops.to_lanes(t) for t in _torch(stored, mask, dt))
    _, tv = _vectors(dt, level)
    s_r, r_r, st = sref.scrub_ref(s_u, m_u, seed, *tv)
    n_vec = -(-(s_u.numel() + lead) // 4)
    grid = grid or -(-n_vec // (256 * vecs))
    u32 = [x.numpy().view(np.uint32).astype(np.uint64)
           for x in (s_u, m_u)]
    thr = [[int(t) for t in x.numpy().view(np.uint32)] for x in tv[:2]]
    e_s, e_r, parts = _kernel_emulation(*u32, seed, *thr, lead, grid, vecs)
    np.testing.assert_array_equal(e_s, s_r.numpy().view(np.uint32))
    np.testing.assert_array_equal(e_r, r_r.numpy().view(np.uint32))
    got = sref.stats_from_partials(torch.from_numpy(parts), tv[2], tv[3])
    for k in ("flips01", "flips10", "errors"):
        assert int(got[k]) == int(st[k]), k
    assert got["energy_pj"].item() == st["energy_pj"].item()


@pytest.mark.usefixtures("one_thread")
def test_transpose32_puts_plane_b_on_lane_b():
    """After the shuffles lane L holds bit L of every lane's word, so its
    popcount is the warp's count of plane L."""
    r = np.random.default_rng(8)
    x = r.integers(0, 2 ** 32, 32, dtype=np.uint64)
    t = _transpose32(x)
    bits = (x[:, None] >> np.arange(32, dtype=np.uint64)) & U64(1)
    tb = (t[:, None] >> np.arange(32, dtype=np.uint64)) & U64(1)
    np.testing.assert_array_equal(tb, bits.T)
