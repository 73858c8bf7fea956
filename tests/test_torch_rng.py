"""The port's threefry key schedule and draws (host numpy and torch
device ops) against jax.random."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import rng


def test_probes():
    assert int(rng.bits(rng.PRNGKey(0), (1,))[0]) == 4070199207
    assert rng.fold_in(rng.PRNGKey(0), 3).tolist() == [2467461003,
                                                       3840466878]


def _chain(mod, seed, fold, split_n, pick):
    """PRNGKey(seed) -> fold_in(fold) -> split(split_n)[pick] -> bits."""
    k = mod.PRNGKey(seed)
    k = mod.fold_in(k, fold)
    k = mod.split(k, split_n)[pick]
    return k


@pytest.mark.parametrize("case", range(50))
def test_random_chains_match_jax(case):
    r = np.random.default_rng(1000 + case)
    seed = int(r.integers(0, 2 ** 31))
    fold = int(r.integers(0, 2 ** 32))
    split_n = int(r.integers(2, 6))
    pick = int(r.integers(0, split_n))
    kt = _chain(rng, seed, fold, split_n, pick)
    kj = np.asarray(_chain(jax.random, seed, fold, split_n, pick))
    assert kt.tolist() == kj.tolist()
    bt = rng.bits(kt, (3,))
    bj = np.asarray(jax.random.bits(kj, (3,), np.uint32))
    assert bt.tolist() == bj.tolist()
    assert rng.seed_u32(kt) == int(np.asarray(
        jax.random.bits(kj, (1,), np.uint32))[0])


@pytest.mark.parametrize("shape", [(1,), (7,), (5, 33), (3, 4, 16)])
def test_uniform_and_bernoulli_match_jax(shape):
    """Host numpy and device-op (CPU tensor) draws against jax.random,
    bit for bit."""
    key = rng.fold_in(rng.PRNGKey(11), len(shape) * 100 + shape[-1])
    jkey = jax.numpy.asarray(key)
    jb = np.asarray(jax.random.bits(jkey, shape, np.uint32))
    ju = np.asarray(jax.random.uniform(jkey, shape))
    assert rng.bits(key, shape).tolist() == jb.tolist()
    assert rng.bits_t(key, shape, "cpu").numpy().tolist() == jb.tolist()
    assert rng.uniform(key, shape).view(np.int32).tolist() == \
        ju.view(np.int32).tolist()
    assert rng.uniform_t(key, shape, "cpu").numpy().view(
        np.int32).tolist() == ju.view(np.int32).tolist()
    for p in (0.3, 1e-6, 0.0):
        jbern = np.asarray(jax.random.bernoulli(jkey, p, shape))
        assert rng.bernoulli(key, p, shape).tolist() == jbern.tolist()
        assert rng.bernoulli_t(key, p, shape, "cpu").numpy().tolist() == \
            jbern.tolist()


@pytest.mark.parametrize("start", [0, 42_467_328 - 4096, 2 ** 32 - 4096])
def test_device_counters_match_host_threefry(start):
    """The device counter draw at any window below 2^32 (a full-width
    admission leaf draws 42.5 M words) equals the host block function."""
    key = rng.fold_in(rng.PRNGKey(3), 9)
    ctr = np.arange(start, start + 4096, dtype=np.uint32)
    y0, y1 = rng.threefry2x32(key, np.zeros_like(ctr), ctr)
    got = rng.counter_bits_t(key, torch.from_numpy(ctr.astype(np.int64)))
    assert got.numpy().tolist() == (y0 ^ y1).astype(np.int64).tolist()
    with pytest.raises(AssertionError):
        rng.check_count(2 ** 32)


# --------------------------------------------------------------------------
# normal: XLA's erf_inv over XLA's CPU log1p, each fused multiply-add fused
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [(1, (1, 24, 1280)),
                                        (18, (1, 24, 1280)),
                                        (35, (1, 24, 1280)),
                                        (2, (1, 8, 1024)), (7, (3, 5))])
def test_normal_matches_jax(seed, shape):
    """The synthetic stream's frames and image embeddings, bit for bit."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        np.float32))
    got = rng.normal(rng.PRNGKey(seed), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_normal_over_every_uniform():
    """Every float32 uniform ``u = k 2^-23`` the draw can start from,
    mapped to [nextafter(-1, 0), 1): ``sqrt(2) erf_inv(x)`` equals XLA's
    for all 2^23 of them, so ``normal`` is exact for every key."""
    u = (np.arange(2 ** 23, dtype=np.uint32) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.maximum(lo, (u.astype(np.float64) * 2 + lo).astype(np.float32))
    sqrt2 = np.float32(np.sqrt(2))
    want = np.asarray(jax.jit(lambda v: jax.lax.erf_inv(v) * sqrt2)(x))
    got = (sqrt2 * rng.erf_inv(x)).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_xla_log1p_and_log_match_jax():
    """Over (-1, 0] (the branch point sqrt(2) - 1 and both ends
    included) and ``log`` over (0, 1]; numpy's float32 ``log1p`` differs
    from XLA's in the last bit of about a sixth of these."""
    r = np.random.default_rng(0)
    x = -r.uniform(0, 1, 1 << 20).astype(np.float32)
    t = np.float32(0.41421356237309504880)
    x = np.concatenate([x, [0.0, -0.0, -t, np.nextafter(-t, 0),
                            np.nextafter(-t, -1), -0.99999994]]).astype(
        np.float32)
    np.testing.assert_array_equal(
        rng.xla_log1p(x).view(np.uint32),
        np.asarray(jax.numpy.log1p(x)).view(np.uint32))
    y = x[x > -1] + np.float32(1)
    np.testing.assert_array_equal(
        rng.xla_log(y).view(np.uint32),
        np.asarray(jax.numpy.log(y)).view(np.uint32))


def test_normal_draws_float32_only():
    with pytest.raises(ValueError):
        rng.normal(rng.PRNGKey(0), (2,), "bfloat16")
