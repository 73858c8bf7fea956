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
