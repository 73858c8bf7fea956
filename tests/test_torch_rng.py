"""The port's host-side threefry key schedule against jax.random."""
import jax
import numpy as np
import pytest

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
