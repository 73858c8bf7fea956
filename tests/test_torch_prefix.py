"""The port's prefix cache, slot links, column aliasing and linked decay
reset against the JAX reference (``repro.serve.prefix``,
``repro.serve.slots``, ``WritePlan(alias_cols=)``,
``LifetimePlan.reset_rows_linked``): signatures, lookups and slot
bookkeeping equal; aliased writes, their pricing and the linked reset
bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.memory import WritePlan as JPlan
from repro.models import get_model as jmodel
from repro.serve.prefix import PrefixCache as JPrefixCache
from repro.serve.prefix import PrefixConfig as JPrefixConfig
from repro.serve.slots import SlotPool as JSlotPool
from repro_torch import rng
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core.priority import Priority as TP
from repro_torch.memory import WritePlan as TPlan
from repro_torch.models import get_model
from repro_torch.serve.prefix import PrefixCache, PrefixConfig
from repro_torch.serve.slots import SlotPool
from test_torch_reliability import (AXES, CPU, _bits_np, _cache,
                                    _check_state, _decayed, _life_plans)


def _prompts(n, seed, shared=8, length=20):
    r = np.random.default_rng(seed)
    head = r.integers(0, 1000, shared)
    out = []
    for i in range(n):
        toks = r.integers(0, 1000, length)
        if i % 3 != 2:  # two of three share the head
            toks[:shared] = head
        p = {"tokens": toks[None, :length - (i % 4)]}
        if i % 5 == 4:  # a multimodal leaf folds into every digest
            p["image_embeds"] = r.standard_normal((1, 2, 3)).astype(
                np.float32)
        out.append(p)
    return out


@pytest.mark.parametrize("chunk,table", [(4, 256), (3, 5), (8, 2)])
def test_signatures_and_lookups_match_the_reference(chunk, table):
    """The same prompts through both caches: equal digest chains, equal
    match decisions (generation checks included), equal counters."""
    tc = PrefixCache(PrefixConfig(chunk=chunk, table_size=table))
    jc = JPrefixCache(JPrefixConfig(chunk=chunk, table_size=table))
    gen = [0] * 4
    for i, p in enumerate(_prompts(14, chunk * 10 + table)):
        ts, js = tc.signatures(p), jc.signatures(p)
        assert ts == js
        valid = lambda slot, g: gen[slot] == g  # noqa: E731
        tm = tc.lookup(ts, valid, max_cols=p["tokens"].shape[1])
        jm = jc.lookup(js, valid, max_cols=p["tokens"].shape[1])
        assert (tm is None) == (jm is None)
        if tm is not None:
            assert (tm.slot, tm.cols, tm.tokens) == (jm.slot, jm.cols,
                                                     jm.tokens)
        slot = i % 4
        gen[slot] += 1
        tc.insert(ts, slot, gen[slot], col_offset=i % 2)
        jc.insert(js, slot, gen[slot], col_offset=i % 2)
        if i % 6 == 5:  # overwrite a slot: its entries go stale
            gen[(i + 1) % 4] += 1
    assert tc.stats() == jc.stats()
    assert tc.hits > 0
    tc.reset_stats()
    jc.reset_stats()
    assert tc.stats() == jc.stats()


def test_slot_links_and_cow_match_the_reference():
    """One scripted sequence of allocations, links, releases and
    copy-on-write detaches through both pools' host bookkeeping."""
    cap = 5
    jpool = JSlotPool(jmodel(jget("qwen2.5-3b").reduced()), cap, 8)
    tpool = SlotPool(get_model(get_config("qwen2.5-3b").reduced()), cap, 8,
                     CPU)

    def both(fn):
        a, b = fn(tpool), fn(jpool)
        assert a == b
        return a

    def occupy(pool, ids):
        for i in ids:
            pool.slot_req[i] = ("req", i)
        return ids

    ids = both(lambda p: occupy(p, p.alloc(3)))
    both(lambda p: p.link(1, 0, 8))
    both(lambda p: p.link(2, 1, 4))
    both(lambda p: p.link(0, 0, 4))           # self-link: no-op
    both(lambda p: p.release([0]))            # owner 0 free but blocked
    both(lambda p: (p.blocked_free(), p.allocatable(), p.allocatable([3])))
    assert both(lambda p: occupy(p, p.alloc(1, exclude=[4]))) == [3]
    both(lambda p: (p.blocked_free(), p.allocatable(), p.col_refs))
    assert both(lambda p: p.cow_detach(0)) == [(1, 8)]
    both(lambda p: (p.blocked_free(), p.col_refs, sorted(p.links.items())))
    both(lambda p: p.release([1, 2]))         # 2 drops its link to 1
    both(lambda p: (p.col_refs, sorted(p.links.items()), p.free_slots(),
                    p.alloc(2)))
    assert ids == [0, 1, 2]


def _plans():
    c = _cache(1)
    jplan = JPlan.for_tree(jax.tree.map(jnp.asarray, c),
                           backend="lanes_ref", axes=AXES)
    tplan = TPlan.for_tree(T.tree_map(torch.from_numpy, c), device=CPU,
                           backend="lanes_ref", axes=AXES)
    return c, jplan, tplan


def test_aliased_writes_are_bit_exact():
    """``write`` and ``write_columns`` with a column alias: bit-exact with
    the reference, linked columns keep their stored bits at zero cost,
    and an all-zero alias equals no alias."""
    c, jplan, tplan = _plans()
    new = _cache(2)
    old_t, new_t = (T.tree_map(torch.from_numpy, x) for x in (c, new))
    old_j, new_j = (jax.tree.map(jnp.asarray, x) for x in (c, new))
    alias = np.array([4, 0, 6])
    key = rng.fold_in(rng.PRNGKey(8), 1)
    tv, jv = tplan.vectors_for(TP.LOW), jplan.vectors_for()
    ts, tst = tplan.write(key, old_t, new_t, tv,
                          alias_cols=torch.from_numpy(alias))
    js, jst = jplan.write(jnp.asarray(key), old_j, new_j, jv,
                          alias_cols=jnp.asarray(alias, jnp.int32))
    for leaf in ("k", "v"):
        a = _bits_np(ts["slot0"][leaf])
        np.testing.assert_array_equal(a, _bits_np(js["slot0"][leaf]))
        for b, n in enumerate(alias):
            np.testing.assert_array_equal(
                a[:, b, :n], _bits_np(old_t["slot0"][leaf])[:, b, :n])
    th, jh = tst.host_dict(), jst.host_dict()
    for k in ("flips01", "flips10", "bit_errors", "bits_total"):
        assert th[k] == jh[k], k
    np.testing.assert_allclose(th["energy_pj"], jh["energy_pj"], rtol=1e-5)
    z = tplan.write(key, old_t, new_t, tv,
                    alias_cols=torch.zeros(3, dtype=torch.int64))
    n = tplan.write(key, old_t, new_t, tv)
    assert z[1].host_dict() == n[1].host_dict()
    for leaf in ("k", "v"):
        assert torch.equal(z[0]["slot0"][leaf], n[0]["slot0"][leaf])
    pos = np.array([3, 9, 5])
    tc, tcs = tplan.write_columns(key, old_t, new_t, torch.from_numpy(pos),
                                  tv, alias_cols=torch.from_numpy(alias))
    jc, jcs = jplan.write_columns(jnp.asarray(key), old_j, new_j,
                                  jnp.asarray(pos, jnp.int32), jv,
                                  alias_cols=jnp.asarray(alias, jnp.int32))
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(_bits_np(tc["slot0"][leaf]),
                                      _bits_np(jc["slot0"][leaf]))
    assert tcs.host_dict()["bits_written"] == jcs.host_dict()[
        "bits_written"] > 0
    # prices: the same host arithmetic as the reference's; energies to
    # 1e-6, since the reference may hold the level table it computes
    # outside compile-time evaluation, whose energies differ in the last
    # bit (ROADMAP §C)
    for cols in (0, 3, 6, 50):
        (tp, tb), (jpj, jb) = (tplan.alias_saving(old_t, cols),
                               jplan.alias_saving(old_j, cols))
        assert tb == jb
        np.testing.assert_allclose(tp, jpj, rtol=1e-6)


def test_reset_rows_linked():
    """All-zero ``cols`` equals ``reset_rows``; linked columns inherit the
    source slot's decay masks, bit-exact with the reference."""
    jl, tl = _life_plans()
    _, st, _, sj = _decayed(jl, tl)
    idx = torch.tensor([0, 2])
    zero = tl.reset_rows_linked(st, idx, torch.tensor([1, 1]),
                                torch.zeros(2, dtype=torch.int64))
    plain = tl.reset_rows(st, idx)
    for a, b in zip(zero.masks, plain.masks):
        assert torch.equal(a, b)
    src, cols = np.array([1, 1]), np.array([3, 6])
    st = tl.reset_rows_linked(st, idx, torch.from_numpy(src),
                              torch.from_numpy(cols))
    sj = jl.reset_rows_linked(sj, jnp.asarray([0, 2], jnp.int32),
                              jnp.asarray(src, jnp.int32),
                              jnp.asarray(cols, jnp.int32))
    _check_state(st, sj)
    assert any(_bits_np(m[:, 2, :6]).any() for m in st.masks)
