"""The port's memory regions and single-tensor decay against the JAX
reference (``repro.memory.MemoryRegion``, ``repro.reliability.
decay_tensor``), on the CPU.

* Twins of ``test_memory.py``'s ``TestMemoryRegion`` and of
  ``test_reliability.py``'s ``TestRegionLifetime``,
  ``test_region_write_voids_decay_and_books_wear``,
  ``test_decay_layout_invariant`` and ``test_exponent_planes_protected``.
* ``decay_tensor`` is bit-exact (decayed words, flip masks, flips) for
  float32 and bfloat16 at 300, 350 and 400 K, and its thresholds are
  bit-equal at the checkpoint restore's temperatures and dwells.
* A region's report through ``lanes_ref`` equals the reference's:
  counts, flips, errors and lifetime counters exact, energies at
  rtol=1e-5 (float32 sums in another order, ROADMAP §C).
* ``WritePlan.for_tree(policy=, approx_if=)`` resolves the reference's
  levels; ``approx_bits`` and ``decode_bits`` are equal.
* ``retention_sweep`` equals the reference's at a small size, and the
  quickstart runs.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import memory as jmemory
from repro.core.priority import Priority as JP
from repro.reliability import decay_tensor as jdecay_tensor
from repro.reliability import lifetime as jlife
from repro_torch import memory, rng
from repro_torch import tree as T
from repro_torch.core import approx_store as aps
from repro_torch.core.priority import Priority, int_type
from repro_torch.reliability import decay_tensor
from repro_torch.reliability import lifetime as tlife

CPU = torch.device("cpu")
RTOL = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _bits(x):
    """A tensor or array as its unsigned bit pattern (numpy)."""
    if isinstance(x, torch.Tensor):
        x = x.view(int_type(x.dtype)).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _normal(seed, shape, dt="bf16"):
    """(port tensor, reference array) of the same seeded values."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(x).to(DTYPES[dt][0]),
            jnp.asarray(x).astype(DTYPES[dt][1]))


# ---------------------------------------------------------------------------
# twins of test_memory.py's TestMemoryRegion
# ---------------------------------------------------------------------------

def test_functional_write_and_report():
    data = {"a": torch.zeros((16, 16))}
    r = memory.MemoryRegion.create(data, level=Priority.MID,
                                   backend="lanes_ref")
    r = r.write(rng.PRNGKey(0), {"a": torch.ones((16, 16))})
    r2 = r.write(rng.PRNGKey(1), {"a": torch.ones((16, 16))})  # redundant
    rep1, rep2 = r.report(), r2.report()
    assert rep2["energy_pj"] == rep1["energy_pj"]  # CMP: a free re-write
    assert rep2["bits_total"] == 2 * rep1["bits_total"]
    assert rep2["backend"] == "lanes_ref"
    assert torch.equal(r2.read()["a"], r.read()["a"])


def test_stats_stay_on_device_until_report():
    r = memory.MemoryRegion.create({"a": torch.zeros((8,))})
    r = r.write(rng.PRNGKey(0), {"a": torch.ones((8,))})
    assert r.plan.backend.name == "lanes_ref"  # the CPU's default
    assert all(isinstance(getattr(r.stats, f), torch.Tensor)
               for f in ("energy_pj", "flips01", "errors", "bits_total"))


# ---------------------------------------------------------------------------
# twins of test_reliability.py's region and decay cases
# ---------------------------------------------------------------------------

def test_default_region_is_immortal_and_plan_identical():
    """No retention knobs: ``age`` is an identity and the write equals a
    plain plan-level write (same plan, same RNG, same stats)."""
    data = {"a": torch.zeros((16, 16))}
    new = {"a": torch.ones((16, 16))}
    r = memory.MemoryRegion.create(data, level=Priority.MID)
    assert r.life_plan.immortal
    r = r.write(rng.PRNGKey(0), new)
    assert r.age(rng.PRNGKey(1), steps=100) is r
    assert r.scrub(rng.PRNGKey(2)) is r
    rep = r.report()
    assert "retention_flips" not in rep
    plan = memory.WritePlan.for_tree(
        data, device=CPU, backend="lanes_ref",
        policy=lambda p, leaf: Priority.MID,
        approx_if=lambda leaf, tag: tag != Priority.EXACT)
    stored, st = plan.write(rng.PRNGKey(0), data, new,
                            plan.vectors_for(Priority.LOW))
    assert torch.equal(r.read()["a"], stored["a"])
    assert rep["energy_pj"] == float(st.energy_pj)


def test_shim_regions_immortal():
    store = aps.ApproxStore(backend="lanes_ref")
    k = rng.PRNGKey(12)
    x = torch.ones((64,))
    store, got1 = store.write(k, "w", x, Priority.LOW)
    stored2, _ = memory.write(k, torch.zeros_like(x), x, level=Priority.LOW,
                              backend="lanes_ref")
    assert torch.equal(got1, stored2)
    assert torch.equal(store.read("w"), got1)


def _mortal(seed=3, shape=(64, 64)):
    golden = {"v": _normal(seed, shape)[0]}
    r = memory.MemoryRegion.create(
        {"v": torch.zeros_like(golden["v"])}, level=Priority.LOW,
        ambient_k=400.0, retention_scale=1e4)
    return golden, r


def test_mortal_region_rots_and_scrubs():
    golden, r = _mortal()
    r = r.write(rng.PRNGKey(4), golden)
    r = r.age(rng.PRNGKey(5), steps=4)
    rotted = r.report()
    assert rotted["retention_flips"] > 0
    assert rotted["residual_decayed_bits"] > 0
    r = r.scrub(rng.PRNGKey(6))
    rep = r.report()
    assert rep["scrub_energy_pj"] > 0.0
    np.testing.assert_allclose(rep["lifetime_energy_pj"],
                               rep["energy_pj"] + rep["scrub_energy_pj"],
                               rtol=1e-7)
    assert rep["residual_decayed_bits"] < rotted["residual_decayed_bits"]


def test_region_write_voids_decay_and_books_wear():
    golden, r = _mortal(seed=0)
    r = r.write(rng.PRNGKey(1), golden)
    r = r.age(rng.PRNGKey(2), steps=4)
    assert r.report()["residual_decayed_bits"] > 0
    assert int(r.life.step) == 4  # the clock counts dwell steps
    # aging books no write wear; the two writes book exactly 2
    assert int(r.life.write_count[0]) == 1
    r = r.write(rng.PRNGKey(3), golden)
    assert int(r.life.write_count[0]) == 2
    assert int(r.life.row_write_count[0, 0]) == 2
    assert r.report()["residual_decayed_bits"] == 0


def test_decay_layout_invariant():
    key = rng.PRNGKey(0)
    x = _normal(0, (8, 32))[0]
    d1, m1, n1 = decay_tensor(key, x, level=Priority.LOW, ambient_k=400.0,
                              dwell_s=1e5)
    d2, m2, n2 = decay_tensor(key, x.reshape(256), level=Priority.LOW,
                              ambient_k=400.0, dwell_s=1e5)
    assert int(n1) == int(n2) > 0
    assert torch.equal(d1.reshape(-1).view(torch.int16), d2.view(torch.int16))
    assert torch.equal(m1.reshape(-1), m2)


def test_exponent_planes_protected():
    x = torch.ones((64, 64))
    d, _, n = decay_tensor(rng.PRNGKey(1), x, level=Priority.LOW,
                           ambient_k=400.0, dwell_s=1e6)
    assert int(n) > 0
    assert bool(torch.isfinite(d).all())
    assert float((d - 1.0).abs().max()) < 1.0


# ---------------------------------------------------------------------------
# decay parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_k", [300.0, 350.0, 400.0])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_decay_tensor_is_bit_exact(dt, t_k):
    xt, xj = _normal(17, (24, 40), dt)
    for level, dwell in ((Priority.LOW, 1e5), (Priority.MID, 3600.0)):
        dt_, mt, nt = decay_tensor(rng.PRNGKey(5), xt, level=level,
                                   ambient_k=t_k, dwell_s=dwell)
        dj, mj, nj = jdecay_tensor(jax.random.PRNGKey(5), xj,
                                   level=JP(int(level)), ambient_k=t_k,
                                   dwell_s=dwell)
        np.testing.assert_array_equal(_bits(dt_), _bits(dj))
        np.testing.assert_array_equal(_bits(mt), _bits(mj))
        assert int(nt) == int(nj)
    if t_k == 400.0:
        assert int(nt) > 0


@pytest.mark.parametrize("t_k,dwell", [(400.0, 1e5), (350.0, 3600.0)])
def test_restore_thresholds_are_bit_equal(t_k, dwell):
    """The restore integrity pass's (temperature, dwell) pairs: 1e5 s at
    400 K (the card's phase) and the RestoreIntegrity default."""
    for dt in DTYPES.values():
        for level in (Priority.LOW, Priority.MID, Priority.HIGH):
            thr_t = tlife._retention_thresholds(dt[0], level, t_k, dwell)
            thr_j = np.asarray(jlife._retention_thresholds(
                jnp.dtype(dt[1]), JP(int(level)), t_k, dwell))
            np.testing.assert_array_equal(thr_t, thr_j)


# ---------------------------------------------------------------------------
# region and plan parity
# ---------------------------------------------------------------------------

def _policy(path, leaf):
    s = str(path)
    if "'v'" in s:
        return 0
    if "'k'" in s:
        return 1
    return 3


def _trees(seed):
    r = np.random.default_rng(seed)
    c = {"kv": {"k": r.standard_normal((2, 3, 6, 4)).astype(np.float32),
                "v": r.standard_normal((2, 3, 6, 4)).astype(np.float32)},
         "n": r.integers(-99, 99, (3, 5)).astype(np.int32)}
    return (T.tree_map(torch.from_numpy, c), jax.tree.map(jnp.asarray, c))


@pytest.mark.parametrize("mortal", [False, True])
def test_region_report_matches_reference(mortal):
    """Writes (the int32 leaf too: ``approx_if`` takes every non-EXACT
    tag), then aging and a scrub when mortal."""
    (t0, j0), (t1, j1), (t2, j2) = _trees(0), _trees(1), _trees(2)
    zt, zj = T.tree_map(torch.zeros_like, t0), jax.tree.map(jnp.zeros_like,
                                                           j0)
    kw = dict(policy=_policy, backend="lanes_ref",
              ambient_k=400.0, retention_scale=1e4 if mortal else 0.0)
    rt = memory.MemoryRegion.create(zt, **kw)
    rj = jmemory.MemoryRegion.create(zj, **kw)
    assert rt.plan.leaf_levels == tuple(
        None if x is None else Priority(int(x))
        for x in rj.plan.leaf_levels)
    for i, (nt, nj) in enumerate(((t1, j1), (t2, j2))):
        rt = rt.write(rng.PRNGKey(i), nt)
        rj = rj.write(jax.random.PRNGKey(i), nj)
        rt = rt.age(rng.PRNGKey(10 + i), steps=3)
        rj = rj.age(jax.random.PRNGKey(10 + i), steps=3)
    rt = rt.scrub(rng.PRNGKey(20))
    rj = rj.scrub(jax.random.PRNGKey(20))
    pt, pj = rt.report(), rj.report()
    assert set(pt) == set(pj)
    for k, v in pj.items():
        if k.endswith("energy_pj"):
            np.testing.assert_allclose(pt[k], v, rtol=RTOL, err_msg=k)
        elif k not in ("latency_ns", "write_skip_rate", "ber_realized"):
            assert pt[k] == v, k
    for a, b in zip(T.leaves(rt.read()), jax.tree.leaves(rj.read())):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    if mortal:
        assert pt["retention_flips"] > 0
        for f in ("write_count", "row_write_count", "scrub_count", "step"):
            np.testing.assert_array_equal(getattr(rt.life, f).numpy(),
                                          np.asarray(getattr(rj.life, f)))


def test_plan_metadata_matches_reference():
    tt, tj = _trees(3)
    axes = {"kv": {"k": ("layers", "batch", "kv_seq", "head_dim"),
                   "v": ("layers", "batch", "kv_seq", "head_dim")},
            "n": ("batch", "head_dim")}
    tp = memory.WritePlan.for_tree(tt, device=CPU, backend="lanes_ref",
                                   axes=axes)
    jp = jmemory.WritePlan.for_tree(tj, backend="lanes_ref", axes=axes)
    assert tp.leaf_seq_axis == jp.leaf_seq_axis == (2, 2, None)
    assert tp.approx_bits(tt) == jp.approx_bits(tj) == 2 * 144 * 32
    assert tp.decode_bits(tt) == jp.decode_bits(tj) == 2 * 24 * 32
    no_axes = memory.WritePlan.for_tree(tt, device=CPU, backend="lanes_ref")
    assert no_axes.leaf_seq_axis == (None,) * 3
    assert no_axes.decode_bits(tt) == no_axes.approx_bits(tt)


# ---------------------------------------------------------------------------
# the benchmark and the example
# ---------------------------------------------------------------------------

def test_retention_sweep_matches_reference():
    """The port's sweep at a small size; the three cells its claims
    read against the reference's."""
    from benchmarks import retention_sweep as jsweep
    from repro_torch.benchmarks import retention_sweep as tsweep
    kw = dict(steps=4, dwell_s=1000.0, shape=(8, 16), backend="lanes_ref")
    tout = tsweep.run(temps=(300.0, 400.0), intervals=(0, 2), device="cpu",
                      **kw)
    assert all(tout["claims"].values()) and len(tout["claims"]) == 4
    for t_k, iv in ((300.0, 0), (400.0, 0), (400.0, 2)):
        jc = jsweep._one_cell(t_k, iv, **kw)
        tc = tout["cells"][f"{int(t_k)}K/scrub={iv or 'never'}"]
        cell = (t_k, iv)
        for k in ("retention_flips", "residual_decayed_bits"):
            assert tc[k] == jc[k], (cell, k)
        for k in ("write_energy_pj", "scrub_energy_pj",
                  "lifetime_energy_pj"):
            np.testing.assert_allclose(tc[k], jc[k], rtol=RTOL)
        np.testing.assert_allclose(tc["v_rel_err"], jc["v_rel_err"],
                                   rtol=1e-6)
    # the reference's hook reads the port's result: the same schema
    assert tsweep.bench_metrics(tout) == jsweep.bench_metrics(tout)


def test_quickstart_runs():
    from repro_torch.examples import quickstart
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        quickstart.main(["--device", "cpu", "--wear-policy", "rotate",
                         "--ambient-k", "400"])
    out = buf.getvalue()
    for n in range(1, 9):
        assert f"== {n}. " in out, n
    # the CPU sweep: every backend but the card's
    assert "cuda" not in out.split("== 4.")[0].split("== 3.")[1].replace(
        "(cpu)", "")
    assert "max group wear 8 (no leveling would be 32)" in out
    assert "retention flips" in out
