"""The port's sharded dies (``repro_torch.sharding`` and its hooks in the
lifetime plan, the scrub pass, the engine and the scheduler) against the
JAX reference.

* ``DieMesh``'s layout and reductions equal the reference's on
  numpy-seeded inputs.
* ``vectors_for_dies`` equals the reference's thresholds, uniform
  ((nbits,) per leaf, the 1-die operands) and divergent (per-slot rows).
* ``scrub_tree(slot_mask=)`` is exact against the reference: words,
  residual masks, counters and counts, with and without ``addr=``.
* Any die count is the 1-die run bit for bit while the dies are alike
  (shards 1, 2, 4 at capacity 4, retention, scrubbing and wear on).
* Heating die 1 leaves die 0's decay record unchanged bit for bit and
  gives die 1 extra die-masked scrub passes.
* With divergent die ambients the port's scheduler running the
  reference's model numerics (the ``JaxModel`` adapter) equals the
  reference in tokens, streams and the ``sharding`` section (energies at
  rtol=1e-5).

The reference's counters are int32 and the port's int64: values are
compared, never dtypes.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.reliability import make_scrub_policy as jmake_scrub_policy
from repro.reliability import scrub_tree as jscrub_tree
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.sharding import DieMesh as JDieMesh
from repro.sharding import uniform as juniform
from repro_torch import rng
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.priority import Priority as TP
from repro_torch.reliability import make_scrub_policy, scrub_tree
from repro_torch.reliability.lifetime import SlotThresholds
from repro_torch.serve import (ContinuousScheduler, Request, ServeConfig,
                               ServingEngine)
from repro_torch.sharding import DieMesh, uniform
from test_torch_serve import ARCH, JaxModel
from test_torch_wear import _cache, _decayed_pair, _plans, _same, _trees

CPU = torch.device("cpu")
RTOL = 1e-5


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dies,capacity", [(1, 4), (2, 4), (4, 4),
                                             (3, 12)])
def test_die_mesh_matches_the_reference(n_dies, capacity):
    r = np.random.default_rng(n_dies * 100 + capacity)
    m, jm = DieMesh(n_dies, capacity), JDieMesh(n_dies, capacity)
    assert m.slots_per_die == jm.slots_per_die
    for s in range(capacity):
        assert m.die_of_slot(s) == jm.die_of_slot(s)
    for d in range(n_dies):
        assert m.slot_slice(d) == jm.slot_slice(d)
        mask = m.slot_mask(d, CPU)
        assert mask.dtype == torch.bool and mask.device == CPU
        _same(mask, jm.slot_mask(d))
        assert m.slot_mask(d, CPU) is mask  # built once per (die, device)
    np.testing.assert_array_equal(m.die_ids(), jm.die_ids())
    per_slot = r.standard_normal((capacity, 3)).astype(np.float32)
    np.testing.assert_array_equal(m.reduce_slots(per_slot),
                                  jm.reduce_slots(per_slot))
    np.testing.assert_array_equal(m.reduce_slots(per_slot[:, 0], np.max),
                                  jm.reduce_slots(per_slot[:, 0], np.max))
    for gps, pad in ((1, 0), (3, 2)):
        wear = r.integers(0, 50, (5, capacity * gps + pad))
        wear[:, capacity * gps:] = 0
        np.testing.assert_array_equal(m.reduce_wear(wear),
                                      jm.reduce_wear(wear))
    per_die = r.random(n_dies)
    np.testing.assert_array_equal(m.per_slot(per_die),
                                  jm.per_slot(per_die))
    tree = {"a": torch.arange(6.0)}
    assert m.shard_slots(tree, 0) is tree
    with pytest.raises(AssertionError):
        DieMesh(3, 8)


@pytest.mark.parametrize("values", [[], [300.0], [300.0, 300.0],
                                    [300.0, 360.0], [1, 1, 2]])
def test_uniform_matches_the_reference(values):
    assert uniform(values) == juniform(values)


# ---------------------------------------------------------------------------
# per-die thresholds and the die-masked scrub
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("floor", [TP.LOW, TP.HIGH])
@pytest.mark.parametrize("ambients,spd", [((350.0, 350.0), 2),
                                          ((300.0, 420.0), 2),
                                          ((420.0, 300.0, 380.0), 1)])
def test_vectors_for_dies_match_the_reference(ambients, spd, floor):
    _, _, jl, tl = _plans(dwell=1e4, ambient_k=320.0)
    vt = tl.vectors_for_dies(floor, ambients, spd)
    vj = jl.vectors_for_dies(floor, ambients, spd)
    assert [v is None for v in vt] == [v is None for v in vj]
    for a, b in zip(vt, vj):
        if b is None:
            continue
        if uniform(ambients):
            assert isinstance(a, np.ndarray) and a.shape == b.shape
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            assert isinstance(a, SlotThresholds)
            np.testing.assert_array_equal(a.host, np.asarray(b))
            np.testing.assert_array_equal(a.dev.T.numpy(), np.asarray(b))
    if not uniform(ambients):
        # built and uploaded once per (floor, ambients)
        assert tl.vectors_for_dies(floor, ambients, spd)[1] is vt[1]


def test_per_slot_decay_matches_the_reference():
    """``advance`` with per-slot rows: words, masks and flips exact; the
    cool slots' decay equals a run at the cool ambient everywhere."""
    _, _, jl, tl = _plans(dwell=1e4, ambient_k=300.0)
    cj, ct = _trees(_cache(3))
    st, sj = tl.init_state(ct), jl.init_state(cj)
    amb = (420.0, 300.0, 300.0)  # one slot a die: slot 0 runs hot
    vt = tl.vectors_for_dies(TP.LOW, amb, 1)
    vj = jl.vectors_for_dies(TP.LOW, amb, 1)
    cool = tl.vectors_for(TP.LOW, ambient_k=300.0)
    cc, sc = ct, st
    for s in range(3):
        ct, st = tl.advance(rng.PRNGKey(40 + s), ct, st, vt)
        cj, sj = jl.advance(jax.random.PRNGKey(40 + s), cj, sj, vj)
        cc, sc = tl.advance(rng.PRNGKey(40 + s), cc, sc, cool)
    for a, b in zip(T.leaves(ct), jax.tree.leaves(cj)):
        _same(a, b)
    for a, b in zip(st.masks, sj.masks):
        _same(a, b)
    _same(st.retention_flips, sj.retention_flips)
    assert int(st.retention_flips) > int(sc.retention_flips)
    for a, b in zip(st.masks, sc.masks):
        if a is not None:
            assert torch.equal(a[:, 1:], b[:, 1:])  # slots 1, 2: cool


@pytest.mark.parametrize("addr", [False, True], ids=["plain", "addr"])
@pytest.mark.parametrize("cols,cursor", [(None, 0), (6, 13)],
                         ids=["whole", "window_wraps"])
@pytest.mark.parametrize("mask", [(True, False, True), (False, True, False),
                                  (True, True, True)])
def test_masked_scrub_is_exact(mask, cols, cursor, addr):
    """Out-of-die slots keep their decay and cost nothing; scrub wear is
    booked only for the covered slots' groups."""
    jp, tp, jl, tl = _plans(4, 10 if addr else 0, dwell=1e4,
                            ambient_k=420.0)
    ct, st, cj, sj = _decayed_pair(tl, jl)
    kw_t, kw_j = {}, {}
    if addr:
        sh = np.array([0, 5, 11])
        kw_t["addr"] = (torch.from_numpy(sh), tl.worn_groups(st))
        kw_j["addr"] = (jnp.asarray(sh, jnp.int32), jl.worn_groups(sj))
    m = np.array(mask)
    out_t, st2, acc_t = scrub_tree(
        rng.PRNGKey(5), ct, st, tl, tp.vectors_for(TP.MID), cols=cols,
        cursor=cursor, slot_mask=torch.from_numpy(m), **kw_t)
    out_j, sj2, acc_j = jscrub_tree(
        jax.random.PRNGKey(5), cj, sj, jl, jp.vectors_for(TP.MID),
        cols=cols, cursor=jnp.asarray(cursor, jnp.int32),
        slot_mask=jnp.asarray(m), **kw_j)
    for a, b in zip(T.leaves(out_t), jax.tree.leaves(out_j)):
        _same(a, b)
    for a, b in zip(st2.masks, sj2.masks):
        _same(a, b)
    for f in ("scrub_count", "row_scrub_count", "row_write_count",
              "last_scrub_step"):
        _same(getattr(st2, f), getattr(sj2, f), f)
    h, hj = acc_t.host_dict(), acc_j.host_dict()
    for k in ("flips01", "flips10", "bit_errors", "bits_total"):
        assert h[k] == hj[k], k
    np.testing.assert_allclose(h["energy_pj"], hj["energy_pj"], rtol=RTOL)
    # the held-out slots' masks are untouched
    for a, b in zip(st2.masks, st.masks):
        if a is not None:
            assert torch.equal(a[:, ~torch.from_numpy(m)],
                               b[:, ~torch.from_numpy(m)])
    if all(mask):
        full_t, full_st, full_acc = scrub_tree(
            rng.PRNGKey(5), ct, st, tl, tp.vectors_for(TP.MID), cols=cols,
            cursor=cursor, **kw_t)
        for a, b in zip(T.leaves(out_t), T.leaves(full_t)):
            _same(a, b)
        assert full_acc.host_dict() == h


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    from repro.models import get_model as jmodel
    return jmodel(jget(ARCH).reduced()).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def _requests(cfg, n=5):
    """``n`` 8-token prompts arriving 2 steps apart (numpy, seed 3)."""
    r = np.random.default_rng(3)
    return [Request(rid=i, prompt={"tokens": torch.from_numpy(
        r.integers(0, cfg.vocab_size, (1, 8)))}, new_tokens=4,
        arrival=2 * i, app_id="chat" if i % 2 else None)
        for i in range(n)]


def _serve(params, shards, die_ambients=None, scrub_interval=0, **kw):
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, ServeConfig(
        max_seq=32, max_new_tokens=6, backend="lanes_ref", shards=shards,
        **kw), params, device="cpu")
    sch = ContinuousScheduler(
        eng, capacity=4, die_ambients=die_ambients,
        scrub_policy=make_scrub_policy("periodic", interval=scrub_interval)
        if scrub_interval else None)
    return sch.run(_requests(cfg)), sch


def _merged(rep):
    """The report without its per-die views."""
    rep = dict(rep)
    rep.pop("sharding", None)
    rep["pool"] = {k: v for k, v in rep["pool"].items()
                   if k != "occupancy_by_die"}
    return rep


def test_shard_counts_are_bit_identical(tparams):
    """Shards 1, 2 and 4 at capacity 4 with retention at 400 K, periodic
    scrubbing and rotating wear: one report, bit for bit."""
    kw = dict(retention_scale=50.0, ambient_k=400.0, scrub_interval=2,
              wear_policy="rotate", remap_group_cols=4)
    reps = {d: _serve(tparams, d, **kw) for d in (1, 2, 4)}
    base, sch1 = reps[1]
    assert "sharding" not in base
    assert "occupancy_by_die" not in base["pool"]
    assert base["lifetime"]["retention_flips"] > 0
    for d in (2, 4):
        rep, sch = reps[d]
        assert _merged(rep) == base, d
        for a, b in zip(sch.life.masks, sch1.life.masks):
            if a is not None:
                assert torch.equal(a, b)
        s = rep["sharding"]
        assert s["shards"] == d and s["slots_per_die"] == 4 // d
        assert [x["scrub_passes"] for x in s["dies"]] == \
            [base["lifetime"]["scrub_passes"]] * d
        assert sum(x["decayed_bits"] for x in s["dies"]) == \
            base["lifetime"]["residual_decayed_bits"]
        assert rep["pool"]["occupancy_by_die"] == [0] * d


def test_heating_one_die_leaves_the_other_untouched(tparams):
    """Without scrubbing the decay record is the decay alone: die 0's
    masks are bit-identical to the uniform run's, die 1 decays more.
    With scrubbing the hot die earns its extra die-masked passes."""
    kw = dict(retention_scale=50.0, ambient_k=300.0)
    cold, sc = _serve(tparams, 2, **kw)
    hot, sh = _serve(tparams, 2, {1: 420.0}, **kw)
    c0, c1 = (d["decayed_bits"] for d in cold["sharding"]["dies"])
    h0, h1 = (d["decayed_bits"] for d in hot["sharding"]["dies"])
    assert h0 == c0 and h1 > c1
    for a, b in zip(sh.life.masks, sc.life.masks):
        if a is not None:
            assert torch.equal(a[:, :2], b[:, :2])
    assert [d["ambient_k"] for d in hot["sharding"]["dies"]] == \
        [300.0, 420.0]
    hot, _ = _serve(tparams, 2, {1: 420.0}, scrub_interval=2, **kw)
    passes = [d["scrub_passes"] for d in hot["sharding"]["dies"]]
    assert passes[1] == 2 * passes[0] > 0
    assert hot["lifetime"]["scrub_passes"] == passes[1]


def _jrequests(jcfg, reqs):
    from repro.serve import Request as JRequest
    return [JRequest(rid=r.rid, prompt={"tokens": jnp.asarray(
        r.prompt["tokens"].numpy(), jnp.int32)}, new_tokens=r.new_tokens,
        arrival=r.arrival, app_id=r.app_id) for r in reqs]


@pytest.mark.parametrize("case", ["hot_die", "hot_die_high_quality"])
def test_divergent_ambients_are_exact_against_the_reference(jparams, case):
    """Die 1 at 420 K over a 300 K pool, periodic scrubbing: per-slot
    decay, the extra die-masked passes and (with a HIGH-quality app) the
    steering of admissions away from the hot die, exact."""
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    kw = dict(max_seq=32, max_new_tokens=6, backend="lanes_ref", shards=2,
              retention_scale=50.0, ambient_k=300.0)
    amb = {1: 420.0}
    reqs = _requests(cfg)
    jeng = JEngine(jcfg, JServeConfig(**kw), params=jparams)
    teng = ServingEngine(cfg, ServeConfig(**kw), jparams, device="cpu",
                         api=JaxModel(cfg))
    if case == "hot_die_high_quality":
        from repro.core.priority import Priority as JP
        jeng.controller.tag("kv_request", "chat", JP.HIGH)
        teng.controller.tag("kv_request", "chat", TP.HIGH)
    ref = JSched(jeng, capacity=4, die_ambients=amb,
                 scrub_policy=jmake_scrub_policy("periodic", interval=2)
                 ).run(_jrequests(jcfg, reqs))
    rep = ContinuousScheduler(
        teng, capacity=4, die_ambients=amb,
        scrub_policy=make_scrub_policy("periodic", interval=2)).run(reqs)
    for k in ("clock_steps", "decode_steps", "bursts"):
        assert rep[k] == ref[k], k
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("tokens", "slot", "flips", "errors", "quality"):
            assert p[k] == r[k], (rid, k)
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=RTOL)
    for s, r in ref["streams"].items():
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert rep["streams"][s][k] == r[k], (s, k)
        np.testing.assert_allclose(rep["streams"][s]["energy_pj"],
                                   r["energy_pj"], rtol=RTOL)
    for k in ("retention_flips", "residual_decayed_bits", "scrub_passes"):
        assert rep["lifetime"][k] == ref["lifetime"][k], k
    s, sr = rep["sharding"], ref["sharding"]
    for k in ("shards", "slots_per_die", "mesh_devices"):
        assert s[k] == sr[k], k
    for d, dr in zip(s["dies"], sr["dies"]):
        assert set(d) == set(dr)
        for k, v in dr.items():
            if k == "energy_pj":
                np.testing.assert_allclose(d[k], v, rtol=RTOL)
            else:
                assert d[k] == v, (d["die"], k, d[k], v)
    assert rep["pool"]["occupancy_by_die"] == \
        ref["pool"]["occupancy_by_die"]
    assert s["dies"][1]["scrub_passes"] > s["dies"][0]["scrub_passes"]
    if case == "hot_die_high_quality":
        # the HIGH requests (odd rids) were steered onto die 0's slots
        assert all(rep["requests"][i]["slot"] < 2 for i in (1, 3))


def test_launcher_shards_and_telemetry_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.telemetry import validate_timeline
    prom, tl = tmp_path / "m.prom", tmp_path / "t.json"
    serve.main(["--reduced", "--device", "cpu", "--requests", "4",
                "--capacity", "4", "--arrival-every", "0", "--prompt-len",
                "8", "--new-tokens", "4", "--retention-scale", "50",
                "--shards", "2", "--die-ambient", "1=420",
                "--metrics-out", str(prom), "--trace-timeline", str(tl)])
    out = capsys.readouterr().out
    assert "sharding: 2 dies x 2 slots (1 device)" in out
    assert "die 1: slots [2,4) ambient 420 K" in out
    assert "die 0: slots [0,2) ambient 300 K" in out
    assert "telemetry: " in out
    assert "serve_retention_flips_total" in prom.read_text()
    validate_timeline(json.loads(tl.read_text()),
                      "tests/fixtures/timeline.schema.json")
