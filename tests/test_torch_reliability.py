"""The port's retention decay, scrub passes, scrub policies and their
serving integration against the JAX reference (``repro.reliability``).

* Thresholds: ``switching_probability`` and the decay thresholds are
  bit-equal (the port computes the float32 Eq. 14-15 in numpy with the
  reference's XLA ``exp``).
* Decay, ``clear_written``, ``reset_rows`` and ``scrub_tree`` (whole
  leaves and a window at a cursor) are bit-exact: values, masks and
  counts; scrub energies at rtol=1e-5 (float32 sums in another order).
* Serving: the scheduler on the committed trace fixture, with the JAX
  model's prefill/decode behind the port's engine (the ``JaxModel``
  adapter of test_torch_serve.py), at 400 K with periodic scrubbing.
  Tokens, per-request flips and errors, the lifetime counters and the
  table's "scrub" scope are exact; energies at rtol=1e-5.
* A 300 K run with retention on equals the run with retention off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import wer as jwer
from repro.core.priority import Priority as JP
from repro.memory import WritePlan as JPlan
from repro.memory import rng_streams as jstreams
from repro.models import get_model as jmodel
from repro.reliability import LifetimePlan as JLifePlan
from repro.reliability import lifetime as jlife
from repro.reliability import make_scrub_policy as jmake_policy
from repro.reliability import scrub_tree as jscrub_tree
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.workload import TraceSource as JTraceSource
from repro.workload import load_trace as jload_trace
from repro_torch import rng
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import wer as twer
from repro_torch.core.priority import Priority as TP
from repro_torch.core.priority import int_type
from repro_torch.memory import WritePlan as TPlan
from repro_torch.memory import rng_streams as tstreams
from repro_torch.reliability import LifetimePlan as TLifePlan
from repro_torch.reliability import lifetime as tlife
from repro_torch.reliability import make_scrub_policy, scrub_tree
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.workload import TraceSource, load_trace
from test_torch_serve import ARCH, FIXTURE, JaxModel

RTOL = 1e-5
CPU = torch.device("cpu")
DWELL = 1000.0
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _bits_np(x):
    if isinstance(x, torch.Tensor):
        x = x.view(int_type(x.dtype)).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


# ---------------------------------------------------------------------------
# thresholds and RNG streams
# ---------------------------------------------------------------------------

def test_rng_streams_match_the_reference():
    tstreams.validate()
    for name in ("WRITE_LEAF_OFFSET", "RETENTION_OFFSET", "SCRUB_OFFSET",
                 "SCHEDULER_SCRUB_PASS_OFFSET", "INDEX_SPAN"):
        assert getattr(tstreams, name) == getattr(jstreams, name), name
    jby = {s.name: s for s in jstreams.STREAMS}
    for s in tstreams.STREAMS:
        assert tuple(s) == tuple(jby[s.name]), s.name
    with pytest.raises(AssertionError):
        tstreams.validate(tstreams.STREAMS + (tstreams.Stream(
            "clash", tstreams.SCRUB_OFFSET + 5, "step-write-key", ""),))


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_thresholds_are_bit_equal(dt, level):
    for t_k in (300.0, 350.0, 400.0, 420.0):
        for dwell in (1.0, 1000.0, 1e4):
            thr_t = tlife._retention_thresholds(DTYPES[dt][0], TP(level),
                                                t_k, dwell)
            thr_j = np.asarray(jlife._retention_thresholds(
                jnp.dtype(DTYPES[dt][1]), JP(level), t_k, dwell))
            np.testing.assert_array_equal(thr_t, thr_j)
            assert thr_t.dtype == np.uint32
            d = jlife.retention_delta(JP(level), t_k)
            assert tlife.retention_delta(TP(level), t_k) == d
            assert float(twer.switching_probability(dwell, d, 0.0)) == \
                float(jwer.switching_probability(dwell, d, 0.0))


def test_threshold_scale_at_the_serving_temperatures():
    """bf16 LOW mantissa planes at dwell 1000 s: 45,568 at 350 K,
    36,305,920 at 400 K, and every plane 0 at 300 K."""
    def thr(t_k):
        return tlife._retention_thresholds(torch.bfloat16, TP.LOW, t_k,
                                           DWELL)
    assert list(thr(350.0)[:7]) == [45568] * 7
    assert list(thr(400.0)[:7]) == [36305920] * 7
    assert not thr(350.0)[7:].any() and not thr(300.0).any()


# ---------------------------------------------------------------------------
# decay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 19), (3, 5, 11), (1,), (2, 3, 4, 5)],
                         ids=str)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_decay_leaf_is_bit_exact(dt, shape):
    """Real 420 K thresholds and a synthetic vector with large and zero
    planes (element-index hash over the element's own planes)."""
    nbits = 32 if dt == "f32" else 16
    r = np.random.default_rng(len(shape) + nbits)
    x = r.standard_normal(shape).astype(np.float32)
    synth = r.integers(0, 2**31, nbits).astype(np.uint32)
    synth[::3] = 0
    real = tlife._retention_thresholds(DTYPES[dt][0], TP.LOW, 420.0, 1e4)
    for i, thr in enumerate((real, synth)):
        seed = 11 + i
        xt = torch.from_numpy(x).to(DTYPES[dt][0])
        xj = jnp.asarray(x).astype(DTYPES[dt][1])
        dj, mj, nj = jlife._decay_leaf(jax.random.PRNGKey(seed), xj,
                                       jnp.asarray(thr))
        dt_, mt, nt = tlife._decay_leaf(rng.seed_u32(rng.PRNGKey(seed)),
                                        xt, thr)
        np.testing.assert_array_equal(_bits_np(dt_), _bits_np(dj))
        np.testing.assert_array_equal(_bits_np(mt), _bits_np(mj))
        assert int(nt) == int(nj) > 0
        assert int(tlife.popcount(mt)) == int(nt)


AXES = {"slot0": {"k": ("layers", "batch", "kv_seq", "kv_heads",
                        "head_dim"),
                  "v": ("layers", "batch", "kv_seq", "kv_heads",
                        "head_dim")}}


def _cache(seed, shape=(2, 3, 6, 2, 4)):
    r = np.random.default_rng(seed)
    return {"slot0": {"k": r.standard_normal(shape).astype(np.float32),
                      "v": r.standard_normal(shape).astype(np.float32)}}


def _life_plans(ambient_k=420.0, dwell=1e4):
    c = _cache(1)
    jplan = JPlan.for_tree(jax.tree.map(jnp.asarray, c),
                           backend="lanes_ref", axes=AXES)
    tplan = TPlan.for_tree(T.tree_map(torch.from_numpy, c), device=CPU,
                           backend="lanes_ref", axes=AXES)
    return (JLifePlan.for_tree(c, jplan, ambient_k=ambient_k,
                               dwell_s=dwell),
            TLifePlan.for_tree(T.tree_map(torch.from_numpy, c), tplan,
                               ambient_k=ambient_k, dwell_s=dwell))


def _check_state(st, sj, tree_t=None, tree_j=None):
    for mt, mj in zip(st.masks, sj.masks):
        np.testing.assert_array_equal(_bits_np(mt), _bits_np(mj))
    assert int(st.retention_flips) == int(sj.retention_flips)
    assert int(st.decayed_bits()) == int(sj.decayed_bits())
    for f in ("step", "write_count", "scrub_count", "last_write_step",
              "last_scrub_step"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), f)
    if tree_t is not None:
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(_bits_np(tree_t["slot0"][leaf]),
                                          _bits_np(tree_j["slot0"][leaf]))


def _decayed(jl, tl, steps=3, floor=0):
    """Both plans' (tree, state) after ``steps`` decode-style dwells with
    clear_written between them (slot 1 inactive in the second)."""
    c = _cache(2)
    tree_j, tree_t = jax.tree.map(jnp.asarray, c), T.tree_map(
        torch.from_numpy, c)
    sj, st = jl.init_state(tree_j), tl.init_state(tree_t)
    vj, vt = jl.vectors_for(JP(floor)), tl.vectors_for(TP(floor))
    for s in range(steps):
        pos = np.array([s, 7 + s, 2 * s], np.int64)
        act = np.array([True, s != 1, True])
        sj = jl.clear_written(sj, jnp.asarray(pos, jnp.int32),
                              jnp.asarray(act))
        st = tl.clear_written(st, torch.from_numpy(pos),
                              torch.from_numpy(act))
        tree_j, sj = jl.advance(jax.random.PRNGKey(30 + s), tree_j, sj, vj)
        tree_t, st = tl.advance(rng.PRNGKey(30 + s), tree_t, st, vt)
    return tree_t, st, tree_j, sj


@pytest.mark.parametrize("floor", [0, 2])
def test_advance_and_clear_written_are_bit_exact(floor):
    jl, tl = _life_plans()
    tree_t, st, tree_j, sj = _decayed(jl, tl, floor=floor)
    _check_state(st, sj, tree_t, tree_j)
    assert int(st.decayed_bits()) > 0


def test_reset_rows_is_bit_exact():
    jl, tl = _life_plans()
    _, st, _, sj = _decayed(jl, tl)
    st = tl.reset_rows(st, torch.tensor([0, 2]))
    sj = jl.reset_rows(sj, jnp.asarray([0, 2], jnp.int32))
    _check_state(st, sj)
    assert all(not _bits_np(m[:, [0, 2]]).any() for m in st.masks)


def test_immortal_plan_and_300k_are_identities():
    jl, tl = _life_plans(ambient_k=300.0, dwell=DWELL)
    tree_t, st, _, _ = _decayed(jl, tl)
    c = T.tree_map(torch.from_numpy, _cache(2))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(tree_t),
                                                 T.leaves(c)))
    assert int(st.retention_flips) == 0 and int(st.decayed_bits()) == 0
    _, tl0 = _life_plans(dwell=0.0)
    s0 = tl0.init_state(c)
    assert tl0.advance(rng.PRNGKey(1), c, s0) == (c, s0)


# ---------------------------------------------------------------------------
# scrub passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols,cursor", [(None, 0), (2, 0), (4, 4)],
                         ids=["whole", "window0", "window_wraps"])
def test_scrub_tree_is_bit_exact(cols, cursor):
    jl, tl = _life_plans()
    tree_t, st, tree_j, sj = _decayed(jl, tl)
    wt = tl.plan.vectors_for(TP.MID)
    wj = jl.plan.vectors_for(JP.MID)
    out_t, st2, acc_t = scrub_tree(rng.PRNGKey(5), tree_t, st, tl, wt,
                                   cols=cols, cursor=cursor)
    out_j, sj2, acc_j = jscrub_tree(
        jax.random.PRNGKey(5), tree_j, sj, jl, wj, cols=cols,
        cursor=jnp.asarray(cursor, jnp.int32))
    _check_state(st2, sj2, out_t, out_j)
    h, hj = acc_t.host_dict(), acc_j.host_dict()
    for k in ("flips01", "flips10", "bit_errors", "bits_total"):
        assert h[k] == hj[k], k
    assert h["flips01"] + h["flips10"] > 0
    np.testing.assert_allclose(h["energy_pj"], hj["energy_pj"], rtol=RTOL)
    # the scrub only ever lowers the decay record
    assert int(st2.decayed_bits()) < int(st.decayed_bits())


def test_scrub_tree_respects_enabled():
    jl, tl = _life_plans()
    tree_t, st, _, _ = _decayed(jl, tl)
    out, st2, acc = scrub_tree(rng.PRNGKey(5), tree_t, st, tl,
                               tl.plan.vectors_for(TP.LOW),
                               enabled=(True, False))
    assert torch.equal(out["slot0"]["v"], tree_t["slot0"]["v"])
    assert torch.equal(st2.masks[1], st.masks[1])
    assert st2.scrub_count.tolist() == [1, 0]


# ---------------------------------------------------------------------------
# scrub policies (the reference's TestScrubPolicies, on the port's copy)
# ---------------------------------------------------------------------------

LEVELS = (TP.HIGH, TP.MID, TP.LOW, None)


def test_periodic_cadence_and_idle_opportunism():
    p = make_scrub_policy("periodic", interval=8)
    assert p.plan_pass(4, LEVELS) is None
    assert p.plan_pass(4, LEVELS, idle=True) is not None
    p.record(4)
    assert p.plan_pass(8, LEVELS) is None
    assert p.plan_pass(12, LEVELS) == (True, True, True, False)


def test_wear_aware_backs_off():
    p = make_scrub_policy("wear_aware", interval=4)
    due, clock = [], 0
    for _ in range(3):
        while p.plan_pass(clock, LEVELS) is None:
            clock += 1
        due.append(clock)
        p.record(clock)
    gaps = np.diff([0] + due)
    assert list(gaps) == sorted(gaps) and gaps[-1] > gaps[0]


def test_quality_floor_lets_low_rot():
    p = make_scrub_policy("quality_floor", interval=8)
    assert p.plan_pass(2, LEVELS) == (True, False, False, False)
    assert p.plan_pass(3, LEVELS) is None
    assert p.plan_pass(8, LEVELS) == (True, True, False, False)
    assert p.plan_pass(32, LEVELS) == (True, True, True, False)


def test_none_never_scrubs_and_unknown_raises():
    p = make_scrub_policy("none", interval=1)
    assert p.plan_pass(10**6, LEVELS, idle=True) is None
    with pytest.raises(KeyError):
        make_scrub_policy("hourly")


@pytest.mark.parametrize("name", ["periodic", "wear_aware", "quality_floor"])
def test_policy_decisions_match_the_reference(name):
    """Every decision over a stream of clocks with idle flags, and the
    reset of the pass history, equal the reference policy's."""
    tp, jp = make_scrub_policy(name, 4), jmake_policy(name, 4)
    jlevels = tuple(None if lvl is None else JP(int(lvl)) for lvl in LEVELS)
    r = np.random.default_rng(3)
    for rnd in range(2):
        for clock in range(60):
            idle = bool(r.random() < 0.3)
            a = tp.plan_pass(clock, LEVELS, idle=idle)
            b = jp.plan_pass(clock, jlevels, idle=idle)
            assert a == b, (rnd, clock)
            if a is not None:
                tp.record(clock)
                jp.record(clock)
        tp.reset()
        jp.reset()
        assert tp.describe() == jp.describe()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    return jmodel(jget(ARCH).reduced()).init(jax.random.PRNGKey(0))


def _serve_pair(jparams, *, ambient_k=400.0, cols=0, interval=2,
                schedule=None):
    """(port report, reference report) for the fixture trace at capacity
    2 with periodic scrubbing; the port runs the JAX model's numerics."""
    trace = jload_trace(FIXTURE)
    kw = dict(max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
              backend="lanes_ref", retention_scale=DWELL,
              ambient_k=ambient_k)
    jcfg = jget(ARCH).reduced()
    ref = JSched(JEngine(jcfg, JServeConfig(**kw), params=jparams),
                 capacity=2, ambient_schedule=schedule,
                 scrub_policy=jmake_policy("periodic", interval, cols)
                 ).run(JTraceSource(trace, jcfg))
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, ServeConfig(**kw), jparams, device="cpu",
                        api=JaxModel(cfg))
    rep = ContinuousScheduler(
        eng, capacity=2, ambient_schedule=schedule,
        scrub_policy=make_scrub_policy("periodic", interval, cols)).run(
            TraceSource(load_trace(FIXTURE), cfg, CPU))
    return rep, ref


def _check_serve(rep, ref):
    for k in ("clock_steps", "decode_steps", "bursts"):
        assert rep[k] == ref[k], k
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("tokens", "flips", "errors", "quality", "completed_step"):
            assert p[k] == r[k], (rid, k)
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=RTOL)
    lt, lj = rep["lifetime"], ref["lifetime"]
    assert set(lt) == set(lj)
    for k in ("retention_flips", "residual_decayed_bits", "scrub_passes",
              "scrub_policy", "ambient_k", "dwell_s_per_step"):
        assert lt[k] == lj[k], k
    for k in ("write_energy_pj", "scrub_energy_pj", "lifetime_energy_pj"):
        np.testing.assert_allclose(lt[k], lj[k], rtol=RTOL)
    assert lt["remap_energy_pj"] == lj["remap_energy_pj"] == 0.0
    assert lt["lifetime_energy_pj"] == (lt["write_energy_pj"]
                                        + lt["scrub_energy_pj"])
    for s in ("kv_prefill", "kv_decode", "kv_scrub"):
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert rep["streams"][s][k] == ref["streams"][s][k], (s, k)
    assert rep["extent_table"]["scopes"] == ref["extent_table"]["scopes"]


@pytest.mark.parametrize("cols", [0, 4], ids=["whole", "window"])
def test_scheduler_with_retention_and_scrub_is_exact(jparams, cols):
    rep, ref = _serve_pair(jparams, cols=cols)
    _check_serve(rep, ref)
    lt = rep["lifetime"]
    assert lt["scrub_passes"] > 0 and lt["retention_flips"] > 0
    assert lt["scrub_energy_pj"] > 0
    assert lt["residual_decayed_bits"] < lt["retention_flips"]
    assert rep["extent_table"]["scopes"]["scrub"]["hits"] > 0


def test_ambient_schedule_splits_a_burst(jparams):
    """A breakpoint at step 3 (300 K -> 420 K) ends a burst there, and the
    decay after it runs at the new temperature, as in the reference."""
    rep, ref = _serve_pair(jparams, ambient_k=300.0,
                           schedule=[(0, 300.0), (3, 420.0)])
    _check_serve(rep, ref)
    assert rep["bursts"] > 5 and rep["lifetime"]["retention_flips"] > 0


def test_300k_retention_equals_retention_off(jparams):
    """The port's own model: retention at 300 K with scrubbing changes no
    token and no write statistic, and samples no flip."""
    tp = params_from_jax(jax.tree.map(np.asarray, jparams))
    cfg = get_config(ARCH).reduced()
    trace = load_trace(FIXTURE)

    def run(**kw):
        eng = ServingEngine(cfg, ServeConfig(
            max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
            **kw), tp, device="cpu")
        sch = ContinuousScheduler(
            eng, capacity=2, scrub_policy=make_scrub_policy(
                "periodic", 2) if kw else None)
        return sch.run(TraceSource(trace, cfg, CPU))

    off, on = run(), run(retention_scale=DWELL, ambient_k=300.0)
    for rid, r in off["requests"].items():
        assert on["requests"][rid] == r, rid
    for s in ("kv_prefill", "kv_decode"):
        assert on["streams"][s] == off["streams"][s], s
    lt = on["lifetime"]
    assert lt["retention_flips"] == lt["residual_decayed_bits"] == 0
    assert lt["scrub_passes"] > 0 and lt["scrub_energy_pj"] == 0.0


def test_generate_retention_report_matches_reference(jparams):
    cfg = get_config(ARCH).reduced()
    toks = np.random.default_rng(4).integers(0, 256, (2, 8))
    kw = dict(max_seq=16, max_new_tokens=6, retention_scale=DWELL,
              ambient_k=420.0)
    jt, jrep = JEngine(jget(ARCH).reduced(), JServeConfig(**kw),
                       params=jparams).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)})
    tt, trep = ServingEngine(cfg, ServeConfig(**kw), jparams, device="cpu",
                             api=JaxModel(cfg)).generate(
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert trep["retention"] == jrep["retention"]
    assert trep["retention"]["flips"] > 0


def test_launcher_scrubs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--reduced", "--device", "cpu", "--trace", FIXTURE,
                "--capacity", "2", "--ambient-k", "400",
                "--retention-scale", "1000", "--scrub-policy", "periodic",
                "--scrub-interval", "2"])
    out = capsys.readouterr().out
    assert "served 4 requests in 8 steps" in out
    assert "lifetime ledger @ 400 K (dwell 1000 s/step, policy periodic)" \
        in out
    assert "[scrub]" in out and "scrub passes" in out
