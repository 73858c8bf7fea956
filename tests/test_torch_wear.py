"""The port's physical addressing layer, endurance wear and wear leveling
against the JAX reference (``repro.memory.address``,
``repro.reliability.wear`` and their hooks in the plan, the lifetime
state, the scrub pass, the engine and the scheduler).

* The address functions are exact on numpy-seeded inputs.
* ``write`` / ``write_columns`` with ``addr=``: identity shifts with no
  worn rows equal ``addr=None`` bit for bit on every CPU backend; random
  shifts and worn maps equal the reference's ``lanes_ref`` in stored
  words, flips and errors (the lost bits of stuck-at rows included),
  energy at rtol=1e-5 (float32 sums in another order).
* The row-group bookkeeping (``record_*``, ``worn_groups``,
  ``slot_scores``, ``decayed_bits_by_slot``) and ``scrub_tree(addr=)``
  are exact: words, residual masks and counters.
* The wear policies decide as the reference's do, and ``alloc(scores=)``
  orders slots as the reference's pool does.
* Serving the trace fixture with the reference's model numerics (the
  ``JaxModel`` adapter of test_torch_serve.py): identity wear equals wear
  off; rotation, an endurance budget, the prefix cache and a resumed
  ``wear_state`` are exact in tokens, streams and the ``wear`` summary,
  with remap energies at rtol=1e-6 (host sums of the level table's
  prices: the reference may hold the table whose energies differ in the
  last bit, ROADMAP §C).

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
from repro.memory import WritePlan as JPlan
from repro.memory import address as jaddr
from repro.reliability import LifetimePlan as JLifePlan
from repro.reliability import make_scrub_policy as jmake_scrub_policy
from repro.reliability import make_wear_policy as jmake_wear_policy
from repro.reliability import scrub_tree as jscrub_tree
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.serve.slots import SlotPool as JSlotPool
from repro.workload import TraceSource as JTraceSource
from repro.workload import load_trace as jload_trace
from repro_torch import rng
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.priority import Priority as TP
from repro_torch.core.priority import int_type
from repro_torch.memory import WritePlan as TPlan
from repro_torch.memory import address as taddr
from repro_torch.reliability import LifetimePlan as TLifePlan
from repro_torch.reliability import (make_scrub_policy, make_wear_policy,
                                     scrub_tree)
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.serve.slots import SlotPool
from repro_torch.workload import TraceSource, load_trace
from test_torch_serve import ARCH, FIXTURE, JaxModel, _shared_prefix_trace

CPU = torch.device("cpu")
RTOL = 1e-5
#: host sums of level-table prices (remap and prefix pricing)
RTOL_TABLE = 1e-6


def _np(x):
    """A tensor or array as numpy values (bit views for floats)."""
    if isinstance(x, torch.Tensor):
        if x.dtype.is_floating_point:
            x = x.view(int_type(x.dtype))
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.kind == "f" or a.dtype == jnp.bfloat16:
        a = a.view({2: np.int16, 4: np.int32}[a.itemsize])
    return a


def _same(a, b, what=""):
    np.testing.assert_array_equal(_np(a).astype(np.int64),
                                  _np(b).astype(np.int64), what)


def _seed(*parts):
    """A fixed integer seed from small ints (never ``hash()``)."""
    s = 0
    for p in parts:
        s = s * 1009 + int(p)
    return s


# ---------------------------------------------------------------------------
# the address functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group_cols", [1, 4, 8])
@pytest.mark.parametrize("shift", [0, 1, 5, 16, 1000])
@pytest.mark.parametrize("C", [7, 16, 64])
def test_address_functions_are_exact(C, shift, group_cols):
    r = np.random.default_rng(_seed(C, shift, group_cols))
    B = 3
    jspec = jaddr.AddressSpec(group_cols=group_cols)
    tspec = taddr.AddressSpec(group_cols=group_cols)
    assert tspec.col_groups(C) == jspec.col_groups(C)
    shape = (2, B, C, 2)
    assert (tspec.n_groups(shape, 2, 1) == jspec.n_groups(shape, 2, 1)
            and tspec.n_groups(shape, None, 1)
            == jspec.n_groups(shape, None, 1))
    G = jspec.n_groups(shape, 2, 1)
    js, ts = jnp.asarray(shift, jnp.int32), torch.tensor(shift)
    cols = np.arange(C)
    p_t = taddr.phys_col(torch.from_numpy(cols), ts, C)
    p_j = jaddr.phys_col(jnp.asarray(cols, jnp.int32), js, C)
    _same(p_t, p_j)
    assert sorted(p_t.tolist()) == list(range(C))
    _same(taddr.logical_col(p_t, ts, C), cols)
    pos = r.integers(0, 3 * C, B)
    _same(taddr.column_group_ids(torch.from_numpy(pos), ts, C, tspec),
          jaddr.column_group_ids(jnp.asarray(pos, jnp.int32), js, C, jspec))
    worn = r.random(G) < 0.4
    _same(taddr.worn_slot_mask(torch.from_numpy(worn),
                               torch.from_numpy(pos), ts, C, tspec),
          jaddr.worn_slot_mask(jnp.asarray(worn), jnp.asarray(
              pos, jnp.int32), js, C, jspec))
    for ax in (2, None):
        wt = taddr.worn_element_mask(torch.from_numpy(worn), ts, shape, ax,
                                     1, tspec)
        wj = jaddr.worn_element_mask(jnp.asarray(worn), js, shape, ax, 1,
                                     jspec)
        _same(wt.expand(shape), jnp.broadcast_to(wj, shape))
    idx = r.permutation(B)[:2]
    start = r.integers(0, C, 2)
    end = start + r.integers(0, C, 2)
    _same(taddr.slot_window_group_counts(
        torch.from_numpy(idx), torch.from_numpy(start),
        torch.from_numpy(end), ts, C, G, tspec),
        jaddr.slot_window_group_counts(
            jnp.asarray(idx, jnp.int32), jnp.asarray(start, jnp.int32),
            jnp.asarray(end, jnp.int32), js, C, G, jspec))
    cursor, width = int(r.integers(0, C)), int(r.integers(1, C + 1))
    _same(taddr.window_group_counts(cursor, width, C, B, G, tspec, CPU),
          jaddr.window_group_counts(jnp.asarray(cursor, jnp.int32), width,
                                    C, B, G, jspec))


def test_address_state_identity_and_rotate():
    st = taddr.AddressState.identity(3, CPU)
    sj = jaddr.AddressState.identity(3)
    rot = np.array([True, False, True])
    for step in (1, 4, 4):
        st = st.rotate(torch.from_numpy(rot), step)
        sj = sj.rotate(jnp.asarray(rot), step)
        _same(st.shifts, sj.shifts)
        _same(st.rotations, sj.rotations)
    assert st.shifts.tolist() == [9, 0, 9]


# ---------------------------------------------------------------------------
# plans: a ring leaf of each level and one approximate leaf with no ring
# ---------------------------------------------------------------------------

C_RING = 16
AXES = {"flat": {"v": ("layers", "batch", "x")},
        "slot0": {"k": ("layers", "batch", "kv_seq", "kv_heads",
                        "head_dim"),
                  "v": ("layers", "batch", "kv_seq", "kv_heads",
                        "head_dim")}}


def _cache(seed, C=C_RING):
    r = np.random.default_rng(seed)
    return {"flat": {"v": r.standard_normal((2, 3, 5)).astype(np.float32)},
            "slot0": {
                "k": r.standard_normal((2, 3, C, 2, 4)).astype(np.float32),
                "v": r.standard_normal((2, 3, C, 2, 4)).astype(np.float32)}}


def _trees(c):
    return (jax.tree.map(jnp.asarray, c), T.tree_map(torch.from_numpy, c))


def _plans(group_cols=4, budget=0, backend="lanes_ref", spec=True,
           dwell=0.0, ambient_k=300.0):
    """(reference plan, port plan, reference lifetime plan, port lifetime
    plan) over ``_cache``'s structure."""
    cj, ct = _trees(_cache(0))
    js = jaddr.AddressSpec(group_cols, budget) if spec else None
    ts = taddr.AddressSpec(group_cols, budget) if spec else None
    jp = JPlan.for_tree(cj, backend=backend, axes=AXES, address_spec=js)
    tp = TPlan.for_tree(ct, device=CPU, backend=backend, axes=AXES,
                        address_spec=ts)
    return (jp, tp,
            JLifePlan.for_tree(cj, jp, ambient_k=ambient_k, dwell_s=dwell),
            TLifePlan.for_tree(ct, tp, ambient_k=ambient_k, dwell_s=dwell))


def test_rotate_moves_ring_leaves_only():
    jp, tp, _, _ = _plans()
    assert tp.rotatable() == jp.rotatable() == (False, True, True)
    a = tp.identity_address().rotate(torch.tensor(tp.rotatable()), 3)
    assert a.shifts.tolist() == [0, 3, 3]
    assert a.rotations.tolist() == [0, 1, 1]


def test_n_row_groups_and_init_state():
    for group_cols in (1, 4, 5):
        jp, tp, jl, tl = _plans(group_cols)
        cj, ct = _trees(_cache(0))
        assert tl.n_row_groups(ct) == jl.n_row_groups(cj)
        st, sj = tl.init_state(ct), jl.init_state(cj)
        _same(st.row_write_count, sj.row_write_count)
        _same(st.row_scrub_count, sj.row_scrub_count)
    _, _, jl, tl = _plans(spec=False)
    assert tl.init_state(ct).row_write_count.shape == (3, 1)


def _shifts_worn(seed, tl, ct):
    """Random (shifts, worn) operands, as torch and as jnp."""
    r = np.random.default_rng(seed)
    shifts = r.integers(0, 40, 3)
    worn = r.random((3, tl.n_row_groups(ct))) < 0.3
    return ((torch.from_numpy(shifts), torch.from_numpy(worn)),
            (jnp.asarray(shifts, jnp.int32), jnp.asarray(worn)))


def _check_write(out_t, st, out_j, sj):
    for a, b in zip(T.leaves(out_t), jax.tree.leaves(out_j)):
        _same(a, b)
    h, hj = st.host_dict(), sj.host_dict()
    for k in ("flips01", "flips10", "bit_errors", "bits_total"):
        assert h[k] == hj[k], k
    np.testing.assert_allclose(h["energy_pj"], hj["energy_pj"], rtol=RTOL)
    return h


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_stuck_at_writes_match_the_reference(seed):
    """Random shifts and worn maps, full-tree and column writes: stored
    words, flips, errors (lost bits included) exact."""
    jp, tp, _, tl = _plans()
    cj, ct = _trees(_cache(10 + seed))
    nj, nt = _trees(_cache(20 + seed))
    (t_sh, t_w), (j_sh, j_w) = _shifts_worn(seed, tl, ct)
    key_t, key_j = rng.PRNGKey(seed), jax.random.PRNGKey(seed)
    vt, vj = tp.vectors_for(TP.LOW), jp.vectors_for()
    out_t, st = tp.write(key_t, ct, nt, vt, addr=(t_sh, t_w))
    out_j, sj = jp.write(key_j, cj, nj, vj, addr=(j_sh, j_w))
    h = _check_write(out_t, st, out_j, sj)
    # the worn rows kept their old bits, and lost more than the driver
    _, s0 = tp.write(key_t, ct, nt, vt)
    assert h["bits_written"] < s0.host_dict()["bits_written"]
    pos = np.array([3, 17, 31]) + seed
    out_t, st = tp.write_columns(key_t, ct, nt, torch.from_numpy(pos), vt,
                                 addr=(t_sh, t_w))
    out_j, sj = jp.write_columns(key_j, cj, nj, jnp.asarray(pos, jnp.int32),
                                 vj, addr=(j_sh, j_w))
    _check_write(out_t, st, out_j, sj)


@pytest.mark.parametrize("backend", ["lanes_ref", "oracle", "exact"])
def test_identity_address_equals_no_address_layer(backend):
    _, tp, _, tl = _plans(budget=100, backend=backend)
    _, tp0, _, _ = _plans(backend=backend, spec=False)
    _, ct = _trees(_cache(4))
    _, nt = _trees(_cache(5))
    st0 = tl.init_state(ct)
    addr = (tp.identity_address().shifts, tl.worn_groups(st0))
    assert not addr[1].any()
    key = rng.PRNGKey(7)
    vt = tp.vectors_for(TP.LOW)
    pos = torch.tensor([5, 11, 5])
    for call in ("write", "write_columns"):
        args = (key, ct, nt) + ((pos,) if call == "write_columns" else ())
        a, sa = getattr(tp, call)(*args, vt, addr=addr)
        b, sb = getattr(tp0, call)(*args, tp0.vectors_for(TP.LOW))
        for x, y in zip(T.leaves(a), T.leaves(b)):
            assert torch.equal(x.view(int_type(x.dtype)),
                               y.view(int_type(y.dtype)))
        assert sa.host_dict() == sb.host_dict(), call


def test_migration_cost_matches_the_reference():
    jp, tp, _, _ = _plans(group_cols=4)
    cj, ct = _trees(_cache(0))
    pt, bt = tp.migration_cost(ct)
    pj, bj = jp.migration_cost(cj)
    assert bt == bj > 0
    np.testing.assert_allclose(pt, pj, rtol=RTOL_TABLE)


# ---------------------------------------------------------------------------
# the row-group bookkeeping
# ---------------------------------------------------------------------------

def _wear_states(tl, jl, ct, cj, budget_steps=6, seed=0):
    """Both states after a few column writes, an admission booking and a
    migration, through random shifts."""
    r = np.random.default_rng(seed)
    st, sj = tl.init_state(ct), jl.init_state(cj)
    for s in range(budget_steps):
        pos = r.integers(0, 2 * C_RING, 3)
        act = r.random(3) < 0.8
        sh = r.integers(0, C_RING, 3)
        st = tl.record_column_write(st, ct, torch.from_numpy(pos),
                                    torch.from_numpy(act),
                                    torch.from_numpy(sh))
        sj = jl.record_column_write(sj, cj, jnp.asarray(pos, jnp.int32),
                                    jnp.asarray(act),
                                    jnp.asarray(sh, jnp.int32))
    idx, start = np.array([2, 0]), np.array([0, 3])
    end, sh = np.array([9, 14]), np.array([0, 5, 11])
    st = tl.record_admission_write(st, ct, *(torch.from_numpy(a) for a in
                                             (idx, start, end, sh)))
    sj = jl.record_admission_write(sj, cj, *(jnp.asarray(a, jnp.int32)
                                             for a in (idx, start, end,
                                                       sh)))
    for gap, cols in ((0, 4), (13, 4), (30, 40)):
        st = tl.record_migration(st, ct, gap, cols)
        sj = jl.record_migration(sj, cj, gap, cols)
    return st, sj


@pytest.mark.parametrize("group_cols,budget", [(4, 3), (5, 2), (1, 1)])
def test_record_functions_and_worn_groups_are_exact(group_cols, budget):
    jp, tp, jl, tl = _plans(group_cols, budget)
    cj, ct = _trees(_cache(0))
    st, sj = _wear_states(tl, jl, ct, cj, seed=group_cols)
    _same(st.row_write_count, sj.row_write_count)
    _same(st.row_wear(), sj.row_wear())
    wt, wj = tl.worn_groups(st), jl.worn_groups(sj)
    _same(wt, wj)
    assert wt.any() and not wt.all()
    # an unbounded budget is a static None, as in the reference
    _, _, jl0, tl0 = _plans(group_cols, 0)
    assert tl0.worn_groups(st) is None and jl0.worn_groups(sj) is None


def _decayed_pair(tl, jl, steps=3):
    """Trees and states after ``steps`` decode-style dwells at 420 K."""
    cj, ct = _trees(_cache(2))
    st, sj = _wear_states(tl, jl, ct, cj)
    vt, vj = tl.vectors_for(TP.LOW), jl.vectors_for()
    for s in range(steps):
        ct, st = tl.advance(rng.PRNGKey(30 + s), ct, st, vt)
        cj, sj = jl.advance(jax.random.PRNGKey(30 + s), cj, sj, vj)
    return ct, st, cj, sj


def test_slot_scores_and_decay_by_slot_are_exact():
    jp, tp, jl, tl = _plans(4, 3, dwell=1e4, ambient_k=420.0)
    ct, st, cj, sj = _decayed_pair(tl, jl)
    assert int(st.decayed_bits()) > 0
    _same(tl.decayed_bits_by_slot(st), jl.decayed_bits_by_slot(sj))
    np.testing.assert_array_equal(tl.slot_scores(st, ct).numpy(),
                                  np.asarray(jl.slot_scores(sj, cj)))


@pytest.mark.parametrize("cols,cursor", [(None, 0), (4, 0), (6, 13)],
                         ids=["whole", "window0", "window_wraps"])
def test_scrub_through_the_remap_is_exact(cols, cursor):
    """Shifts and worn rows: the window walks physical rows, stuck rows
    keep their decay; words, masks, row_scrub_count bit-exact."""
    jp, tp, jl, tl = _plans(4, 10, dwell=1e4, ambient_k=420.0)
    ct, st, cj, sj = _decayed_pair(tl, jl)
    wt, wj = tl.worn_groups(st), jl.worn_groups(sj)
    assert wt.any() and not wt.all()
    sh = np.array([0, 5, 11])
    addr_t = (torch.from_numpy(sh), wt)
    addr_j = (jnp.asarray(sh, jnp.int32), wj)
    out_t, st2, acc_t = scrub_tree(rng.PRNGKey(5), ct, st, tl,
                                   tp.vectors_for(TP.MID), cols=cols,
                                   cursor=cursor, addr=addr_t)
    out_j, sj2, acc_j = jscrub_tree(
        jax.random.PRNGKey(5), cj, sj, jl, jp.vectors_for(TP.MID),
        cols=cols, cursor=jnp.asarray(cursor, jnp.int32), addr=addr_j)
    for a, b in zip(T.leaves(out_t), jax.tree.leaves(out_j)):
        _same(a, b)
    for mt, mj in zip(st2.masks, sj2.masks):
        _same(mt, mj)
    for f in ("scrub_count", "row_scrub_count", "row_write_count",
              "last_scrub_step"):
        _same(getattr(st2, f), getattr(sj2, f), f)
    h, hj = acc_t.host_dict(), acc_j.host_dict()
    for k in ("flips01", "flips10", "bit_errors", "bits_total"):
        assert h[k] == hj[k], k
    assert h["flips01"] + h["flips10"] > 0
    np.testing.assert_allclose(h["energy_pj"], hj["energy_pj"], rtol=RTOL)
    assert int(st2.decayed_bits()) < int(st.decayed_bits())


def test_identity_scrub_equals_no_address_layer():
    _, tp, _, tl = _plans(4, 0, dwell=1e4, ambient_k=420.0)
    _, tp0, _, tl0 = _plans(spec=False, dwell=1e4, ambient_k=420.0)
    ct = T.tree_map(torch.from_numpy, _cache(2))
    s, s0 = tl.init_state(ct), tl0.init_state(ct)
    for k in range(2):
        ct, s = tl.advance(rng.PRNGKey(k), ct, s)
    c0 = T.tree_map(torch.from_numpy, _cache(2))
    for k in range(2):
        c0, s0 = tl0.advance(rng.PRNGKey(k), c0, s0)
    a, sa, ta = scrub_tree(rng.PRNGKey(9), ct, s, tl, tp.vectors_for(TP.LOW),
                           cols=6, cursor=13,
                           addr=(tp.identity_address().shifts, None))
    b, sb, tb = scrub_tree(rng.PRNGKey(9), c0, s0, tl0,
                           tp0.vectors_for(TP.LOW), cols=6, cursor=13)
    for x, y in zip(T.leaves(a), T.leaves(b)):
        _same(x, y)
    for x, y in zip(sa.masks, sb.masks):
        _same(x, y)
    assert ta.host_dict() == tb.host_dict()


# ---------------------------------------------------------------------------
# host policies and the slot pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rotate", "none"])
def test_wear_policies_match_the_reference(name):
    r = np.random.default_rng(11)
    kw = dict(check_interval=2, rotate_step=4, hot_row_wear=5)
    tp, jp = make_wear_policy(name, **kw), jmake_wear_policy(name, **kw)
    assert (tp.name, tp.check_interval, tp.rotate_step) == \
        (jp.name, jp.check_interval, jp.rotate_step)
    wear = np.zeros((3, 8), np.int64)
    decided = 0
    for rnd in range(3):
        wear = wear + r.integers(0, 3, wear.shape) * 10 * rnd
        tp.rebase(wear)
        jp.rebase(wear.astype(np.int32))
        for clock in range(1, 40):
            wear = wear + r.integers(0, 2, wear.shape)
            a = tp.plan_rotation(clock, wear)
            b = jp.plan_rotation(clock, wear.astype(np.int32))
            assert a == b, (rnd, clock)
            if a:
                decided += 1
                tp.record(clock, wear)
                jp.record(clock, wear.astype(np.int32))
            assert (tp.rotations, tp.last_rotation) == \
                (jp.rotations, jp.last_rotation)
        tp.reset()
        jp.reset()
    assert (decided > 0) == (name == "rotate")
    with pytest.raises(KeyError):
        make_wear_policy("bogus")


class _NoCache:
    """The one ModelApi method the pools call."""

    def init_cache(self, capacity, max_seq, device=None):
        return {}


@pytest.mark.parametrize("case", range(6))
def test_alloc_with_scores_matches_the_reference(case):
    r = np.random.default_rng(100 + case)
    cap = 6
    tpool = SlotPool(_NoCache(), cap, 8, CPU)
    jpool = JSlotPool(_NoCache(), cap, 8)
    taken = [i for i in range(cap) if r.random() < 0.3]
    blocked = int(r.integers(0, cap)) if case % 2 else None
    for pool in (tpool, jpool):
        pool._free = [i for i in pool._free if i not in taken]
        if blocked is not None:
            pool.col_refs[blocked] += 1
    scores = (np.full(cap, 2.5) if case == 0
              else r.integers(0, 3, cap).astype(np.float32))
    exclude = [] if case < 3 else [int(i) for i in
                                   r.permutation(cap)[:1]]
    n = min(2, tpool.allocatable(exclude))
    a = tpool.alloc(n, scores=scores, exclude=exclude)
    b = jpool.alloc(n, scores=scores, exclude=exclude)
    assert a == b
    assert sorted(tpool._free) == sorted(jpool._free)
    if case == 0:
        # a uniform score vector gives the default order exactly
        plain = SlotPool(_NoCache(), cap, 8, CPU)
        plain._free = [i for i in plain._free if i not in taken]
        assert plain.alloc(n) == a


# ---------------------------------------------------------------------------
# serving through the adapter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    from repro.models import get_model as jmodel
    return jmodel(jget(ARCH).reduced()).init(jax.random.PRNGKey(0))


WEAR = dict(wear_policy="rotate", remap_group_cols=4)
ROTATE = dict(check_interval=2, rotate_step=4, hot_row_wear=2)


def _serve_pair(jparams, path=FIXTURE, policy=None, scrub=None, resume=False,
                **kw):
    """(port report, reference report) for the trace at ``path``
    (capacity 2), ServeConfig ``kw``, wear policy kwargs ``policy`` and
    periodic scrub (interval, cols) ``scrub``. ``resume`` serves the
    trace twice on one scheduler, the second run from the first's
    ``wear_state()``, and returns the second reports."""
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    kw = dict(backend="lanes_ref", **kw)

    def scfg(cls, trace):
        return cls(max_seq=trace.max_seq(),
                   max_new_tokens=trace.max_new_tokens(), **kw)

    jtrace, trace = jload_trace(path), load_trace(path)
    jsch = JSched(JEngine(jcfg, scfg(JServeConfig, jtrace), params=jparams),
                  capacity=2,
                  scrub_policy=jmake_scrub_policy("periodic", *scrub)
                  if scrub else None,
                  wear_policy=jmake_wear_policy("rotate", **policy)
                  if policy else None)
    tsch = ContinuousScheduler(
        ServingEngine(cfg, scfg(ServeConfig, trace), jparams, device="cpu",
                      api=JaxModel(cfg)), capacity=2,
        scrub_policy=make_scrub_policy("periodic", *scrub)
        if scrub else None,
        wear_policy=make_wear_policy("rotate", **policy) if policy else None)
    ref = jsch.run(JTraceSource(jtrace, jcfg))
    rep = tsch.run(TraceSource(trace, cfg, CPU))
    if resume:
        snap = tsch.wear_state()
        for k, v in jsch.wear_state().items():
            _same(snap[k], v, k)
        ref = jsch.run(JTraceSource(jtrace, jcfg),
                       wear_state=jax.tree.map(np.asarray,
                                               jsch.wear_state()))
        rep = tsch.run(TraceSource(trace, cfg, CPU),
                       wear_state={k: v.clone() for k, v in snap.items()})
        for k, v in jsch.wear_state().items():
            _same(tsch.wear_state()[k], v, k)
    return rep, ref


def _check_serve(rep, ref):
    for k in ("clock_steps", "decode_steps", "bursts"):
        assert rep[k] == ref[k], k
    assert sorted(rep["requests"]) == sorted(ref["requests"])
    for rid, r in ref["requests"].items():
        p = rep["requests"][rid]
        for k in ("tokens", "slot", "flips", "errors", "quality",
                  "completed_step"):
            assert p[k] == r[k], (rid, k)
        np.testing.assert_allclose(p["energy_pj"], r["energy_pj"],
                                   rtol=RTOL)
    assert sorted(rep["streams"]) == sorted(ref["streams"])
    for s, r in ref["streams"].items():
        for k in ("bits_written", "bits_total", "bit_errors",
                  "soft_strikes"):
            assert rep["streams"][s][k] == r[k], (s, k)
        rtol = RTOL_TABLE if s in ("kv_remap", "kv_prefix_cow") else RTOL
        np.testing.assert_allclose(rep["streams"][s]["energy_pj"],
                                   r["energy_pj"], rtol=rtol)
    w, wj = rep["wear"], ref["wear"]
    assert set(w) == set(wj)
    for k in ("policy", "rotations", "max_group_wear", "worn_groups",
              "endurance_budget", "group_cols"):
        assert w[k] == wj[k], k
    np.testing.assert_allclose(w["remap_energy_pj"], wj["remap_energy_pj"],
                               rtol=RTOL_TABLE)
    lt, lj = rep["lifetime"], ref["lifetime"]
    assert set(lt) == set(lj)
    for k in ("retention_flips", "residual_decayed_bits", "scrub_passes"):
        assert lt[k] == lj[k], k
    assert lt["remap_energy_pj"] == w["remap_energy_pj"]
    assert rep["extent_table"]["scopes"] == ref["extent_table"]["scopes"]


def _all_low_trace(path):
    """The fixture with every request's quality hint set to LOW: no HIGH
    admission, so wear-aware placement never moves a request."""
    lines = []
    for line in open(FIXTURE):
        d = json.loads(line)
        if "quality" in d:
            d["quality"] = "low"
        lines.append(json.dumps(d) + "\n")
    path.write_text("".join(lines))
    return str(path)


def test_identity_wear_equals_wear_off(jparams, tmp_path):
    """The layer on (rotate, checked every 2 steps, a hot-row level no
    group reaches) over LOW traffic: the tokens and the write streams
    equal the wear-off run, and the run equals the reference."""
    path = _all_low_trace(tmp_path / "low.jsonl")
    identity = dict(ROTATE, hot_row_wear=10**6)
    rep, ref = _serve_pair(jparams, path=path, policy=identity, **WEAR)
    _check_serve(rep, ref)
    assert rep["wear"]["rotations"] == 0
    assert rep["wear"]["remap_energy_pj"] == 0.0
    assert rep["wear"]["max_group_wear"] > 0
    tp = params_from_jax(jax.tree.map(np.asarray, jparams))
    cfg = get_config(ARCH).reduced()
    trace = load_trace(path)

    def run(**kw):
        eng = ServingEngine(cfg, ServeConfig(
            max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
            **kw), tp, device="cpu")
        pol = make_wear_policy("rotate", **identity) if kw else None
        return ContinuousScheduler(eng, capacity=2, wear_policy=pol).run(
            TraceSource(trace, cfg, CPU))

    off, on = run(), run(**WEAR)
    assert on["requests"] == off["requests"]
    for s in ("kv_prefill", "kv_decode"):
        assert on["streams"][s] == off["streams"][s], s
    assert "wear" not in off and "kv_remap" not in off["streams"]


def test_rotation_is_exact_against_the_reference(jparams):
    rep, ref = _serve_pair(jparams, policy=ROTATE, **WEAR)
    _check_serve(rep, ref)
    w = rep["wear"]
    assert w["rotations"] >= 1 and w["remap_energy_pj"] > 0


def test_rotation_with_retention_and_windowed_scrub_is_exact(jparams):
    """400 K, periodic scrubbing of 4-column windows walking physical
    rows through the rotation."""
    rep, ref = _serve_pair(jparams, policy=ROTATE, scrub=(2, 4),
                           retention_scale=1000.0, ambient_k=400.0, **WEAR)
    _check_serve(rep, ref)
    lt = rep["lifetime"]
    assert lt["scrub_passes"] > 0 and lt["retention_flips"] > 0
    assert rep["wear"]["rotations"] >= 1


def test_endurance_budget_with_worn_rows_is_exact(jparams):
    """A budget the hottest groups exhaust: stuck-at writes lose bits,
    and the run is exact against the reference."""
    rep, ref = _serve_pair(jparams, endurance_budget=2,
                           remap_group_cols=2)
    _check_serve(rep, ref)
    assert rep["wear"]["worn_groups"] > 0
    assert rep["wear"]["policy"] == "none"


def test_prefix_cache_with_wear_is_exact(jparams, tmp_path):
    """Linked admissions and copy-on-writes book their column drives as
    wear (the admission booking of the prefix path), rotating."""
    path = _shared_prefix_trace(tmp_path / "shared.jsonl")
    rep, ref = _serve_pair(jparams, path=path, policy=ROTATE,
                           prefix_cache=True, prefix_chunk=4, **WEAR)
    _check_serve(rep, ref)
    p = rep["prefix"]
    assert p["linked_admissions"] >= 1 and p["cow_events"] >= 1


def test_wear_state_resumes_the_map_and_the_counters(jparams):
    rep, ref = _serve_pair(jparams, policy=ROTATE, resume=True,
                           endurance_budget=20, **WEAR)
    _check_serve(rep, ref)
    assert rep["wear"]["max_group_wear"] > 0


def test_generate_with_wear_matches_the_reference(jparams):
    cfg = get_config(ARCH).reduced()
    toks = np.random.default_rng(4).integers(0, 256, (2, 8))
    kw = dict(max_seq=16, max_new_tokens=6, endurance_budget=1,
              remap_group_cols=2)
    jt, jrep = JEngine(jget(ARCH).reduced(), JServeConfig(**kw),
                       params=jparams).generate(
        {"tokens": jnp.asarray(toks, jnp.int32)})
    tt, trep = ServingEngine(cfg, ServeConfig(**kw), jparams, device="cpu",
                             api=JaxModel(cfg)).generate(
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert trep["wear"] == jrep["wear"]
    assert trep["retention"] == jrep["retention"]
    for s in ("kv_prefill", "kv_decode"):
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert trep["streams"][s][k] == jrep["streams"][s][k], (s, k)
    assert trep["wear"]["worn_groups"] > 0


def test_launcher_wear_flags_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--reduced", "--device", "cpu", "--trace", FIXTURE,
                "--capacity", "2", "--wear-policy", "rotate",
                "--remap-group-cols", "4", "--wear-check-interval", "2",
                "--hot-row-wear", "2", "--endurance-budget", "40"])
    out = capsys.readouterr().out
    assert "served 4 requests in 8 steps" in out
    assert ("wear leveling (policy rotate, group 4 cols, budget 40): "
            "rotations=") in out
    assert "remap" in out and "lifetime ledger" in out
