"""The port's Checkpointer against the JAX reference
(``repro.train.checkpoint``), on the CPU.

* Twins of ``tests/test_checkpoint.py`` (atomic, pruned, asynchronous,
  EXTENT saves with delta elimination, restore onto devices) and of
  ``test_reliability.py``'s ``TestCheckpointIntegrity``.
* Interchange: a checkpoint saved by either package restores in the
  other, and the same save through ``oracle`` or ``lanes_ref`` writes
  byte-identical leaf files and manifests (bfloat16 as its uint16 view,
  key paths as ``jax.tree_util.keystr`` renders them, an ``OptState``
  NamedTuple in the tree). The 400 K integrity restore equals the
  reference's: flips and residual bits exact, restored leaves bit-exact,
  scrub energy at rtol=1e-5 (float32 sums in another order).
* An exception in an asynchronous commit surfaces in ``wait()``.
* The serving scheduler's ``wear_state()`` survives a save and restore in
  both packages, and a run from the restored snapshot resumes the wear
  clock as one from the snapshot itself (the reference-numerics adapter
  of test_torch_serve.py serves).
"""
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.priority import checkpoint_policy as jcheckpoint_policy
from repro.reliability import RestoreIntegrity as JIntegrity
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro.train.optimizer import OptState as JOptState
from repro_torch import tree as T
from repro_torch.core.priority import Priority, checkpoint_policy, int_type
from repro_torch.reliability import RestoreIntegrity
from repro_torch.train.checkpoint import COMPLETE, Checkpointer
from repro_torch.train.optimizer import OptState

CPU = torch.device("cpu")
RTOL = 1e-5


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(int_type(x.dtype)) if x.dtype.is_floating_point else x
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.kind in "fV":
        a = a.view({2: np.int16, 4: np.int32}[a.itemsize])
    return a


def _same_trees(a, b):
    la, lb = T.leaves(a), T.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        # torch's and numpy's dtype names agree ("float32", "bfloat16")
        assert str(x.dtype).split(".")[-1] == str(y.dtype).split(".")[-1]
        assert tuple(x.shape) == tuple(y.shape)
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _state(seed, dtype=torch.float32):
    r = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(r.standard_normal(
                       (16, 8)).astype(np.float32)).to(dtype),
                   "b": torch.zeros((8,), dtype=dtype)},
        "opt": {"m": torch.from_numpy(r.standard_normal(
                    (16, 8)).astype(np.float32)),
                "step": torch.tensor(3, dtype=torch.int32)},
    }


def _ck(path, **kw):
    return Checkpointer(str(path), device="cpu", **kw)


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_save_restore(tmp_path):
    ck = _ck(tmp_path, async_save=False)
    state = _state(0)
    ck.save(10, state, extra={"data_step": 10})
    got, extra = ck.restore(T.tree_map(lambda x: x.to("meta"), state))
    assert extra == {"data_step": 10}
    _same_trees(state, got)


def test_bf16_roundtrip(tmp_path):
    ck = _ck(tmp_path, async_save=False)
    state = {"w": torch.tensor([1.5, -2.25, 0.0], dtype=torch.bfloat16)}
    ck.save(1, state)
    got, _ = ck.restore(state)
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].float().tolist() == [1.5, -2.25, 0.0]
    entry = json.loads((tmp_path / "step_000000001" / "manifest.json")
                       .read_text())["leaves"][0]
    assert entry["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_000000001" / entry["file"]).dtype == \
        np.uint16


def test_async_save(tmp_path):
    ck = _ck(tmp_path, async_save=True)
    ck.save(5, _state(1))
    ck.wait()
    assert ck.latest_step() == 5
    assert set(ck.last_save_report["stage_s"]) == {
        "snapshot", "to_device", "write", "to_host", "digest", "np_save",
        "commit"}


def _mutated_after_async_save(ck, step, state):
    """Save ``state`` asynchronously with the commit held back until every
    leaf has been changed in place; return the commit's report."""
    import threading
    gate = threading.Event()
    ck._pool.submit(gate.wait)  # the one worker runs the commit after it
    ck.save(step, state)
    for leaf in T.leaves(state):
        leaf.add_(1)
    gate.set()
    ck.wait()
    return ck.last_save_report


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_async_save_snapshots_before_in_place_updates(tmp_path, dtype):
    ck = _ck(tmp_path, async_save=True)
    state = _state(4, dtype)
    before = T.tree_map(torch.clone, state)
    _mutated_after_async_save(ck, 5, state)
    got, _ = ck.restore(before)
    _same_trees(before, got)


def test_async_save_digest_is_of_the_snapshot(tmp_path):
    ck = _ck(tmp_path, async_save=True,
             extent_policy=lambda p, leaf: Priority.MID)
    state = _state(5)
    _mutated_after_async_save(ck, 1, state)
    ck.save(2, state)  # every float leaf differs from what step 1 stored
    ck.wait()
    assert ck.last_save_report["skipped_leaves"] == 0
    assert ck.last_save_report["energy_pj"] > 0


def test_torn_checkpoint_is_skipped(tmp_path):
    ck = _ck(tmp_path, async_save=False)
    state = _state(0)
    ck.save(1, state)
    torn = tmp_path / "step_000000002"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert ck.latest_step() == 1
    got, _ = ck.restore(state)
    _same_trees(state, got)


def test_prune_keeps_last_k(tmp_path):
    ck = _ck(tmp_path, keep_last=2, async_save=False)
    state = _state(0)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.iterdir()
                   if d.name.startswith("step_"))
    assert steps == [3, 4]
    assert not [d for d in tmp_path.iterdir() if d.name.startswith(".tmp")]


def test_restore_without_checkpoint_raises(tmp_path):
    ck = _ck(tmp_path)
    with pytest.raises(FileNotFoundError):
        ck.restore({"x": torch.zeros(())})


def test_policy_weights_exact_moments_approx(tmp_path):
    ck = _ck(tmp_path, async_save=False, extent_policy=lambda p, leaf: (
        Priority.LOW if "opt" in str(p[0]) else Priority.EXACT))
    state = _state(2)
    ck.save(1, state)
    assert ck.last_save_report["energy_pj"] > 0
    got, _ = ck.restore(state)
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    m_err = float((got["opt"]["m"] - state["opt"]["m"]).abs().max())
    assert 0 < m_err < 1.0, "moments approximate but bounded"


def test_delta_elimination_skips_unchanged(tmp_path):
    ck = _ck(tmp_path, async_save=False,
             extent_policy=lambda p, leaf: Priority.MID)
    state = _state(3)
    ck.save(1, state)
    e1 = ck.last_save_report["energy_pj"]
    ck.save(2, state)  # nothing changed
    rep = ck.last_save_report
    assert rep["skipped_leaves"] == 3  # every float leaf; the int32 step
    assert rep["energy_pj"] == 0.0     # is never written through EXTENT
    assert e1 > 0


def test_restore_onto_devices(tmp_path):
    """The counterpart of ``shardings=``: one device, or a tree of them."""
    ck = _ck(tmp_path, async_save=False)
    state = _state(4)
    ck.save(1, state)
    devs = T.tree_map(lambda x: "cpu", state)
    devs["opt"]["m"] = "meta"
    got, _ = ck.restore(state, device=devs)
    assert got["opt"]["m"].device.type == "meta"
    assert got["params"]["w"].device == CPU
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    got, _ = ck.restore(state, device="meta")
    assert all(x.device.type == "meta" for x in T.leaves(got))


# ---------------------------------------------------------------------------
# twins of test_reliability.py's TestCheckpointIntegrity
# ---------------------------------------------------------------------------

def _policy(path, leaf):
    """m at MID, v at LOW, the weights EXACT."""
    s = str(path)
    if "'v'" in s:
        return Priority.LOW
    if "'m'" in s:
        return Priority.MID
    return Priority.EXACT


def _integrity_state(seed=0):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal((32, 8)).astype(np.float32)
            for k in ("w", "m", "v")}


def _roundtrip(tmp_path, integrity, backend="lanes_ref"):
    a = _integrity_state()
    state = {"w": torch.from_numpy(a["w"]),
             "opt": {"m": torch.from_numpy(a["m"]),
                     "v": torch.from_numpy(a["v"])}}
    ck = _ck(tmp_path, async_save=False, extent_policy=_policy,
             extent_backend=backend)
    ck.save(3, state)
    got, _ = ck.restore(state, integrity=integrity)
    return state, got, ck


def test_plain_restore_bit_identical(tmp_path):
    state, got, ck = _roundtrip(tmp_path, None)
    saved, _ = ck.restore(state)
    _same_trees(saved, got)
    assert ck.last_restore_report["leaves_checked"] == 0


def test_integrity_pass_decays_and_scrubs(tmp_path):
    state, got, ck = _roundtrip(
        tmp_path, RestoreIntegrity(ambient_k=400.0, dwell_s=1e5, scrub=True))
    rep = ck.last_restore_report
    assert rep["leaves_checked"] == 2
    assert rep["retention_flips"] > 0
    assert rep["scrub_energy_pj"] > 0.0
    assert torch.equal(state["w"], got["w"])


def test_cold_integrity_pass_is_free(tmp_path):
    _, _, ck = _roundtrip(tmp_path, RestoreIntegrity(ambient_k=300.0,
                                                     dwell_s=1000.0))
    rep = ck.last_restore_report
    assert rep["leaves_checked"] == 2
    assert rep["retention_flips"] == 0
    assert rep["residual_decayed_bits"] == 0


# ---------------------------------------------------------------------------
# interchange with the reference
# ---------------------------------------------------------------------------

def _train_state(seed=7):
    """(port state, reference state): weights (float32 and bfloat16),
    OptState(step, m, v) of float32 moments."""
    r = np.random.default_rng(seed)
    w = {"w": r.standard_normal((12, 6)).astype(np.float32),
         "e": r.standard_normal((12, 6)).astype(np.float32)}
    mo = [{k: r.standard_normal(v.shape).astype(np.float32)
           for k, v in w.items()} for _ in range(2)]

    def port(a, bf16=False):
        t = torch.from_numpy(a)
        return t.to(torch.bfloat16) if bf16 else t

    tstate = {"params": {k: port(v, k == "e") for k, v in w.items()},
              "opt": OptState(torch.tensor(4, dtype=torch.int32),
                              *({k: port(v) for k, v in m.items()}
                                for m in mo))}
    jstate = {"params": {k: jnp.asarray(v).astype(
                  jnp.bfloat16 if k == "e" else jnp.float32)
                  for k, v in w.items()},
              "opt": JOptState(jnp.asarray(4, jnp.int32),
                               *({k: jnp.asarray(v) for k, v in m.items()}
                                 for m in mo))}
    return tstate, jstate


def _jlike(jstate):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jstate)


@pytest.mark.parametrize("backend", ["oracle", "lanes_ref"])
def test_saves_are_byte_identical_and_interchange(tmp_path, backend):
    tstate, jstate = _train_state()
    td, jd = tmp_path / "port", tmp_path / "ref"
    tck = _ck(td, extent_policy=checkpoint_policy, extent_backend=backend)
    jck = JCheckpointer(str(jd), async_save=False,
                        extent_policy=jcheckpoint_policy,
                        extent_backend=backend)
    tck.save(9, tstate, extra={"data_step": 2})
    tck.wait()
    jck.save(9, jstate, extra={"data_step": 2})
    step = "step_000000009"
    files = sorted(os.listdir(jd / step))
    assert files == sorted(os.listdir(td / step))
    assert len(files) == 2 + 7  # COMPLETE, manifest and 7 leaves
    for f in files:
        assert filecmp.cmp(jd / step / f, td / step / f, shallow=False), f
    paths = [e["path"] for e in json.loads(
        (td / step / "manifest.json").read_text())["leaves"]]
    assert paths[:3] == ["['opt'].step", "['opt'].m['e']", "['opt'].m['w']"]
    for k in ("skipped_leaves", "bit_errors", "bytes", "leaves"):
        assert tck.last_save_report[k] == jck.last_save_report[k], k
    np.testing.assert_allclose(tck.last_save_report["energy_pj"],
                               jck.last_save_report["energy_pj"], rtol=RTOL)
    # each package restores the other's checkpoint
    from_ref, extra = _ck(jd).restore(tstate)
    assert extra == {"data_step": 2} and isinstance(from_ref["opt"],
                                                    OptState)
    from_port, _ = JCheckpointer(str(td)).restore(_jlike(jstate))
    _same_trees(from_ref, T.leaves(from_port))
    # the 400 K integrity restore
    integ = dict(ambient_k=400.0, dwell_s=1e5, scrub=True)
    got_t, _ = tck.restore(tstate, integrity=RestoreIntegrity(**integ))
    got_j, _ = jck.restore(_jlike(jstate), integrity=JIntegrity(**integ))
    _same_trees(got_t, T.leaves(got_j))
    rt, rj = tck.last_restore_report, jck.last_restore_report
    assert rt["leaves_checked"] == rj["leaves_checked"] == 4
    assert rt["retention_flips"] == rj["retention_flips"] > 0
    assert rt["residual_decayed_bits"] == rj["residual_decayed_bits"]
    np.testing.assert_allclose(rt["scrub_energy_pj"], rj["scrub_energy_pj"],
                               rtol=RTOL)


def test_async_commit_error_surfaces_in_wait(tmp_path):
    def bad_policy(path, leaf):
        raise RuntimeError("policy failed in the commit")

    ck = _ck(tmp_path, extent_policy=bad_policy)
    ck.save(1, _state(0))  # returns: the commit runs in the worker
    with pytest.raises(RuntimeError, match="policy failed"):
        ck.wait()
    ck.wait()  # raised once, then cleared
    ck.extent_policy = None
    ck.save(2, _state(0))
    ck.wait()
    assert ck.latest_step() == 2
    assert COMPLETE in os.listdir(tmp_path / "step_000000002")


# ---------------------------------------------------------------------------
# the scheduler's wear_state() through the checkpointer
# ---------------------------------------------------------------------------

def test_wear_state_round_trip(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.reliability import make_wear_policy
    from repro_torch.serve import (ContinuousScheduler, ServeConfig,
                                   ServingEngine)
    from repro_torch.workload import TraceSource, load_trace
    from test_torch_serve import ARCH, FIXTURE, JaxModel
    cfg, trace = get_config(ARCH).reduced(), load_trace(FIXTURE)
    # the reference model's numerics over the port's seeded weights
    jparams = jax.tree.map(jnp.asarray, T.tree_map(
        lambda t: t.numpy(), get_model(cfg).init(0, CPU)))
    sch = ContinuousScheduler(
        ServingEngine(cfg, ServeConfig(
            max_seq=trace.max_seq(), max_new_tokens=trace.max_new_tokens(),
            backend="lanes_ref", wear_policy="rotate", remap_group_cols=4,
            endurance_budget=20), jparams, device="cpu", api=JaxModel(cfg)),
        capacity=2, wear_policy=make_wear_policy(
            "rotate", check_interval=2, rotate_step=4, hot_row_wear=2))
    first = sch.run(TraceSource(trace, cfg, CPU))
    snap = {k: v.clone() for k, v in sch.wear_state().items()}
    ck = _ck(tmp_path)
    ck.save(1, snap)
    ck.wait()
    restored, _ = ck.restore(snap)
    # the reference's counters are int32: it casts the int64 leaves
    jrestored, _ = JCheckpointer(str(tmp_path)).restore(
        {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32)
         for k, v in snap.items()})
    for k, v in snap.items():
        assert torch.equal(restored[k], v), k
        np.testing.assert_array_equal(np.asarray(jrestored[k]), v.numpy())
    resumed = sch.run(TraceSource(trace, cfg, CPU), wear_state=restored)
    after = {k: v.clone() for k, v in sch.wear_state().items()}
    again = sch.run(TraceSource(trace, cfg, CPU), wear_state=snap)
    assert resumed["wear"] == again["wear"]
    for k, v in after.items():
        assert torch.equal(sch.wear_state()[k], v), k
    # the clock resumed from the restored wear, not from zero
    assert resumed["wear"]["max_group_wear"] > first["wear"]["max_group_wear"]
    assert bool((after["row_write_count"] >= snap["row_write_count"]).all())
    for rid, r in again["requests"].items():
        assert resumed["requests"][rid]["tokens"] == r["tokens"]
