"""The port's training state against the JAX reference, on the CPU:
trees in JAX's leaf order, AdamW (``repro.train.optimizer``) and the
int8 gradient wire (``repro.train.compression``).

* ``tree``: dicts (sorted keys), NamedTuples (field order), lists,
  tuples and ``None`` flatten in ``jax.tree_util``'s order with its key
  paths (``keystr`` renders them alike), and rebuild the same structure.
* Twins of ``test_substrate.py``'s ``TestCompression`` and of
  ``test_memory.py``'s ``TestCompressionWirePath``.
* ``quantize`` is bit-exact, per tensor and per channel (the reference's
  eager call divides by ``qmax``; it is not XLA's reciprocal product), and
  ``compress_grads`` through the ``lanes_ref`` wire gives the reference's
  int8 codes, residuals and wire stats exactly (energy at rtol=1e-5).
* ``update`` over 12 steps: moments and parameters within 2e-6 of each
  leaf's largest magnitude, about 3x the largest difference measured
  (5.8e-7: float32 reductions in another order, fused multiply-adds and
  ``pow`` in XLA's CPU code); the learning rate is equal.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import memory as jmemory
from repro.core.priority import Priority as JP
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch import memory, rng
from repro_torch import tree as T
from repro_torch.core.priority import Priority, keystr
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt

RTOL = 1e-5
#: ``update``'s tolerance, relative to each leaf's largest magnitude
ADAMW_TOL = 2e-6


def _np_tree(seed, scale=1.0, shapes=((12, 8), (20,), (4, 3, 5))):
    r = np.random.default_rng(seed)
    a, c, e = ((r.standard_normal(s) * scale).astype(np.float32)
               for s in shapes)
    return {"a": a, "b": {"c": c}, "e": e}


def _tt(t):
    return T.tree_map(torch.from_numpy, t)


def _jt(t):
    return jax.tree.map(jnp.asarray, t)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

class _Pair(NamedTuple):
    first: object
    second: object


def test_tree_order_and_paths_match_jax():
    tree = {"z": [1, (2, None, 3)], "a": _Pair({"y": 4, "x": 5}, [6]),
            "m": None, 0: {"k": 7}}
    tree = {str(k): v for k, v in tree.items()}
    jflat, jdef = jax.tree_util.tree_flatten_with_path(tree)
    flat, tdef = T.flatten_with_def(tree)
    assert [leaf for _, leaf in flat] == [leaf for _, leaf in jflat]
    assert [keystr(p) for p, _ in flat] == [
        jax.tree_util.keystr(p) for p, _ in jflat]
    assert len(flat) == jdef.num_leaves == 7
    rebuilt = tdef.unflatten([leaf * 10 for _, leaf in flat])
    assert rebuilt == jax.tree.map(lambda x: x * 10, tree)
    assert isinstance(rebuilt["a"], _Pair) and isinstance(rebuilt["z"][1],
                                                          tuple)
    axes = {"0": {"k": ("x",)}, "a": _Pair({"x": ("p", "q"), "y": ()},
                                           [("r",)]),
            "m": None, "z": [("s",), (("t",), None, ("u",))]}
    assert tdef.flatten_up_to(axes) == jdef.flatten_up_to(axes)
    assert T.tree_map(lambda a, b: (a, b), tree, axes)["a"].first["x"] == (
        5, ("p", "q"))


# ---------------------------------------------------------------------------
# twins of TestCompression and TestCompressionWirePath
# ---------------------------------------------------------------------------

def test_int8_range_and_scale():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        64).astype(np.float32) * 5)
    q, s = comp.quantize(g, 8)
    assert q.dtype == torch.int8
    err = (comp.dequantize(q, s) - g).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_reduces_bias():
    cfg = comp.CompressionConfig(bits=8)
    g_true = {"w": torch.from_numpy(np.random.default_rng(1).standard_normal(
        32).astype(np.float32) * 1e-3)}
    ef = comp.init_state(g_true)
    applied = torch.zeros((32,))
    for _ in range(50):
        out, ef = comp.compress_grads(g_true, ef, cfg)
        applied = applied + out["w"]
    total = 50 * g_true["w"]
    rel = float(torch.linalg.norm(applied - total) / torch.linalg.norm(total))
    assert rel < 0.02, f"EF bias too large: {rel}"


def test_disable_passthrough():
    cfg = comp.CompressionConfig(enable=False)
    g = {"w": torch.ones((4,))}
    out, ef = comp.compress_grads(g, comp.init_state(g), cfg)
    assert out["w"].tolist() == [1.0] * 4


def test_wire_savings():
    g = {"w": torch.ones((100,))}
    assert comp.wire_bytes_saved(g, comp.CompressionConfig()) == 300
    assert comp.wire_bytes_saved(g, comp.CompressionConfig(
        enable=False)) == 0


def test_wire_backend_exercises_int8_lanes():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 8)).astype(np.float32) * 1e-3)}
    cfg = comp.CompressionConfig(wire_backend="lanes_ref",
                                 wire_level=Priority.HIGH)
    out, ef, st = comp.compress_grads(g, comp.init_state(g), cfg,
                                      key=rng.PRNGKey(1), with_stats=True)
    assert isinstance(st, memory.WriteStats)
    assert int(st.bits_total) == 64 * 8 * 8  # int8 codes
    assert int(st.bits_written) > 0
    assert out["w"].shape == g["w"].shape


def test_wire_upsets_washed_out_by_error_feedback():
    cfg = comp.CompressionConfig(wire_backend="lanes_ref",
                                 wire_level=Priority.HIGH)
    key = rng.PRNGKey(1)
    g_true = {"w": torch.from_numpy(np.random.default_rng(2).standard_normal(
        32).astype(np.float32) * 1e-3)}
    ef = comp.init_state(g_true)
    applied = torch.zeros((32,))
    for i in range(50):
        out, ef = comp.compress_grads(g_true, ef, cfg,
                                      key=rng.fold_in(key, i))
        applied = applied + out["w"]
    total = 50 * g_true["w"]
    rel = float(torch.linalg.norm(applied - total) / torch.linalg.norm(total))
    assert rel < 0.05, f"wire-write bias not absorbed by EF: {rel}"


def test_disabled_wire_path_unchanged():
    g = {"w": torch.ones((16,))}
    cfg = comp.CompressionConfig()
    assert cfg.wire_backend is None
    out, ef, st = comp.compress_grads(g, comp.init_state(g), cfg,
                                      with_stats=True)
    assert out["w"].shape == (16,) and st is None


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_is_bit_exact(per_channel):
    r = np.random.default_rng(3)
    for shape in ((64,), (37, 5), (8, 3, 7)):
        for scale in (1e-6, 1e-2, 30.0):
            x = (r.standard_normal(shape) * scale).astype(np.float32)
            x[0] = 0.5 * scale  # near the halfway cases of the rounding
            qj, sj = jcomp.quantize(jnp.asarray(x), 8,
                                    per_channel=per_channel)
            qt, st = comp.quantize(torch.from_numpy(x), 8,
                                   per_channel=per_channel)
            np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
            np.testing.assert_array_equal(st.numpy().view(np.int32),
                                          np.asarray(sj).view(np.int32))


def test_compress_grads_wire_matches_reference():
    """Two steps of the lanes_ref wire at LOW (upsets in every step):
    codes (through the dequantised output), residuals and stats. One
    leaf shape (the quantise paths of other shapes are held above)."""
    gs = [_np_tree(4, 1e-3, ((12, 8),) * 3),
          _np_tree(5, 1e-3, ((12, 8),) * 3)]
    cfg_t = comp.CompressionConfig(wire_backend="lanes_ref",
                                   wire_level=Priority.LOW)
    cfg_j = jcomp.CompressionConfig(wire_backend="lanes_ref",
                                    wire_level=JP.LOW)
    ef_t, ef_j = comp.init_state(_tt(gs[0])), jcomp.init_state(_jt(gs[0]))
    for step, g in enumerate(gs):
        key = None if step == 0 else 11  # the default key, then a given one
        out_t, ef_t, st_t = comp.compress_grads(
            _tt(g), ef_t, cfg_t, key=None if key is None
            else rng.PRNGKey(key), with_stats=True)
        out_j, ef_j, st_j = jcomp.compress_grads(
            _jt(g), ef_j, cfg_j, key=None if key is None
            else jax.random.PRNGKey(key), with_stats=True)
        for a, b in zip(T.leaves(out_t) + T.leaves(ef_t),
                        jax.tree.leaves(out_j) + jax.tree.leaves(ef_j)):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))
        ht, hj = st_t.host_dict(), st_j.host_dict()
        for k in ("flips01", "flips10", "bit_errors", "bits_total"):
            assert ht[k] == hj[k], k
        assert ht["bit_errors"] > 0
        np.testing.assert_allclose(ht["energy_pj"], hj["energy_pj"],
                                   rtol=RTOL)
    # the wire's writes are memory.write's, leaf i keyed fold_in(key, i)
    q, _ = comp.quantize(torch.from_numpy(gs[0]["a"]), 8, per_channel=True)
    stored, _ = memory.write(rng.fold_in(rng.PRNGKey(comp.DEFAULT_WIRE_KEY),
                                         0), torch.zeros_like(q), q,
                             level=Priority.LOW, backend="lanes_ref")
    jstored, _ = jmemory.write(jax.random.fold_in(jax.random.PRNGKey(0x5717),
                                                  0),
                               jnp.zeros((12, 8), jnp.int8),
                               jnp.asarray(q.numpy()), level=JP.LOW,
                               backend="lanes_ref")
    np.testing.assert_array_equal(stored.numpy(), np.asarray(jstored))


def test_adamw_update_within_tolerance():
    shapes = ((12, 8),) * 3
    params = _np_tree(6, shapes=shapes)
    cfg = opt.AdamWConfig(warmup_steps=2, total_steps=10)
    jcfg = jopt.AdamWConfig(warmup_steps=2, total_steps=10)
    tp, jp = _tt(params), _jt(params)
    tp["e"], jp["e"] = tp["e"].to(torch.bfloat16), jp["e"].astype(
        jnp.bfloat16)
    ts, js = opt.init(tp), jopt.init(jp)
    assert isinstance(ts, opt.OptState) and ts.step.dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in T.leaves(ts.m))
    worst = 0.0
    for s in range(12):
        g = _np_tree(100 + s, 0.1, shapes)
        tp, ts, tm = opt.update(cfg, _tt(g), ts, tp)
        jp, js, jm = jopt.update(jcfg, _jt(g), js, jp)
        assert int(ts.step) == int(js.step) == s + 1
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for a, b in zip(T.leaves((tp, ts.m, ts.v)),
                        jax.tree.leaves((jp, js.m, js.v))):
            b = np.asarray(b, np.float32)
            d = float(np.abs(a.to(torch.float32).numpy() - b).max())
            worst = max(worst, d / float(np.abs(b).max()))
    assert worst <= ADAMW_TOL, worst
    for t in (0, 1, 5, 10, 11):
        assert float(opt.schedule(cfg, torch.tensor(t))) == float(
            jopt.schedule(jcfg, jnp.asarray(t)))
