"""The port's training loop on the CPU: port-only twins of
``tests/test_train_integration.py`` (the loss goes down; compressed
training tracks uncompressed; a checkpoint restart replays exactly; an
EXTENT checkpoint round trip mid-run still converges) and of
``test_accumulate_ecc.py::TestAccumulation``; three ``make_train_step``
steps against the reference's from the same parameters and batches; the
launcher with ``--compress`` and ``--ckpt-dir``.

Bounds: the reference's own where a twin has one (accumulated against
full-batch gradients 1e-2 by norm, losses rtol 2e-5). The parity run
(lr 1e-4, three steps) is held at about 3x the largest measured over
seeds 0-3: the first step, from the same parameters, at 1e-5 relative in
its loss (measured 2.0e-6) and 6e-3 in its gradient norm (2.0e-3); the
later losses at 6e-3 (1.9e-3) and every parameter within 3.5 times the
summed learning rates of the reference's (1.15). AdamW moves an element
by about lr whatever its gradient's size, so an element whose gradient
is float32 noise moves either way in the two packages, and the reduced
stack amplifies those moves about tenfold a layer: the later steps
differ as much between the port's float32 and float64 runs as between
the port's and the reference's.
"""
import jax
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import get_model as jmodel
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core.priority import Priority
from repro_torch.launch import train as launcher
from repro_torch.models import get_model
from repro_torch.train import compression as comp
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.accumulate import (AccumConfig, make_accum_train_step,
                                          split_batch)
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.train_step import make_train_step, value_and_grad
from test_torch_train_step import to_jax
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
STEPS = 30
#: the parity run: (first step's loss, its gradient norm, later losses,
#: parameters as a multiple of the summed learning rates)
PARITY = dict(loss1=1e-5, gnorm1=6e-3, loss=6e-3, param_lrs=3.5)


def _setup(arch="qwen2.5-3b", seed=0):
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    params = api.init(seed, CPU)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=STEPS,
                           weight_decay=0.0)
    dcfg = data_mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                               global_batch=8, seed=7)
    return cfg, api, params, ocfg, opt.init(params), dcfg


def _like(tree):
    return T.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                            device="meta"), tree)


class TestTrainIntegration:
    def test_loss_decreases(self):
        cfg, api, params, ocfg, state, dcfg = _setup()
        step = make_train_step(api, ocfg)
        losses = []
        for i in range(STEPS):
            params, state, m = step(params, state,
                                    data_mod.make_batch(dcfg, i, CPU))
            losses.append(float(m["loss"]))
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses

    def test_compressed_training_tracks_uncompressed(self):
        cfg, api, params, ocfg, state, dcfg = _setup()
        ccfg = comp.CompressionConfig(bits=8)
        ef = comp.init_state(params)
        base = make_train_step(api, ocfg)
        p2, s2 = params, state
        losses_c, losses_b = [], []
        for i in range(STEPS):
            batch = data_mod.make_batch(dcfg, i, CPU)
            loss, _, grads = value_and_grad(api, params, batch)
            grads, ef = comp.compress_grads(grads, ef, ccfg)
            params, state, _ = opt.update(ocfg, grads, state, params)
            p2, s2, m = base(p2, s2, batch)
            losses_c.append(float(loss))
            losses_b.append(float(m["loss"]))
        assert np.mean(losses_c[-5:]) < np.mean(losses_b[-5:]) * 1.10

    def test_checkpoint_restart_resumes_exactly(self, tmp_path):
        cfg, api, params, ocfg, state, dcfg = _setup()
        step = make_train_step(api, ocfg)
        ck = Checkpointer(str(tmp_path), async_save=False, device=CPU)
        it = data_mod.DataIterator(dcfg, device=CPU)
        for i in range(10):
            params, state, m = step(params, state, next(it))
            if i == 4:
                ck.save(5, {"params": params, "opt": state},
                        extra=it.state_dict())
        loss_10 = float(m["loss"])
        restored, extra = ck.restore(_like({"params": params, "opt": state}))
        it2 = data_mod.DataIterator(dcfg, device=CPU)
        it2.load_state_dict(extra)
        p, s = restored["params"], restored["opt"]
        for i in range(5):
            p, s, m2 = step(p, s, next(it2))
        assert float(m2["loss"]) == loss_10

    def test_extent_checkpoint_training_still_converges(self, tmp_path):
        cfg, api, params, ocfg, state, dcfg = _setup()
        step = make_train_step(api, ocfg)
        ck = Checkpointer(str(tmp_path), async_save=False, device=CPU,
                          extent_backend="lanes_ref",
                          extent_policy=lambda p, l: (
                              Priority.LOW if "'m'" in str(p[0]) or
                              "'v'" in str(p[0]) else Priority.EXACT))
        losses = []
        for i in range(STEPS):
            params, state, m = step(params, state,
                                    data_mod.make_batch(dcfg, i, CPU))
            losses.append(float(m["loss"]))
            if i == STEPS // 2:
                ck.save(i, {"params": params, "opt": state})
                got, _ = ck.restore(_like({"params": params,
                                           "opt": state}))
                params, state = got["params"], got["opt"]
                assert ck.last_save_report["energy_pj"] > 0
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


class TestAccumulation:
    def _model(self):
        api = get_model(get_config("qwen2.5-3b").reduced())
        return api, api.init(0, CPU)

    def test_microbatched_matches_full_batch(self):
        api, params = self._model()
        dcfg = data_mod.DataConfig(api.cfg.vocab_size, 16, 8, seed=3)
        batch = data_mod.make_batch(dcfg, 0, CPU)
        g_full = value_and_grad(api, params, batch)[2]
        mbs = split_batch(batch, 4)
        g_acc = T.tree_map(torch.zeros_like, params)
        for i in range(4):
            g = value_and_grad(api, params,
                               {k: v[i] for k, v in mbs.items()})[2]
            g_acc = T.tree_map(lambda a, b: a + b / 4, g_acc, g)
        flat_f = torch.cat([x.ravel() for x in T.leaves(g_full)])
        flat_a = torch.cat([x.ravel() for x in T.leaves(g_acc)])
        rel = float(torch.linalg.norm(flat_f - flat_a)
                    / torch.linalg.norm(flat_f))
        assert rel < 1e-2, rel

    def test_accum_step_loss_matches_full(self):
        api, params = self._model()
        ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        dcfg = data_mod.DataConfig(api.cfg.vocab_size, 16, 8, seed=3)
        batch = data_mod.make_batch(dcfg, 0, CPU)
        _, _, m1 = make_train_step(api, ocfg)(params, opt.init(params),
                                              batch)
        _, _, _, m2 = make_accum_train_step(
            api, ocfg, AccumConfig(num_microbatches=4))(
            params, opt.init(params), None, batch)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                                   rtol=2e-5)

    def test_accum_with_compression_runs(self):
        api, params = self._model()
        ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        step = make_accum_train_step(api, ocfg, AccumConfig(
            num_microbatches=2, compression=comp.CompressionConfig()))
        dcfg = data_mod.DataConfig(api.cfg.vocab_size, 16, 4, seed=3)
        ef = comp.init_state(params)
        p, s, ef, m = step(params, opt.init(params), ef,
                           data_mod.make_batch(dcfg, 0, CPU))
        assert np.isfinite(float(m["loss"]))
        assert any(float(e.abs().max()) > 0 for e in T.leaves(ef))


def test_three_steps_match_the_reference():
    """Both packages from the same parameters (the port's, moved to JAX)
    over the same three batches (each package draws its own: they are
    equal bit for bit)."""
    cfg, api, params, _, state, dcfg = _setup(seed=0)
    kw = dict(lr=1e-4, warmup_steps=1, total_steps=STEPS, weight_decay=0.0)
    ocfg, jocfg = opt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    japi = jmodel(jget("qwen2.5-3b").reduced())
    jp = to_jax(params)
    js = jopt.init(jp)
    jstep = jax.jit(jmake_train_step(japi, jocfg))
    step = make_train_step(api, ocfg)
    jdcfg = jdata.DataConfig(cfg.vocab_size, 32, 8, seed=7)
    lrs = 0.0
    for i in range(3):
        params, state, m = step(params, state,
                                data_mod.make_batch(dcfg, i, CPU))
        jp, js, jm = jstep(jp, js, jdata.make_batch(jdcfg, i))
        lrs += float(jm["lr"])
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]))
        np.testing.assert_allclose(
            float(m["loss"]), float(jm["loss"]),
            rtol=PARITY["loss1"] if i == 0 else PARITY["loss"])
        if i == 0:
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]),
                                       rtol=PARITY["gnorm1"])
    assert int(state.step) == int(js.step) == 3
    for a, b in zip(T.leaves(params), jax.tree.leaves(jp)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= \
            PARITY["param_lrs"] * lrs
    # the reference's state drops into the port's step
    jstate = opt_state_from_jax(jax.tree.map(np.asarray, js))
    assert int(jstate.step) == 3 and len(T.leaves(jstate.m)) == len(
        T.leaves(params))
    p4, _, _ = step(params_from_jax(jax.tree.map(np.asarray, jp)), jstate,
                    data_mod.make_batch(dcfg, 3, CPU))
    assert all(bool(torch.isfinite(x).all()) for x in T.leaves(p4))


def test_launcher_compress_and_checkpoint(tmp_path, capsys):
    out = launcher.main(["--reduced", "--device", "cpu", "--compress",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                         "--steps", "3", "--seq", "16", "--batch", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("qwen2.5-3b-reduced: ") and \
        lines[0].endswith("M params on 1 device(s)")
    assert lines[1].startswith("step    0 loss=")
    assert lines[-1].startswith("done: loss ")
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    rep = out["save_report"]
    assert rep["step"] == 2 and rep["energy_pj"] > 0
    n_leaves = len(T.leaves(get_model(
        get_config("qwen2.5-3b").reduced()).init(0, CPU)))
    # params, the step and both moments; the float leaves are written
    assert rep["leaves"] == 3 * n_leaves + 1 and rep["skipped_leaves"] == 0
    assert (tmp_path / "step_000000002" / "COMPLETE").exists()
    assert launcher.moments_low(("['opt'].m['w']",), None) == Priority.LOW
    assert launcher.moments_low(("['params']['w']",), None) == \
        Priority.EXACT


def test_update_slices_and_donation_give_the_same_values(monkeypatch):
    """``optimizer.update`` a few elements at a time, and into the given
    tensors (``donate``), gives the whole-leaf update's values bit for
    bit; donated, the result holds the given storage."""
    api = get_model(get_config("qwen2.5-3b").reduced())
    params = api.init(0, CPU)
    grads = T.tree_map(lambda p: torch.randn(
        p.shape, generator=torch.Generator().manual_seed(p.numel())), params)
    cfg = opt.AdamWConfig(warmup_steps=2)
    state = opt.update(cfg, grads, opt.init(params), params)[1]
    want_p, want_s, _ = opt.update(cfg, grads, state, params)
    monkeypatch.setattr(opt, "UPDATE_SLICE", 97)
    got_p, got_s, _ = opt.update(cfg, grads, state, params)
    p_d = T.tree_map(torch.clone, params)
    s_d = opt.OptState(state.step.clone(), T.tree_map(torch.clone, state.m),
                       T.tree_map(torch.clone, state.v))
    don_p, don_s, _ = opt.update(cfg, grads, s_d, p_d, donate=True)
    for got in ((got_p, got_s), (don_p, don_s)):
        for a, b in zip(T.leaves((want_p, want_s)), T.leaves(got)):
            assert torch.equal(a, b)
    assert all(a.data_ptr() == b.data_ptr() for a, b in
               zip(T.leaves((p_d, s_d.m, s_d.v)),
                   T.leaves((don_p, don_s.m, don_s.v))))
