"""The port's training over the ``data`` axis of a process group
(``repro_torch.device.start_process_group``, ``sharding.rules.MeshShards``,
``train_step.make_sharded_train_step``, ``Checkpointer(dims=)``,
``launch.train.launch``), on the CPU with gloo ranks spawned from a
``FileStore`` under ``tmp_path``, one torch thread a rank, every
collective bounded by a timeout (``torch_mesh_ranks``).

* Reduced qwen2.5-3b and gemma2-9b on 2 and 4 ranks, two steps at global
  batch 4 and 8: the gathered loss, gradient norm, parameters and
  moments against the one-process port step (``MESH_TOL``, about 3x the
  largest difference measured) and against the JAX reference's step on
  its host mesh (``test_torch_train_loop.PARITY``, the train-step
  parity bounds).
* One rank is the one-process step bit for bit; a global batch the
  ranks do not divide runs whole on every rank and equals the
  one-device step; each rank holds 1/N of the sharded leaves' elements
  plus the replicated leaves; ``serve_tp_only`` and ``serve_moe_2d``
  (pure data parallelism on the dense family) equal the one-process
  step.
* A 2-rank checkpoint's leaf files are byte for byte a one-process
  save's of the gathered state; its restore hands back each slice of the
  one-process restore bit for bit, with the same integrity report.
* The launcher over 2 gloo ranks, rank 0 in this process; a model axis
  over more than one device for a model with experts or the hybrid
  family, and a group that cannot be built, each raise. (The other
  families and ``--compress`` over ranks: ``test_torch_train_mesh_
  families.py``.)
"""
import argparse
import filecmp
import math

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.configs import get_config as jget
from repro.models import get_model as jmodel
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import end_process_group, start_process_group
from repro_torch.launch import train as launcher
from repro_torch.models import get_model
from repro_torch.reliability import RestoreIntegrity
from repro_torch.sharding import Mesh, make_production_mesh
from repro_torch.sharding.mesh import device_grid
from repro_torch.sharding.rules import (default_rules, leaf_cuts,
                                        make_constrain, mesh_shards)
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (make_sharded_train_step,
                                          make_train_step)
from test_torch_train_loop import PARITY
from test_torch_train_step import to_jax
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
ARCHS = ("qwen2.5-3b", "gemma2-9b")
BATCHES = (4, 8)
WORLDS = (2, 4)
STRATEGIES = ("serve_tp_only", "serve_moe_2d")
#: ranks against the one-process port step, ~3x the largest measured over
#: the cases here: the losses relative (measured 4.7e-7), the first
#: step's gradient norm relative (9.5e-8), the second's (2.6e-3), every
#: parameter (1.3e-4, lr 1e-3) and moment (3.5e-5) absolute. The ranks
#: sum each gradient in another order, and AdamW's first step moves an
#: element whose gradient is float32 noise either way (as the
#: one-process step against a 2-microbatch accumulation step does, by
#: the same 5.3e-5 for qwen2.5-3b at batch 4): the second step starts
#: from parameters that far apart.
MESH_TOL = dict(loss=1.5e-6, grad_norm1=3e-7, grad_norm=8e-3, param=4e-4,
                moment=1.1e-4)
#: the launcher's three losses over 2 ranks against 1, ~3x the measured
#: 1.9e-6
LAUNCH_LOSS_RTOL = 6e-6


def _cases(world):
    cases = [(a, b, "baseline") for a in ARCHS for b in BATCHES]
    cases.append(("qwen2.5-3b", world + 1, "baseline"))
    if world == 2:
        cases += [("qwen2.5-3b", 4, s) for s in STRATEGIES]
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> the directory its ranks wrote: one group of ranks a world
    size, the groups at once, each running every case (the 2-rank one
    the checkpoint too). The reference's steps run here meanwhile."""
    out = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    ranks = R.Spawned(*[(R.train_cases, w, f"file://{d}/store", str(d),
                         _cases(w), w == 2) for w, d in out.items()])
    try:
        for arch in ARCHS:
            for batch_size in BATCHES:
                reference(arch, batch_size)
    finally:
        ranks.join()
    return out


def _load(path):
    return torch.load(path, weights_only=False)


def one_process(arch, batch_size):
    """The one-process port step (``make_train_step``): (params, state,
    metrics) after ``R.STEPS`` steps from the seed-0 parameters."""
    api = get_model(get_config(arch).reduced())
    params = api.init(0, CPU)
    state = opt.init(params)
    step = make_train_step(api, opt.AdamWConfig(**R.OCFG))
    dcfg = data_mod.DataConfig(api.cfg.vocab_size, R.SEQ, batch_size,
                               seed=R.DATA_SEED)
    metrics = []
    for i in range(R.STEPS):
        params, state, m = step(params, state,
                                data_mod.make_batch(dcfg, i, CPU))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, state, metrics


def _max_abs(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(T.leaves(a),
                                                          T.leaves(b)))


def _rel(a, b):
    return abs(a - b) / abs(b)


def _differences(got, params, state, metrics):
    return dict(
        loss=max(_rel(g["loss"], w["loss"])
                 for g, w in zip(got["metrics"], metrics)),
        grad_norm1=_rel(got["metrics"][0]["grad_norm"],
                        metrics[0]["grad_norm"]),
        grad_norm=max(_rel(g["grad_norm"], w["grad_norm"])
                      for g, w in zip(got["metrics"], metrics)),
        param=_max_abs(got["params"], params),
        moment=max(_max_abs(got["m"], state.m), _max_abs(got["v"],
                                                         state.v)))


def _dims(world, api):
    """Each leaf's data-axis dimension (``leaf_cuts``) under the baseline
    rules on a (world, 1) mesh: (the params tree of them, the same in
    leaf order)."""
    mesh = Mesh(device_grid([CPU] * world, (world, 1)), ("data", "model"))
    tree, cuts = leaf_cuts(mesh, default_rules(mesh), api.param_axes(),
                           api.param_shapes())
    return T.tree_map(lambda c: c.data, tree), [c.data for c in cuts]


def _check(diff, tol):
    for k, v in diff.items():
        assert v <= tol[k], (k, v, tol[k])


@pytest.mark.parametrize("batch_size", BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_match_the_one_process_step(runs, world, arch, batch_size):
    got = _load(runs[world] / f"{arch}_{batch_size}_baseline.pt")
    params, state, metrics = one_process(arch, batch_size)
    for g, w in zip(got["metrics"], metrics):
        assert g["tokens"] == w["tokens"] and g["lr"] == w["lr"]
    _check(_differences(got, params, state, metrics), MESH_TOL)


_JAX_STEPS = {}


def reference(arch, batch_size):
    """The JAX reference's step on its host mesh from the port's seed-0
    parameters over the same batches: (params, metrics) after
    ``R.STEPS`` steps."""
    key = (arch, batch_size)
    if key not in _JAX_STEPS:
        api = get_model(get_config(arch).reduced())
        jocfg = jopt.AdamWConfig(**R.OCFG)
        jp = to_jax(api.init(0, CPU))
        js = jopt.init(jp)
        jstep = jax.jit(jmake_train_step(jmodel(jget(arch).reduced()),
                                         jocfg))
        jdcfg = jdata.DataConfig(api.cfg.vocab_size, R.SEQ, batch_size,
                                 seed=R.DATA_SEED)
        metrics = []
        for i in range(R.STEPS):
            jp, js, jm = jstep(jp, js, jdata.make_batch(jdcfg, i))
            metrics.append({k: float(v) for k, v in jm.items()})
        _JAX_STEPS[key] = (jax.tree.map(np.asarray, jp), metrics)
    return _JAX_STEPS[key]


@pytest.mark.parametrize("batch_size", BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_match_the_reference_step(runs, world, arch, batch_size):
    """Within the train-step parity bounds of ``test_torch_train_loop``:
    the first step's loss and gradient norm, the later losses, every
    parameter within ``param_lrs`` times the summed learning rates."""
    got = _load(runs[world] / f"{arch}_{batch_size}_baseline.pt")
    jp, jm = reference(arch, batch_size)
    lrs = sum(m["lr"] for m in jm)
    for i, (g, w) in enumerate(zip(got["metrics"], jm)):
        np.testing.assert_allclose(g["lr"], w["lr"])
        np.testing.assert_allclose(
            g["loss"], w["loss"],
            rtol=PARITY["loss1"] if i == 0 else PARITY["loss"])
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"],
                               jm[0]["grad_norm"], rtol=PARITY["gnorm1"])
    worst = max(float(np.abs(a.numpy() - np.asarray(b)).max())
                for a, b in zip(T.leaves(got["params"]),
                                jax.tree.leaves(jp)))
    assert worst <= PARITY["param_lrs"] * lrs


@pytest.fixture
def one_rank(tmp_path):
    """This process as the one rank of a gloo group."""
    start_process_group(0, 1, f"file://{tmp_path}/store", CPU, R.TIMEOUT_S)
    try:
        yield make_production_mesh(shape=(1, 1), device=CPU)
    finally:
        end_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_is_the_one_process_step(one_rank, arch):
    """Gathers and reduce-scatters of one rank are copies and the
    all-reduces identities: the sharded step's values are the
    one-process step's bit for bit."""
    api = get_model(get_config(arch).reduced())
    shards = mesh_shards(one_rank, default_rules(one_rank), api)
    assert any(shards.sharded()) and not all(shards.sharded())
    got = R.steps(api, shards, 4, 0, 1)
    params, state, metrics = one_process(arch, 4)
    for a, b in zip(T.leaves(got[:2]), T.leaves((params, state))):
        assert torch.equal(a, b)
    for g, w in zip(got[2], metrics):
        assert g == {k: w[k] for k in g}


@pytest.mark.parametrize("remat", [True, "selective", False])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b",
                                  "recurrentgemma-2b", "mamba2-2.7b",
                                  "llava-next-mistral-7b",
                                  "whisper-large-v3"])
def test_one_rank_every_family(one_rank, arch, remat):
    """The launcher takes the rank path at every world size: on one rank
    every family's sharded step, under every remat policy, is its
    one-process step bit for bit (the transformer families through their
    gathers, the others without)."""
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    g = torch.Generator().manual_seed(0)
    batch = {k: (torch.randint(0, cfg.vocab_size, shape, generator=g)
                 if dtype == torch.int64
                 else torch.randn(shape, generator=g).to(dtype))
             for k, (shape, dtype) in api.batch_shapes(
                 ShapeConfig("train", 32, 2, "train")).items()}
    ocfg = opt.AdamWConfig()
    params = api.init(0, CPU)
    want = make_train_step(api, ocfg, remat=remat)(params, opt.init(params),
                                                   batch)
    shards = mesh_shards(one_rank, default_rules(one_rank), api)
    params = api.init(0, CPU, keep=shards.keep)
    got = make_sharded_train_step(api, ocfg, shards, remat=remat)(
        params, opt.init(params), batch)
    for a, b in zip(T.leaves(got[:2]), T.leaves(want[:2])):
        assert torch.equal(a, b)
    assert {k: float(v) for k, v in got[2].items()} == \
        {k: float(v) for k, v in want[2].items()}


@pytest.mark.parametrize("world", WORLDS)
def test_batch_the_ranks_do_not_divide(runs, world):
    """Global batch N + 1: every rank runs every row, the count is N
    times the batch's, and the step is the one-device step."""
    B = world + 1
    got = _load(runs[world] / f"qwen2.5-3b_{B}_baseline.pt")
    params, state, metrics = one_process("qwen2.5-3b", B)
    for g, w in zip(got["metrics"], metrics):
        assert g["tokens"] == world * w["tokens"]
    _check(_differences(got, params, state, metrics), MESH_TOL)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pure_data_parallel_strategies(runs, strategy):
    """``serve_tp_only`` and ``serve_moe_2d`` put no dense leaf on the
    data axis: every rank holds every leaf whole, and the step is the
    one-process step."""
    got = _load(runs[2] / f"qwen2.5-3b_4_{strategy}.pt")
    params, state, metrics = one_process("qwen2.5-3b", 4)
    whole = 3 * sum(x.numel() for x in T.leaves(params))
    for r in range(2):
        assert _load(runs[2] / f"qwen2.5-3b_4_{strategy}.held{r}.pt") \
            == whole
    _check(_differences(got, params, state, metrics), MESH_TOL)


@pytest.mark.parametrize("batch_size", BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_share(runs, world, arch, batch_size):
    """Parameter and moment elements a rank holds: the sharded leaves'
    total over N plus the replicated leaves, and less than the whole."""
    api = get_model(get_config(arch).reduced())
    _, dims = _dims(world, api)
    sizes = [math.prod(x.shape) for x in T.leaves(api.descs())]
    sharded = sum(n for n, d in zip(sizes, dims) if d is not None)
    replicated = sum(sizes) - sharded
    share = 3 * (sharded // world + replicated)
    assert sharded % world == 0 and share < 3 * sum(sizes)
    for r in range(world):
        assert _load(runs[world] / f"{arch}_{batch_size}_baseline.held"
                     f"{r}.pt") == share


def test_checkpoint_across_ranks(runs, tmp_path):
    """The 2-rank save's files are a one-process save's of the gathered
    state byte for byte; the restore onto 2 ranks hands back each slice
    of the one-process restore bit for bit, with its report."""
    d = runs[2]
    got = _load(d / "qwen2.5-3b_4_baseline.pt")
    params, state, _ = one_process("qwen2.5-3b", 4)
    whole = {"params": got["params"],
             "opt": opt.OptState(state.step, got["m"], got["v"])}
    ck = R.checkpointer(tmp_path)
    ck.save(R.STEPS, whole, extra={"step": R.STEPS, "seed": R.DATA_SEED})
    name = f"step_{R.STEPS:09d}"
    files = sorted(p.name for p in (tmp_path / name).iterdir())
    assert files == sorted(p.name for p in (d / "ckpt" / name).iterdir())
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / name, d / "ckpt" / name, files, shallow=False)
    assert not mismatch and not errors and len(match) == len(files)
    want, extra = ck.restore(whole, integrity=RestoreIntegrity(
        **R.INTEGRITY))
    dims, _ = _dims(2, get_model(get_config("qwen2.5-3b").reduced()))
    flat_w, tdef = T.flatten_with_def(want)
    state_dims = tdef.flatten_up_to({"params": dims,
                                     "opt": opt.OptState(None, dims, dims)})
    for r in range(2):
        rest = _load(d / f"restore{r}.pt")
        assert rest["extra"] == extra
        assert rest["report"] == {k: v for k, v in
                                  ck.last_restore_report.items()
                                  if k != "stage_s"}
        assert rest["report"]["leaves_checked"] > 0
        for (_, w), g, dm in zip(flat_w, tdef.flatten_up_to(
                rest["restored"]), state_dims):
            assert torch.equal(g, w if dm is None else w.chunk(2, dm)[r])


def _args(**kw):
    argv = ["--reduced", "--device", "cpu", "--steps", "3", "--seq", "16",
            "--batch", "4"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [v])
    return launcher._parser().parse_args(argv)


def test_launcher_over_two_ranks(tmp_path, capsys, monkeypatch):
    """``launch`` over 2 gloo ranks (rank 0 here, rank 1 spawned, one
    thread each) prints the reference's lines from rank 0 alone, trains
    as one rank does within ``LAUNCH_LOSS_RTOL``, and saves the same
    leaves and bytes."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = get_config("qwen2.5-3b").reduced()
    outs = {}
    for world in (1, 2):
        d = tmp_path / f"w{world}"
        outs[world] = launcher.launch(
            world, _args(ckpt_dir=str(d / "ck"), ckpt_every="2"), cfg,
            init_method=f"file://{tmp_path}/store{world}",
            timeout_s=R.TIMEOUT_S)
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == (f"{cfg.name}: 0.2M params on {world} "
                            "device(s)")
        assert lines[1].startswith("step    0 loss=")
        assert lines[-1].startswith("done: loss ") and len(lines) == 3
    for a, b in zip(outs[2]["losses"], outs[1]["losses"]):
        assert _rel(a, b) <= LAUNCH_LOSS_RTOL
    for k in ("step", "leaves", "skipped_leaves", "bytes"):
        assert outs[2]["save_report"][k] == outs[1]["save_report"][k]
    assert outs[2]["save_report"]["energy_pj"] > 0


def test_a_model_axis_raises():
    """Tensor parallelism of the other families is a later slice: a mesh
    whose model axis spans more than one device is refused for a model
    with experts and for the hybrid family, whatever its data axis, and
    taken for the dense family; a model axis of one takes every
    family."""
    moe = get_config("dbrx-132b").reduced()
    hybrid = get_config("recurrentgemma-2b").reduced()
    dense = get_config("qwen2.5-3b").reduced()
    for shape in ((1, 2), (2, 2)):
        mesh = Mesh(device_grid([CPU] * 4, (2, 2))[:shape[0], :shape[1]],
                    ("data", "model"))
        for cfg in (moe, hybrid):
            with pytest.raises(NotImplementedError, match="later slice"):
                make_constrain(mesh, default_rules(mesh), cfg)
        assert make_constrain(mesh, default_rules(mesh), dense)(CPU, None) \
            is CPU
    data = Mesh(device_grid([CPU] * 4, (4, 1)), ("data", "model"))
    for cfg in (moe, hybrid, dense):
        assert make_constrain(data, default_rules(data), cfg)(CPU, None) \
            is CPU


def test_no_group_no_fallback(tmp_path):
    """A group that cannot be built raises, and sharded state without
    its group is refused: nothing carries on as one process."""
    with pytest.raises(ValueError, match="rank 2 of a world of 2"):
        start_process_group(2, 2, f"file://{tmp_path}/store", CPU)
    # a rank whose peer never comes: the rendezvous times out
    with pytest.raises(RuntimeError, match="timeout"):
        start_process_group(0, 2, f"file://{tmp_path}/alone", CPU,
                            timeout_s=1)
    end_process_group()
    api = get_model(get_config("qwen2.5-3b").reduced())
    mesh = Mesh(device_grid([CPU] * 2, (2, 1)), ("data", "model"))
    with pytest.raises(RuntimeError, match="needs a process group of 2"):
        mesh_shards(mesh, default_rules(mesh), api)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            start_process_group(0, 1, f"file://{tmp_path}/s", None)
