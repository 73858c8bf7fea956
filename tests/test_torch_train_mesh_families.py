"""Every family and ``--compress`` over the ``data`` axis of a process
group, on the CPU with gloo ranks spawned from a ``FileStore`` under
``tmp_path``, one torch thread a rank (``torch_mesh_ranks``).

* Reduced recurrentgemma-2b (hybrid), mamba2-2.7b (ssm),
  llava-next-mistral-7b (vlm), whisper-large-v3 (audio) and dbrx-132b
  (moe, at a capacity factor of 1, so that the dispatch drops) on 2 and
  4 ranks, two steps at global batch 4: the gathered losses, gradient
  norms, parameters and moments against the one-process port step
  (``FAMILY_TOL``, about 3x the largest difference measured) and against
  the JAX reference's step on its host mesh
  (``test_torch_train_loop.PARITY``).
* The moe family dispatches over the group's rows: its dropped
  assignments equal the one-process step's exactly, its ``lb_loss`` (the
  ranks' partials summed) is the one-process loss within tolerance, and
  a global batch the ranks do not divide gives the one-device step.
* ``--compress`` over the ranks: the compressed step against the
  one-process compressed step; ``compress_grads`` on each rank's slices
  of one whole gradient, gathered, equals one process's bit for bit
  (codes, scales, delivered gradients, residuals, the ``lanes_ref``
  wire's stored words and its ``WriteStats``).
* The launcher over 2 gloo ranks with a hybrid model and with
  ``--compress``; its world (one rank under ``--reduced``, one a CUDA
  device without, as the reference's host and production meshes), for
  every family and ``--compress``; ``MeshShards`` finds each family's
  layer stacks from the logical axes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.configs import get_config as jget
from repro.models import get_model as jmodel
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.launch import train as launcher
from repro_torch.models import get_model
from repro_torch.sharding.rules import layer_stacks
from test_torch_train_loop import PARITY
from test_torch_train_step import TOL, to_jax
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
WORLDS = (2, 4)
BATCH = 4
#: the moe cases' capacity factor (the reduced config's 4 never drops)
MOE_CAPACITY = 1.0
ARCHS = ("recurrentgemma-2b", "mamba2-2.7b", "llava-next-mistral-7b",
         "whisper-large-v3", "dbrx-132b")
#: the exactness case of compress_grads: dbrx-132b's leaves are cut along
#: dimension 0 (the unembedding), inner dimensions and not at all
COMPRESS_ARCH = "dbrx-132b"
#: ranks against the one-process port step, per family 3x the largest
#: difference measured over 2 and 4 ranks, and no less than 3 float32
#: ulps (3.6e-7) for the relative ones: the losses relative, the first
#: step's gradient norm relative, both steps' gradient norms relative,
#: every parameter (lr 1e-3) and moment absolute. As for the dense family
#: (``test_torch_train_mesh.MESH_TOL``) the ranks sum each gradient in
#: another order, and AdamW's first step moves an element whose gradient
#: is float32 noise by up to lr either way. Measured:
#:                     loss    gnorm1  gnorm   param   moment
#:   recurrentgemma-2b 3.4e-7  0       8.6e-5  1.8e-5  2.1e-6
#:   mamba2-2.7b       1.3e-7  0       1.1e-6  1.0e-6  5.8e-8
#:   llava (vlm)       8.8e-7  0       3.2e-3  1.4e-3  3.6e-6
#:   whisper (audio)   2.7e-7  7.6e-8  3.7e-4  9.5e-5  5.9e-6
#:   dbrx-132b (moe)   1.2e-7  8.8e-8  8.3e-5  3.3e-5  7.1e-7
#:   dbrx, batch 3/5   0       0       0       0       0
#:   --compress        1.3e-7  6.5e-8  4.2e-4  7.8e-4  3.2e-5
#: The undivided batch is held at dbrx-132b's bounds: every rank runs
#: the one-device step and the ranks' equal gradients are summed, which
#: was exact at 2 and 4 ranks. ``--compress`` also moves an int8 code on
#: a rounding boundary by one step of its scale.
FAMILY_TOL = {
    "recurrentgemma-2b": dict(loss=1e-6, grad_norm1=3.6e-7,
                              grad_norm=2.6e-4, param=5.3e-5, moment=6.3e-6),
    "mamba2-2.7b": dict(loss=4e-7, grad_norm1=3.6e-7, grad_norm=3.2e-6,
                        param=3.1e-6, moment=1.7e-7),
    "llava-next-mistral-7b": dict(loss=2.6e-6, grad_norm1=3.6e-7,
                                  grad_norm=9.5e-3, param=4.3e-3,
                                  moment=1.1e-5),
    "whisper-large-v3": dict(loss=8e-7, grad_norm1=3.6e-7, grad_norm=1.1e-3,
                             param=2.9e-4, moment=1.8e-5),
    "dbrx-132b": dict(loss=3.7e-7, grad_norm1=3.6e-7, grad_norm=2.5e-4,
                      param=9.8e-5, moment=2.1e-6),
    "compress": dict(loss=3.9e-7, grad_norm1=3.6e-7, grad_norm=1.3e-3,
                     param=2.4e-3, moment=9.5e-5),
}
FAMILY_TOL["undivided"] = FAMILY_TOL["dbrx-132b"]
#: the moe family's reported lb_loss (the ranks' partials summed)
#: against the one-process loss, relative: 3x the measured 1.2e-7
LB_RTOL = 3.6e-7
#: the launcher's three losses over 2 ranks against 1, relative: 3x the
#: measured 1.2e-7 (recurrentgemma-2b; 3 ulps) and 4.6e-6 (--compress)
LAUNCH_LOSS_RTOL = {"recurrentgemma-2b": 3.6e-7, "compress": 1.4e-5}


def config(arch):
    cfg = get_config(arch).reduced()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CAPACITY)
    return cfg


def _cases(world):
    cases = [(arch, config(arch), BATCH, False) for arch in ARCHS]
    cases.append(("undivided", config("dbrx-132b"), world + 1, False))
    cases.append(("compress", get_config("qwen2.5-3b").reduced(), BATCH,
                  True))
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> the directory its ranks wrote: one group of ranks a world
    size, the groups at once, each running every case. The reference's
    steps run here meanwhile."""
    out = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    ranks = R.Spawned(*[(R.family_cases, w, f"file://{d}/store", str(d),
                         _cases(w), COMPRESS_ARCH) for w, d in out.items()])
    try:
        for arch in ARCHS:
            reference(arch)
    finally:
        ranks.join()
    return out


def _load(path):
    return torch.load(path, weights_only=False)


_ONE = {}


def one_process(name, batch_size=BATCH):
    """The one-process port step of a case: (params, state, metrics)."""
    if (name, batch_size) not in _ONE:
        cfg = (get_config("qwen2.5-3b").reduced() if name == "compress"
               else config("dbrx-132b" if name == "undivided" else name))
        _ONE[name, batch_size] = R.family_steps(get_model(cfg), batch_size,
                                                name == "compress")
    return _ONE[name, batch_size]


def _max_abs(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(T.leaves(a),
                                                          T.leaves(b)))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _check(got, want, tol):
    params, state, metrics = want
    diff = dict(
        loss=max(_rel(g["loss"], w["loss"])
                 for g, w in zip(got["metrics"], metrics)),
        grad_norm1=_rel(got["metrics"][0]["grad_norm"],
                        metrics[0]["grad_norm"]),
        grad_norm=max(_rel(g["grad_norm"], w["grad_norm"])
                      for g, w in zip(got["metrics"], metrics)),
        param=_max_abs(got["params"], params),
        moment=max(_max_abs(got["m"], state.m), _max_abs(got["v"],
                                                         state.v)))
    for k, v in diff.items():
        assert v <= tol[k], (k, v, tol[k])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_families_match_the_one_process_step(runs, world, arch):
    got = _load(runs[world] / f"{arch}.pt")
    want = one_process(arch)
    for g, w in zip(got["metrics"], want[2]):
        assert set(g) == set(w)
        assert g["tokens"] == w["tokens"] and g["lr"] == w["lr"]
    _check(got, want, FAMILY_TOL[arch])


_JAX_STEPS = {}


def reference(arch):
    """The JAX reference's step on its host mesh from the port's seed-0
    parameters over the same batches: (params, metrics) after
    ``R.STEPS`` steps."""
    if arch not in _JAX_STEPS:
        cfg = config(arch)
        api = get_model(cfg)
        jcfg = dataclasses.replace(jget(arch).reduced(),
                                   capacity_factor=cfg.capacity_factor)
        jp = to_jax(api.init(0, CPU))
        js = jopt.init(jp)
        jstep = jax.jit(jmake_train_step(jmodel(jcfg),
                                         jopt.AdamWConfig(**R.OCFG)))
        metrics = []
        for i in range(R.STEPS):
            jp, js, jm = jstep(jp, js, to_jax(R.family_batch(api, BATCH,
                                                             i)))
            metrics.append({k: float(v) for k, v in jm.items()})
        _JAX_STEPS[arch] = (jax.tree.map(np.asarray, jp), metrics)
    return _JAX_STEPS[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS)
def test_families_match_the_reference_step(runs, world, arch):
    """Within the train-step parity bounds of ``test_torch_train_loop``:
    the first step's loss and gradient norm, the later losses, every
    parameter within ``param_lrs`` times the summed learning rates. The
    first loss takes the family's own bound where the one-process port
    step is farther from the reference (``test_torch_train_step.TOL``:
    whisper-large-v3's 1e-4; measured here 2.0e-5, at 1, 2 and 4
    ranks)."""
    got = _load(runs[world] / f"{arch}.pt")
    jp, jm = reference(arch)
    lrs = sum(m["lr"] for m in jm)
    loss1 = max(PARITY["loss1"], TOL[arch][1])
    for i, (g, w) in enumerate(zip(got["metrics"], jm)):
        np.testing.assert_allclose(g["lr"], w["lr"])
        np.testing.assert_allclose(
            g["loss"], w["loss"], rtol=loss1 if i == 0 else PARITY["loss"])
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"],
                               jm[0]["grad_norm"], rtol=PARITY["gnorm1"])
    worst = max(float(np.abs(a.numpy() - np.asarray(b)).max())
                for a, b in zip(T.leaves(got["params"]),
                                jax.tree.leaves(jp)))
    assert worst <= PARITY["param_lrs"] * lrs


@pytest.mark.parametrize("world", WORLDS)
def test_moe_dispatch_is_the_groups(runs, world):
    """The capacity, the slots and the drops are the whole batch's: each
    step drops exactly the one-process step's assignments (some: the
    ranks' own dispatches would drop others), and the reported
    ``lb_loss`` sums the ranks' partials to the one-process loss."""
    got = _load(runs[world] / "dbrx-132b.pt")
    for g, w in zip(got["metrics"], one_process("dbrx-132b")[2]):
        assert g["dropped"] == w["dropped"] > 0
        assert _rel(g["lb_loss"], w["lb_loss"]) <= LB_RTOL


@pytest.mark.parametrize("world", WORLDS)
def test_moe_batch_the_ranks_do_not_divide(runs, world):
    """Global batch N + 1: every rank holds every row and dispatches it
    as one process does; the count is N times the batch's, the drops
    the one process's, and the step the one-device step."""
    got = _load(runs[world] / "undivided.pt")
    want = one_process("undivided", world + 1)
    for g, w in zip(got["metrics"], want[2]):
        assert g["tokens"] == world * w["tokens"]
        assert g["dropped"] == w["dropped"] > 0
        assert _rel(g["lb_loss"], w["lb_loss"]) <= LB_RTOL
    _check(got, want, FAMILY_TOL["undivided"])


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_step_over_ranks(runs, world):
    """The launcher's ``--compress`` step on the ranks' slices against
    the one-process compressed step: the summed gradients differ in
    their last bits, and an int8 code on a rounding boundary can move
    by one step of its scale."""
    got = _load(runs[world] / "compress.pt")
    _check(got, one_process("compress"), FAMILY_TOL["compress"])


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_compress_grads_on_slices_is_exact(runs, world, per_channel):
    got = _load(runs[world] / f"compress_{per_channel}.pt")
    want = R.compress_case(get_model(get_config(COMPRESS_ARCH).reduced()),
                           None, per_channel)
    assert got["stats"] == want["stats"] and want["stats"]["flips01"] > 0
    for field in ("codes", "scales", "words", "grads", "residual"):
        assert len(got[field]) == len(want[field])
        for a, b in zip(got[field], want[field]):
            assert a.dtype == b.dtype and torch.equal(a, b), field
    # the wire upset some codes, and the scales are per channel or not
    assert any(not torch.equal(a, b) for a, b in zip(want["codes"],
                                                     want["words"]))
    assert any(s.dim() for s in want["scales"]) == per_channel


def _args(**kw):
    argv = ["--reduced", "--device", "cpu", "--steps", "3", "--seq", "16",
            "--batch", "4"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [v])
    return launcher._parser().parse_args(argv)


@pytest.mark.parametrize("case", ["recurrentgemma-2b", "compress"])
def test_launcher_over_two_ranks(tmp_path, capsys, monkeypatch, case):
    """``launch`` over 2 gloo ranks (rank 0 here, rank 1 spawned) trains
    a hybrid model, and ``--compress``, as one rank does."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kw = {"compress": True} if case == "compress" else {"arch": case}
    args = _args(**kw)
    cfg = get_config(args.arch).reduced()
    losses = {}
    for world in (1, 2):
        losses[world] = launcher.launch(
            world, args, cfg, init_method=f"file://{tmp_path}/store{world}",
            timeout_s=R.TIMEOUT_S)["losses"]
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].endswith(f"params on {world} device(s)")
        assert lines[-1].startswith("done: loss ")
    assert len(losses[2]) == 3
    for a, b in zip(losses[2], losses[1]):
        assert _rel(a, b) <= LAUNCH_LOSS_RTOL[case]


@pytest.mark.parametrize("case", ["qwen2.5-3b", *ARCHS, "compress"])
def test_launcher_world(monkeypatch, case):
    """With four CUDA devices the launcher runs one rank under
    ``--reduced`` (the reference's one-device host mesh) and four
    without (its production mesh), for every family and for
    ``--compress``; nothing is refused."""
    seen = []
    monkeypatch.setattr(launcher, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(launcher, "launch",
                        lambda world, args, cfg: seen.append(
                            (world, args.compress, cfg.name)))
    argv = (["--compress"] if case == "compress"
            else ["--arch", case])
    launcher.main(argv + ["--reduced"])
    launcher.main(argv)
    arch = "qwen2.5-3b" if case == "compress" else case
    assert seen == [(1, case == "compress", f"{arch}-reduced"),
                    (4, case == "compress", arch)]


@pytest.mark.parametrize("arch,stacks", [
    ("qwen2.5-3b", {"layers"}), ("dbrx-132b", {"layers"}),
    ("recurrentgemma-2b", {"rec", "att", "mlp"}),
    ("mamba2-2.7b", {"layers"}), ("llava-next-mistral-7b", {"layers"}),
    ("whisper-large-v3", {"encoder", "decoder"})])
def test_layer_stacks_from_the_logical_axes(arch, stacks):
    assert layer_stacks(get_model(get_config(arch).reduced()).param_axes()) \
        == stacks
