"""Rank bodies of ``test_torch_train_mesh.py``,
``test_torch_train_mesh_families.py`` and ``test_torch_train_tp.py``:
each runs in a spawned process as
one gloo rank on the CPU and imports nothing of the JAX package. Results
go to files under the run's directory: rank 0 writes the gathered state
and metrics of each case, every rank the elements it held."""
import dataclasses
import time

import torch
import torch.multiprocessing as mp

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.priority import Priority
from repro_torch.device import end_process_group, start_process_group
from repro_torch.launch import train as launcher
from repro_torch.models import get_model
from repro_torch.models.layers import all_gather_dim
from repro_torch.reliability import RestoreIntegrity
from repro_torch.sharding import make_production_mesh
from repro_torch.sharding.rules import (default_rules, mesh_shards,
                                        strategy_rules)
from repro_torch.train import compression as comp
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.train_step import (make_sharded_train_step,
                                          make_train_step,
                                          sharded_value_and_grad,
                                          value_and_grad)

#: the launcher's argv in the (data, model) cases, less --mesh-shape and
#: --ckpt-dir
LAUNCH_ARGV = ["--reduced", "--device", "cpu", "--steps", "3", "--seq",
               "16", "--batch", "4", "--ckpt-every", "2"]

CPU = torch.device("cpu")
#: every collective's bound, and a whole run's
TIMEOUT_S = 60.0
RUN_S = 120.0
STEPS = 2
SEQ = 16
DATA_SEED = 7
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: the checkpoint case's integrity pass (as test_torch_checkpoint's)
INTEGRITY = dict(ambient_k=400.0, dwell_s=1e5, scrub=True)


def moments_low(path, leaf):
    return (Priority.LOW if ".m" in str(path) or ".v" in str(path)
            else Priority.EXACT)


def checkpointer(directory) -> Checkpointer:
    return Checkpointer(str(directory), async_save=False,
                        extent_policy=moments_low,
                        extent_backend="lanes_ref", device=CPU)


class Spawned:
    """Each ``(fn, world, *args)`` of ``groups`` started as ``fn(rank,
    world, *args)`` on ``world`` spawned processes, the groups at once.
    ``join()`` waits for them: it raises if a rank failed or the groups
    outlast ``RUN_S``, and ends every process either way."""

    def __init__(self, *groups):
        self.deadline = time.monotonic() + RUN_S
        self.ctxs = [mp.start_processes(fn, args=(world,) + tuple(args),
                                        nprocs=world, join=False,
                                        start_method="spawn")
                     for fn, world, *args in groups]

    def join(self) -> None:
        try:
            for ctx in self.ctxs:
                while not ctx.join(timeout=1.0):
                    if time.monotonic() > self.deadline:
                        raise TimeoutError(
                            f"ranks still running after {RUN_S} s")
        finally:
            for ctx in self.ctxs:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                    p.join()


def steps(api, shards, batch_size: int, rank: int, world: int):
    """STEPS sharded steps from the seed-0 parameters: (params, state,
    per-step metrics)."""
    params = api.init(0, CPU, keep=shards.keep)
    state = opt.init(params)
    step = make_sharded_train_step(api, opt.AdamWConfig(**OCFG), shards)
    dcfg = data_mod.DataConfig(api.cfg.vocab_size, SEQ, batch_size,
                               seed=DATA_SEED)
    metrics = []
    for i in range(STEPS):
        batch = data_mod.rank_rows(data_mod.make_batch(dcfg, i, CPU), rank,
                                   world)
        params, state, m = step(params, state, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "ce_loss",
                                                 "grad_norm", "tokens",
                                                 "lr")})
    return params, state, metrics


def whole(tree, shards):
    """Every leaf of a params-shaped tree of slices gathered whole."""
    flat, tdef = T.flatten_with_def(tree)
    return tdef.unflatten([d.whole(x)
                           for (_, x), d in zip(flat, shards.flat_dims)])


def train_cases(rank: int, world: int, init: str, out: str, cases,
                ckpt: bool) -> None:
    """Each (arch, global batch, rules strategy) case: STEPS steps; rank
    0 saves the gathered parameters and moments and the metrics, every
    rank the elements it held. With ``ckpt`` the first case's state is
    also saved through ``Checkpointer(dims=)`` and restored onto the
    ranks, each saving its slices and the restore's report."""
    torch.set_num_threads(1)
    start_process_group(rank, world, init, CPU, TIMEOUT_S)
    try:
        mesh = make_production_mesh(shape=(world, 1), device=CPU)
        for n, (arch, batch_size, strategy) in enumerate(cases):
            api = get_model(get_config(arch).reduced())
            shards = mesh_shards(mesh, strategy_rules(mesh, strategy), api)
            params, state, metrics = steps(api, shards, batch_size, rank,
                                           world)
            held = sum(x.numel() for x in T.leaves((params, state.m,
                                                    state.v)))
            tree = {"params": whole(params, shards),
                    "m": whole(state.m, shards), "v": whole(state.v, shards)}
            name = f"{arch}_{batch_size}_{strategy}"
            torch.save(held, f"{out}/{name}.held{rank}.pt")
            if rank == 0:
                torch.save({"metrics": metrics, **tree}, f"{out}/{name}.pt")
            if ckpt and n == 0:
                checkpoint_case(rank, out, params, state, shards)
    finally:
        end_process_group()


def checkpoint_case(rank, out, params, state, shards) -> None:
    ck = checkpointer(f"{out}/ckpt")
    st = {"params": params, "opt": state}
    ck.save(STEPS, st, extra={"step": STEPS, "seed": DATA_SEED},
            dims=shards.state_dims())
    like = T.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                            device="meta"), st)
    got, extra = ck.restore(like, integrity=RestoreIntegrity(**INTEGRITY),
                            dims=shards.state_dims())
    torch.save({"restored": got, "extra": extra,
                "report": {k: v for k, v in ck.last_restore_report.items()
                           if k != "stage_s"}},
               f"{out}/restore{rank}.pt")


# ---------------------------------------------------------------------------
# every family and --compress over the data axis


def family_batch(api, batch_size: int, i: int):
    """Step ``i``'s seeded global batch of ``api``'s training inputs
    (``ModelApi.batch_shapes`` at length SEQ): token ids and labels
    uniform over the vocabulary, image embeddings and frames normal."""
    g = torch.Generator().manual_seed(DATA_SEED * 1000 + i)
    shapes = api.batch_shapes(ShapeConfig("train", SEQ, batch_size,
                                          "train"))
    return {k: (torch.randint(0, api.cfg.vocab_size, shape, generator=g)
                if dtype == torch.int64
                else torch.randn(shape, generator=g).to(dtype))
            for k, (shape, dtype) in shapes.items()}


def family_steps(api, batch_size: int, compress: bool, shards=None,
                 rank: int = 0, world: int = 1):
    """STEPS steps from the seed-0 parameters over ``family_batch``'s
    batches: the sharded step on this rank's slices and rows with
    ``shards``, else the one-process step. ``compress``: the launcher's
    ``--compress`` step (error-feedback int8 gradients). Returns
    (params, state, per-step metrics)."""
    ocfg = opt.AdamWConfig(**OCFG)
    keep = shards.keep if shards is not None else None
    params = api.init(0, CPU, keep=keep)
    state = opt.init(params)
    ccfg = comp.CompressionConfig()
    ef = comp.init_state(params)
    every = data_mod.every_row(batch_size, world)
    counted = shards.counted() if shards is not None else None
    dims = shards.flat_dims if shards is not None else None
    plain = (make_sharded_train_step(api, ocfg, shards)
             if shards is not None else make_train_step(api, ocfg))
    metrics = []
    for i in range(STEPS):
        batch = data_mod.rank_rows(family_batch(api, batch_size, i), rank,
                                   world)
        if not compress:
            params, state, m = (plain(params, state, batch, every)
                                if shards is not None
                                else plain(params, state, batch))
        else:
            if shards is not None:
                loss, aux, grads = sharded_value_and_grad(
                    api, params, batch, shards, every_row=every)
            else:
                loss, aux, grads = value_and_grad(api, params, batch)
            grads, ef = comp.compress_grads(grads, ef, ccfg, dims=dims)
            params, state, om = opt.update(ocfg, grads, state, params,
                                           counted=counted)
            m = {"loss": loss, **aux, **om}
        metrics.append({k: float(v) for k, v in m.items()})
    return params, state, metrics


def compress_inputs(api, seed: int):
    """A seeded whole gradient and residual over ``api``'s parameter
    shapes (normal, every leaf on its own scale), float32."""
    g = torch.Generator().manual_seed(seed)
    flat, tdef = T.flatten_with_def(api.descs())
    grads, ef = [], []
    for n, (_, desc) in enumerate(flat):
        shape = desc.shape
        scale = 10.0 ** (n % 5 - 2)
        grads.append(torch.randn(shape, generator=g) * scale)
        ef.append(torch.randn(shape, generator=g) * scale * 1e-2)
    return tdef.unflatten(grads), tdef.unflatten(ef)


#: ``compress_grads``' wire in the exactness case
COMPRESS_WIRE = "lanes_ref"
COMPRESS_KEY = 31


def compress_case(api, shards, per_channel: bool):
    """``compress_grads`` with a ``lanes_ref`` wire on this rank's slices
    of ``compress_inputs``; with ``shards`` None on the whole leaves.
    Returns every output whole: the codes and scales (``quantize``), the
    stored wire codes (``wire_write``), the delivered gradients, the
    residuals and the ``WriteStats``' fields."""
    cfg = comp.CompressionConfig(wire_backend=COMPRESS_WIRE,
                                 per_channel=per_channel)
    key = rng.PRNGKey(COMPRESS_KEY)
    grads, ef = compress_inputs(api, 5)
    if shards is not None:
        flat, tdef = T.flatten_with_def(grads)
        grads = tdef.unflatten([shards.keep(i, x)
                                for i, (_, x) in enumerate(flat)])
        ef = tdef.unflatten([shards.keep(i, x) for i, x in
                             enumerate(T.leaves(ef))])
        dims = shards.flat_dims
    else:
        dims = [None] * len(T.leaves(grads))
    out, res, stats = comp.compress_grads(grads, ef, cfg, key,
                                          with_stats=True, dims=dims)
    codes, scales, words = [], [], []
    for i, (g, e, d) in enumerate(zip(T.leaves(grads), T.leaves(ef),
                                      dims)):
        q, scale = comp.quantize(g + e, cfg.bits, per_channel=per_channel,
                                 cut=d)
        stored, _ = comp.wire_write(rng.fold_in(key, i), q, cfg, d)
        if d is not None:
            q, stored = d.whole(q), d.whole(stored)
            for a, dim in (("model", d.model), ("data", d.data)):
                if scale.dim() and dim == 0:
                    scale = all_gather_dim(scale, 0, d.mesh.groups[a])
        codes.append(q)
        scales.append(scale)
        words.append(stored)
    if shards is not None:
        out, res = whole(out, shards), whole(res, shards)
    return {"codes": codes, "scales": scales, "words": words,
            "grads": T.leaves(out), "residual": T.leaves(res),
            "stats": {k: v.item() for k, v in vars(stats).items()}}


def family_cases(rank: int, world: int, init: str, out: str, cases,
                 compress_arch: str) -> None:
    """Each (name, config, global batch, compress) case: STEPS sharded
    steps, rank 0 saving the gathered parameters and moments and the
    metrics; then ``compress_case`` on ``compress_arch``'s slices, per
    tensor and per channel, rank 0 saving it."""
    torch.set_num_threads(1)
    start_process_group(rank, world, init, CPU, TIMEOUT_S)
    try:
        mesh = make_production_mesh(shape=(world, 1), device=CPU)
        for name, cfg, batch_size, compress in cases:
            api = get_model(cfg)
            shards = mesh_shards(mesh, default_rules(mesh), api)
            params, state, metrics = family_steps(api, batch_size, compress,
                                                  shards, rank, world)
            tree = {"params": whole(params, shards),
                    "m": whole(state.m, shards), "v": whole(state.v, shards)}
            if rank == 0:
                torch.save({"metrics": metrics, **tree}, f"{out}/{name}.pt")
        api = get_model(get_config(compress_arch).reduced())
        shards = mesh_shards(mesh, default_rules(mesh), api)
        for per_channel in (False, True):
            got = compress_case(api, shards, per_channel)
            if rank == 0:
                torch.save(got, f"{out}/compress_{per_channel}.pt")
    finally:
        end_process_group()


# ---------------------------------------------------------------------------
# the dense family over a (data, model) mesh


def first_grads(api, shards, batch_size: int, data_index: int,
                data_size: int):
    """The gradient tree of the first step's loss at the seed-0
    parameters, this rank's blocks (``shards``) or the whole leaves."""
    dcfg = data_mod.DataConfig(api.cfg.vocab_size, SEQ, batch_size,
                               seed=DATA_SEED)
    batch = data_mod.make_batch(dcfg, 0, CPU)
    if shards is None:
        return value_and_grad(api, api.init(0, CPU), batch)[2]
    batch = data_mod.rank_rows(batch, data_index, data_size)
    return sharded_value_and_grad(
        api, api.init(0, CPU, keep=shards.keep), batch, shards,
        every_row=data_mod.every_row(batch_size, data_size))[2]


def exact_grads(api, shards, batch_size: int, data_index: int,
                data_size: int):
    """``first_grads`` of ``api`` (a float64 config) with every
    ``Tensor.float()`` of the model and the loss made float64 too: the
    gradients of the same function to float64 rounding, on this rank's
    blocks or the whole leaves."""
    to_f32 = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        return first_grads(api, shards, batch_size, data_index, data_size)
    finally:
        torch.Tensor.float = to_f32


def f64(cfg):
    """``cfg`` with float64 parameters and compute."""
    return dataclasses.replace(cfg, param_dtype="float64",
                               compute_dtype="float64")


def tp_cases(rank: int, world: int, init: str, out: str, shape, cases,
             launch_init: str) -> None:
    """Each (name, config, global batch) case on a ``shape`` (data,
    model) mesh under the baseline rules: the first step's gradients,
    then STEPS steps; rank 0 saves them gathered with the parameters,
    moments and metrics, every rank the elements it held. The first
    case's state is saved and restored through ``Checkpointer(dims=)``
    (``checkpoint_case``) and ``compress_case`` runs on its blocks, per
    tensor and per channel. Each config's ``exact_grads`` (float64) at
    global batch 4 follow. Then the launcher over the same mesh
    (``--mesh-shape``, ``LAUNCH_ARGV``, a checkpoint at step 2) on a
    second group from ``launch_init``; rank 0 saves its result."""
    torch.set_num_threads(1)
    start_process_group(rank, world, init, CPU, TIMEOUT_S)
    try:
        mesh = make_production_mesh(shape=tuple(shape), device=CPU)
        d, D = mesh.index("data"), shape[0]
        for n, (name, cfg, batch_size) in enumerate(cases):
            api = get_model(cfg)
            shards = mesh_shards(mesh, default_rules(mesh), api)
            grads = whole(first_grads(api, shards, batch_size, d, D),
                          shards)
            params, state, metrics = steps(api, shards, batch_size, d, D)
            held = sum(x.numel() for x in T.leaves((params, state.m,
                                                    state.v)))
            torch.save(held, f"{out}/{name}.held{rank}.pt")
            tree = {"params": whole(params, shards),
                    "m": whole(state.m, shards), "v": whole(state.v, shards),
                    "grads": grads}
            if rank == 0:
                torch.save({"metrics": metrics, **tree}, f"{out}/{name}.pt")
            if n == 0:
                checkpoint_case(rank, out, params, state, shards)
                for per_channel in (False, True):
                    got = compress_case(api, shards, per_channel)
                    if rank == 0:
                        torch.save(got, f"{out}/compress_{per_channel}.pt")
        seen = []
        for name, cfg, _ in cases:
            if cfg in seen:
                continue
            seen.append(cfg)
            api = get_model(f64(cfg))
            shards = mesh_shards(mesh, default_rules(mesh), api)
            grads = whole(exact_grads(api, shards, 4, d, D), shards)
            if rank == 0:
                torch.save(grads, f"{out}/{name}.f64.pt")
    finally:
        end_process_group()
    args = launcher._parser().parse_args(LAUNCH_ARGV + [
        "--mesh-shape", f"{shape[0]}x{shape[1]}", "--ckpt-dir",
        f"{out}/launch_ck"])
    res = launcher.train_rank(rank, world, launch_init, args,
                              cases[0][1], TIMEOUT_S)
    if rank == 0:
        torch.save(res, f"{out}/launch.pt")
