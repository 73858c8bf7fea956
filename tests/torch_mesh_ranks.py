"""Rank bodies of ``test_torch_train_mesh.py``: each runs in a spawned
process as one gloo rank on the CPU and imports nothing of the JAX
package. Results go to files under the run's directory: rank 0 writes
the gathered state and metrics of each case, every rank the elements it
held."""
import time

import torch
import torch.multiprocessing as mp

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core.priority import Priority
from repro_torch.device import end_process_group, start_process_group
from repro_torch.models import get_model
from repro_torch.models.layers import all_gather_dim
from repro_torch.reliability import RestoreIntegrity
from repro_torch.sharding import make_production_mesh
from repro_torch.sharding.rules import data_shards, strategy_rules
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.train_step import make_sharded_train_step

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
    return tdef.unflatten([x if d is None else all_gather_dim(x, d)
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
            shards = data_shards(mesh, strategy_rules(mesh, strategy),
                                 api.param_axes(), api.param_shapes())
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
