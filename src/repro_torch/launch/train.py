"""Training launcher of the port (the counterpart of
``repro.launch.train``).

  python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \
      --device cpu --steps 50 --ckpt-dir ck
  python -m repro_torch.launch.train --arch qwen2.5-3b --seq 4096 \
      --batch 2 --steps 10                       # full width, on the cards
  python -m repro_torch.launch.train --mesh-shape 1x1 ...  # (data, model)

Runs on CUDA unless ``--device cpu``. The launcher starts one rank a
CUDA device present (rank 0 in this process, the others spawned with
``torch.multiprocessing``), joined by an ``nccl`` group; ``--reduced``
(the small float32 config) runs one rank, as the reference's runs on its
one-device host mesh, and ``--device cpu`` one ``gloo`` rank. Every
world size, 1 included, takes the same path: the ranks form a (data=D,
model=M) mesh (``--mesh-shape DxM``, the reference dryrun's syntax,
default (world, 1); D·M must be the world), each holds its (d, m) blocks
of the parameters and moments under ``--rules`` (``baseline`` cuts the
embed dimension over data, FSDP, and the dense family's heads, mlp and
vocabulary over model, tensor parallel; ``serve_tp_only`` and
``serve_moe_2d`` keep the model cuts only) and trains on its data row's
rows of each global batch (an MoE layer dispatches over the data
group's rows, ``--compress`` compresses each rank's block of the
gradient as one process compresses the whole), and rank 0 prints. The
loop wires every training piece together: the synthetic data pipeline,
AdamW, error-feedback int8 gradients (``--compress``), asynchronous
EXTENT checkpoints every ``--ckpt-every`` steps (rank 0 gathers each
leaf over both axes and writes the optimizer moments at LOW through its
device's backend, ``cuda`` on the card), and the heartbeat and
straggler monitors. The step updates the parameters and the optimizer
state in place, as the reference's donates them. It prints the
reference's lines.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.core.priority import Priority
from repro_torch.device import (end_process_group, local_rendezvous,
                                resolve_device, start_process_group)
from repro_torch.memory import default_backend
from repro_torch.models import get_model
from repro_torch.sharding import make_production_mesh
from repro_torch.sharding.rules import mesh_shards, strategy_rules
from repro_torch.train import compression as comp
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import (HeartbeatMonitor,
                                               StragglerMonitor)
from repro_torch.train.train_step import (make_sharded_train_step,
                                          sharded_value_and_grad)


def moments_low(path, leaf) -> Priority:
    """The launcher's checkpoint policy: optimizer moments LOW, the rest
    EXACT."""
    return (Priority.LOW if ".m" in str(path) or ".v" in str(path)
            else Priority.EXACT)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="small float32 config")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, one rank a device; "
                         "'cpu' for one rank on the CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rules", default="baseline",
                    choices=("baseline", "serve_tp_only", "serve_moe_2d"))
    ap.add_argument("--mesh-shape", default=None,
                    help="the (data, model) mesh as DxM, e.g. 1x2 "
                         "(default: every rank on data)")
    ap.add_argument("--remat", default="full",
                    choices=("full", "selective", "none"))
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    return ap


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    """Run the loop on one rank a device (one rank with ``--reduced`` or
    on the CPU); returns rank 0's losses, last save's report (None
    without ``--ckpt-dir``) and straggler flags' count."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    world = (torch.cuda.device_count()
             if dev.type == "cuda" and not args.reduced else 1)
    return launch(world, args, cfg)


def mesh_shape(spec: Optional[str], world: int) -> Tuple[int, int]:
    """``--mesh-shape``'s (data, model) over ``world`` ranks: ``DxM``, or
    (world, 1) without one; a shape that is not the world raises."""
    if spec is None:
        return world, 1
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh-shape {spec!r}: expected DxM, e.g. 1x2")
    if d < 1 or m < 1 or d * m != world:
        raise ValueError(f"--mesh-shape {spec} covers {d * m} rank(s); "
                         f"the group has {world}")
    return d, m


def launch(world: int, args: argparse.Namespace, cfg,
           init_method: Optional[str] = None, timeout_s: float = 600.0
           ) -> Dict[str, Any]:
    """``world`` ranks of ``train_rank`` over ``cfg``: rank 0 here, ranks
    1.. spawned (each binds its own device); rank 0's result. A rank that
    fails ends the others; a ``--mesh-shape`` that is not the world
    raises before any starts."""
    mesh_shape(args.mesh_shape, world)
    init_method = init_method or local_rendezvous()
    rest = (world, init_method, args, cfg, timeout_s)
    ctx = (mp.start_processes(_spawned_rank, args=rest, nprocs=world - 1,
                              join=False, start_method="spawn")
           if world > 1 else None)
    try:
        out = train_rank(0, *rest)
        while ctx is not None and not ctx.join():
            pass
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
    return out


def _spawned_rank(i: int, *rest) -> None:
    train_rank(i + 1, *rest)


def train_rank(rank: int, world: int, init_method: str,
               args: argparse.Namespace, cfg, timeout_s: float = 600.0
               ) -> Dict[str, Any]:
    """One rank of the loop: joins the group, trains, leaves it."""
    dev = start_process_group(rank, world, init_method, args.device,
                              timeout_s)
    try:
        return _train(rank, world, dev, args, cfg)
    finally:
        end_process_group()


def _train(rank: int, world: int, dev: torch.device,
           args: argparse.Namespace, cfg) -> Dict[str, Any]:
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = make_production_mesh(shape=mesh_shape(args.mesh_shape, world),
                                device=dev)
    api = get_model(cfg)
    shards = mesh_shards(mesh, strategy_rules(mesh, args.rules), api)
    every_row = data_mod.every_row(args.batch, shards.n)
    remat = {"full": True, "selective": "selective", "none": False}[
        args.remat]
    params = api.init(0, dev, keep=shards.keep)
    say(f"{cfg.name}: {api.num_params()/1e6:.1f}M params on "
        f"{mesh.size} device(s)")

    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=10,
                           total_steps=args.steps)
    state = opt.init(params)
    ccfg = comp.CompressionConfig(enable=args.compress)
    ef = comp.init_state(params) if args.compress else None
    counted = shards.counted()

    if args.compress:
        def step(params, state, ef, batch):
            loss, _, grads = sharded_value_and_grad(
                api, params, batch, shards, every_row=every_row,
                remat=remat)
            grads, ef = comp.compress_grads(grads, ef, ccfg,
                                            dims=shards.flat_dims)
            params, state, om = opt.update(ocfg, grads, state, params,
                                           donate=True, counted=counted)
            return params, state, ef, {"loss": loss, **om}
    else:
        base = make_sharded_train_step(api, ocfg, shards, remat=remat,
                                       donate=True)

    ck = (Checkpointer(args.ckpt_dir, async_save=True,
                       extent_policy=moments_low,
                       extent_backend=default_backend(dev), device=dev)
          if args.ckpt_dir else None)
    hb, sm = HeartbeatMonitor(), StragglerMonitor()
    it = data_mod.DataIterator(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch), device=dev,
        data_index=mesh.index("data"), data_size=shards.n)

    losses = []
    for i in range(args.steps):
        t0 = time.time()
        hb.beat(f"rank{rank}")
        batch = next(it)
        if args.compress:
            params, state, ef, m = step(params, state, ef, batch)
        else:
            params, state, m = base(params, state, batch, every_row)
        losses.append(float(m["loss"]))
        sm.record(f"rank{rank}", i, time.time() - t0)
        if ck and i and i % args.ckpt_every == 0:
            ck.save(i, {"params": params, "opt": state},
                    extra=it.state_dict(), dims=shards.state_dims())
        if i % 10 == 0:
            say(f"step {i:4d} loss={losses[-1]:.4f} "
                f"lr={float(m['lr']):.2e} "
                f"gnorm={float(m['grad_norm']):.3f}")
    if ck:
        ck.wait()
    say(f"done: loss {np.mean(losses[:5]):.4f} -> "
        f"{np.mean(losses[-5:]):.4f}; stragglers={len(sm.flags)}")
    return {"losses": losses,
            "save_report": ck.last_save_report if ck else None,
            "stragglers": len(sm.flags)}


if __name__ == "__main__":
    main()
