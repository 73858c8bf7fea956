"""Training launcher of the port (the counterpart of
``repro.launch.train``).

  python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \
      --device cpu --steps 50 --ckpt-dir ck
  python -m repro_torch.launch.train --arch qwen2.5-3b --seq 4096 \
      --batch 2 --steps 10                       # full width, on the card

Runs on CUDA unless ``--device cpu``. ``--reduced`` takes the small
float32 config on the one-device host mesh; without it the (data, model)
mesh is built from the CUDA devices present, (1, 1) on one card (the
port shards nothing: a mesh over more devices is refused). The loop
wires every training piece together: the synthetic data pipeline,
AdamW, error-feedback int8 gradients (``--compress``), asynchronous
EXTENT checkpoints every ``--ckpt-every`` steps (the optimizer moments
written at LOW through the device's backend, ``cuda`` on the card), and
the heartbeat and straggler monitors. The step updates the parameters
and the optimizer state in place, as the reference's donates them. It
prints the reference's lines.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device
from repro_torch.memory import default_backend
from repro_torch.models import get_model
from repro_torch.sharding import make_host_mesh, make_production_mesh
from repro_torch.sharding.mesh import local_devices
from repro_torch.sharding.rules import (make_constrain, strategy_rules,
                                        tree_shardings)
from repro_torch.train import compression as comp
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import (HeartbeatMonitor,
                                               StragglerMonitor,
                                               reshard_state)
from repro_torch.train.train_step import make_train_step, value_and_grad


def moments_low(path, leaf) -> Priority:
    """The launcher's checkpoint policy: optimizer moments LOW, the rest
    EXACT."""
    return (Priority.LOW if ".m" in str(path) or ".v" in str(path)
            else Priority.EXACT)


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    """Run the loop; returns the losses, the last save's report (None
    without ``--ckpt-dir``) and the straggler flags' count."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="small config + 1-device mesh")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to ask for "
                         "the CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rules", default="baseline")
    ap.add_argument("--remat", default="full",
                    choices=("full", "selective", "none"))
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        mesh = make_host_mesh(dev)
    else:
        mesh = make_production_mesh(shape=(len(local_devices(dev)), 1),
                                    device=dev)
    api = get_model(cfg)
    rules = strategy_rules(mesh, args.rules)
    constrain = make_constrain(mesh, rules)
    remat = {"full": True, "selective": "selective", "none": False}[
        args.remat]

    params_sh = tree_shardings(mesh, rules, api.param_axes(),
                               api.param_shapes())
    params = reshard_state(api.init(0, dev), params_sh)
    print(f"{cfg.name}: {api.num_params()/1e6:.1f}M params on "
          f"{mesh.size} device(s)")

    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=10,
                           total_steps=args.steps)
    state = opt.init(params)
    ccfg = comp.CompressionConfig(enable=args.compress)
    ef = comp.init_state(params) if args.compress else None

    if args.compress:
        def step(params, state, ef, batch):
            loss, _, grads = value_and_grad(api, params, batch,
                                            constrain=constrain, remat=remat)
            grads, ef = comp.compress_grads(grads, ef, ccfg)
            params, state, om = opt.update(ocfg, grads, state, params,
                                           donate=True)
            return params, state, ef, {"loss": loss, **om}
    else:
        base = make_train_step(api, ocfg, constrain=constrain, remat=remat,
                               donate=True)

    ck = (Checkpointer(args.ckpt_dir, async_save=True,
                       extent_policy=moments_low,
                       extent_backend=default_backend(dev), device=dev)
          if args.ckpt_dir else None)
    hb, sm = HeartbeatMonitor(), StragglerMonitor()
    it = data_mod.DataIterator(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch), device=dev)

    losses = []
    for i in range(args.steps):
        t0 = time.time()
        hb.beat("host0")
        batch = next(it)
        if args.compress:
            params, state, ef, m = step(params, state, ef, batch)
        else:
            params, state, m = base(params, state, batch)
        losses.append(float(m["loss"]))
        sm.record("host0", i, time.time() - t0)
        if ck and i and i % args.ckpt_every == 0:
            ck.save(i, {"params": params, "opt": state},
                    extra=it.state_dict())
        if i % 10 == 0:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.3f}")
    if ck:
        ck.wait()
    print(f"done: loss {np.mean(losses[:5]):.4f} -> "
          f"{np.mean(losses[-5:]):.4f}; stragglers={len(sm.flags)}")
    return {"losses": losses,
            "save_report": ck.last_save_report if ck else None,
            "stragglers": len(sm.flags)}


if __name__ == "__main__":
    main()
