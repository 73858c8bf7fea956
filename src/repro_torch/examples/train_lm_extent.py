"""End-to-end training example: a small qwen2.5-family LM trained for a
few hundred steps with the whole training substrate — the synthetic data
pipeline, AdamW, error-feedback int8 gradients, straggler monitoring and
EXTENT-approximate fault-tolerant checkpoints (weights EXACT, first
moments LOW) — killed and restored mid-run to show the recovery path.

  PYTHONPATH=src python -m repro_torch.examples.train_lm_extent \
      [--steps 300] [--dim 256] [--device cuda|cpu]

The counterpart of ``examples/train_lm_extent.py``: a checkpoint every 50
steps, a simulated preemption at ``steps // 2`` that restores the last
one (parameters, optimizer state and the data cursor), and the "must
learn" check at the end. Checkpoints go to ``--ckpt-dir`` (default: a
temporary directory, removed at the end) through the device's backend:
``cuda`` (the kernel) on the card, ``lanes_ref`` on the CPU.
"""
import argparse
import dataclasses
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core.priority import Priority, keystr
from repro_torch.device import resolve_device
from repro_torch.memory import default_backend
from repro_torch.models import get_model
from repro_torch.train import compression as comp
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import StragglerMonitor
from repro_torch.train.train_step import value_and_grad


def build_cfg(dim: int):
    base = get_config("qwen2.5-3b")
    return dataclasses.replace(
        base, name=f"qwen-mini-{dim}", num_layers=4, d_model=dim,
        num_heads=8, num_kv_heads=2, head_dim=dim // 8, d_ff=dim * 4,
        vocab_size=8192, param_dtype="float32", compute_dtype="float32")


def policy(path, leaf) -> Priority:
    """The reference example's policy: first moments (and any leaf under
    a sequence index 1) LOW, the rest EXACT."""
    return (Priority.LOW if "[1]" in str(path[0]) or ".m" in keystr(path)
            else Priority.EXACT)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_cfg(args.dim)
    api = get_model(cfg)
    print(f"model {cfg.name}: {api.num_params()/1e6:.1f}M params")

    params = api.init(0, dev)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                           weight_decay=0.01)
    state = opt.init(params)
    ef = comp.init_state(params)
    ccfg = comp.CompressionConfig(enable=args.compress)

    def step(params, state, ef, batch):
        loss, _, grads = value_and_grad(api, params, batch)
        grads, ef = comp.compress_grads(grads, ef, ccfg)
        params, state, om = opt.update(ocfg, grads, state, params,
                                       donate=True)
        return params, state, ef, {"loss": loss, **om}

    dcfg = data_mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, seed=11)
    it = data_mod.DataIterator(dcfg, device=dev)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="extent_ckpt_")
    ck = Checkpointer(ckpt_dir, keep_last=2, async_save=True,
                      extent_policy=policy,
                      extent_backend=default_backend(dev), device=dev)
    straggler = StragglerMonitor()

    losses = []
    killed = False
    t_start = time.time()
    i = 0
    try:
        while i < args.steps:
            t0 = time.time()
            batch = next(it)
            params, state, ef, m = step(params, state, ef, batch)
            losses.append(float(m["loss"]))
            straggler.record("host0", i, time.time() - t0)
            if i % 50 == 0:
                ck.save(i, {"params": params, "opt": state},
                        extra=it.state_dict())
                ck.wait()
                rep = ck.last_save_report
                print(f"step {i:4d} loss={losses[-1]:.4f} "
                      f"ckpt: {rep['bytes']/1e6:.1f}MB "
                      f"E={rep['energy_pj']/1e6:.2f}uJ "
                      f"skipped={rep['skipped_leaves']} "
                      f"bit_errors={rep['bit_errors']}")
            # a preemption mid-run: restore from the last checkpoint
            if i == args.steps // 2 and not killed:
                killed = True
                print(f"step {i:4d} !! simulated preemption -> restore")
                like = T.tree_map(lambda x: torch.empty(
                    x.shape, dtype=x.dtype, device="meta"),
                    {"params": params, "opt": state})
                restored, extra = ck.restore(like)
                params, state = restored["params"], restored["opt"]
                it.load_state_dict(extra)
                i = it.step
                continue
            i += 1
    finally:
        ck.wait()
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    dt = time.time() - t_start
    toks = args.steps * args.batch * args.seq
    print(f"\nfinal loss {np.mean(losses[-10:]):.4f} "
          f"(first-10 {np.mean(losses[:10]):.4f}); "
          f"{toks/dt:.0f} tok/s on {dev.type}; stragglers flagged: "
          f"{len(straggler.flags)}")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "must learn"
    print("OK")


if __name__ == "__main__":
    main()
