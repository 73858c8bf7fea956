"""Paper Fig. 13: L2 write-transition access patterns (the counterpart of
``benchmarks/fig13_access.py``).

Two halves: (a) the paper's MiBench mixes (digitized), (b) *measured*
transition mixes of this framework's own write streams — the KV-cache
write of one decode step and the optimizer's first-moment update over
one train step of reduced qwen2.5-3b, taken at the leaves the reference
reads (the cache's first leaf, the moments' second: the final norm).
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core import cache_sim
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


def run(device=None):
    dev = resolve_device(device)
    out = {"mibench": {w: dict(m) for w, m in
                       cache_sim.FIG13_WORKLOADS.items()}}

    # measured: KV write stream of one decode step
    cfg = get_config("qwen2.5-3b").reduced()
    api = get_model(cfg)
    params = api.init(0, dev)
    toks = torch.from_numpy(rng.randint(rng.PRNGKey(1), (2, 12), 0,
                                        cfg.vocab_size)).long().to(dev)
    _, cache = api.prefill(params, {"tokens": toks}, 16)
    _, cache2 = api.decode_step(params, toks[:, 0], cache,
                                torch.full((2,), 12, device=dev), 16)
    m = cache_sim.trace_transition_mix(T.leaves(cache)[0],
                                       T.leaves(cache2)[0])
    out["kv_decode_stream"] = {
        "t01": m.t01, "t10": m.t10, "t00": m.t00, "t11": m.t11,
        "flip_fraction": m.flip_fraction,
        "expensive_share": m.expensive_share,
    }

    # measured: optimizer first-moment update stream over one train step
    ocfg = opt.AdamWConfig(warmup_steps=1, total_steps=10)
    state = opt.init(params)
    step = make_train_step(api, ocfg)
    dcfg = data_mod.DataConfig(cfg.vocab_size, 16, 4)
    _, state2, _ = step(params, state, data_mod.make_batch(dcfg, 0, dev))
    mm = cache_sim.trace_transition_mix(T.leaves(state.m)[1],
                                        T.leaves(state2.m)[1])
    out["optimizer_moment_stream"] = {
        "t01": mm.t01, "t10": mm.t10, "flip_fraction": mm.flip_fraction,
        "expensive_share": mm.expensive_share,
    }
    return out
