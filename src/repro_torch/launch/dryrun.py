"""Dry run on the meta device: trace every (arch x shape x mesh) cell
(the counterpart of ``repro.launch.dryrun``).

  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
  python -m repro_torch.launch.dryrun --smoke-backends [--device cpu]

For each cell this runs the real step function (the train step, the
prefill or one decode step) at the cell's full size on ``meta`` tensors:
parameters built from ``param_shapes()`` in ``param_dtype``, the batch
from ``batch_shapes()``, the cache from ``init_cache(..., "meta")``. No
tensor is ever allocated. ``torch.utils.flop_counter.FlopCounterMode``
counts the step's FLOPs (the whole step, remat recompute and optimizer
included), beside ``roofline.cell_flops``' analytic total. The reference lowers and compiles the cell for 256 or 512
devices and asks the compiler; the port has no compiler to ask, so:

  * ``memory.argument_bytes`` / ``output_bytes`` are reckoned per device
    from the port's sharding rules over the mesh's shape (each dimension
    divided by the sizes of the mesh axes its spec names, a dimension
    they do not divide replicated); the mesh holds placeholder ids, since
    only its shape matters to ``spec_for``. The traced step is the
    one-device program (no sharding constraint applies on meta).
  * ``temp_bytes`` / ``peak_bytes`` are None: meta tensors have no
    allocator to ask.
  * ``collectives`` are ``roofline.cell_collectives`` of the strategy
    the mesh and rules give, marked ``"source": "analytic"``: there is
    no HLO to parse.
  * ``trace_s`` takes the place of the reference's ``lower_s`` and
    ``compile_s``.

A cell whose path reaches a hand-written kernel cannot be traced on
meta (the wrappers take CPU or CUDA tensors only: recurrentgemma-2b's
prefill runs ``local_attention``); it is reported as such and skipped.

``--smoke-backends`` skips the sweep and drives one tiny EXTENT write
through every registered ``repro_torch.memory`` backend (bf16 and int8,
ragged shapes), cross-checking flip and energy parity. It runs on CUDA
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as T
from repro_torch.configs import SHAPES, all_cells, cell_is_runnable, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import roofline
from repro_torch.models import get_model
from repro_torch.sharding.mesh import Mesh, device_grid
from repro_torch.sharding.rules import _axis_size, spec_for, strategy_rules
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

META = torch.device("meta")

#: a (tensor, logical axes) pair; axes None: replicated
Placed = Tuple[torch.Tensor, Optional[Tuple[Optional[str], ...]]]


def input_specs(arch: str, shape_name: str):
    """(shape, dtype) of every model input of a cell."""
    cfg = get_config(arch)
    api = get_model(cfg)
    shp = SHAPES[shape_name]
    return api.batch_shapes(shp)


def dry_mesh(*, multi_pod: bool = False,
             shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """The production mesh's shape and axes, (data=16, model=16) or
    multi-pod (pod=2, 16, 16), over placeholder ids."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    elif multi_pod:
        shape = (2,) + tuple(shape)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(device_grid(list(range(math.prod(shape))), tuple(shape)),
                axes)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def meta_params(api) -> Tuple[Any, List[Placed]]:
    """(the parameter tree on meta, its leaves with their axes)."""
    tdef = T.structure(api.descs())
    leaves = [_meta(s, api.param_dtype)
              for s in tdef.flatten_up_to(api.param_shapes())]
    return (tdef.unflatten(leaves),
            list(zip(leaves, tdef.flatten_up_to(api.param_axes()))))


def cache_placed(api, cache) -> List[Placed]:
    """A cache tree's leaves with ``cache_axes()``'s axes."""
    return list(zip(T.leaves(cache),
                    T.structure(cache).flatten_up_to(api.cache_axes())))


def replicated(tree) -> List[Placed]:
    return [(t, None) for t in T.leaves(tree)
            if isinstance(t, torch.Tensor)]


def device_bytes(mesh: Mesh, rules, placed: Sequence[Placed]) -> int:
    """Bytes one device holds of ``placed``: each tensor's bytes over the
    product of the mesh axes its spec shards it on."""
    total = 0
    for t, axes in placed:
        nbytes = t.numel() * t.element_size()
        if axes is not None:
            spec = spec_for(mesh, rules, axes, tuple(t.shape))
            nbytes //= math.prod(_axis_size(mesh, a) for a in spec)
        total += nbytes
    return total


@dataclasses.dataclass(frozen=True)
class Cell:
    """A cell's step: ``fn(*args)`` on meta, its inputs with their axes
    and ``out_placed(out)``, its outputs with theirs; ``cfg`` and ``api``
    are the config and model it was built from."""
    cfg: Any
    api: Any
    fn: Callable
    args: Tuple
    in_placed: List[Placed]
    out_placed: Callable[[Any], List[Placed]]


def build_cell(arch: str, shape_name: str, remat=True) -> Cell:
    """The train step, prefill or decode step of one cell, on meta."""
    cfg = get_config(arch)
    api = get_model(cfg)
    shp = SHAPES[shape_name]
    params, p_placed = meta_params(api)

    def as_params(tree) -> List[Placed]:
        return [(t, a) for t, (_, a) in zip(T.leaves(tree), p_placed)]

    if shp.kind == "train":
        batch = {k: _meta(s, d) for k, (s, d) in api.batch_shapes(shp).items()}
        b_axes = api.batch_axes(shp)
        b_placed = [(batch[k], b_axes[k]) for k in sorted(batch)]
        state = opt.init(params)
        step = make_train_step(api, opt.AdamWConfig(), remat=remat)

        def opt_placed(st) -> List[Placed]:
            return [(st.step, None)] + as_params(st.m) + as_params(st.v)

        def out_placed(out) -> List[Placed]:
            p2, s2, metrics = out
            return as_params(p2) + opt_placed(s2) + replicated(metrics)

        return Cell(cfg, api, step, (params, state, batch),
                    p_placed + opt_placed(state) + b_placed, out_placed)

    max_seq = shp.seq_len

    def logits_and_cache(out) -> List[Placed]:
        logits, cache = out[0], out[1]
        return replicated(logits) + cache_placed(api, cache)

    if shp.kind == "prefill":
        batch = {k: _meta(s, d) for k, (s, d) in api.batch_shapes(shp).items()}
        b_axes = api.batch_axes(shp)

        def prefill_fn(params, batch):
            return api.prefill(params, batch, max_seq)
        return Cell(cfg, api, prefill_fn, (params, batch),
                    p_placed + [(batch[k], b_axes[k]) for k in sorted(batch)],
                    logits_and_cache)

    # decode: one new token against a seq_len-deep cache
    B = shp.global_batch
    cache = api.init_cache(B, max_seq, META)
    token = _meta((B,), torch.int64)
    pos = _meta((B,), torch.int64)

    def decode_fn(params, token, cache, pos):
        return api.decode_step(params, token, cache, pos, max_seq)
    return Cell(cfg, api, decode_fn, (params, token, cache, pos),
                p_placed + [(token, ("batch",))] + cache_placed(api, cache)
                + [(pos, ("batch",))], logits_and_cache)


def cell_strategy(mesh: Mesh, rules, rules_name: str
                  ) -> roofline.Strategy:
    """The roofline strategy of a mesh and rules: data parallel over
    (pod, data), tensor parallel over model, parameters FSDP-sharded
    while the rules shard ``embed``."""
    shape = mesh.shape
    fsdp = rules.get("embed") is not None
    return dataclasses.replace(
        roofline.BASELINE, name=rules_name,
        dp=shape.get("pod", 1) * shape["data"], tp=shape["model"],
        serve_fsdp=fsdp, fsdp_params=fsdp)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             tag: str = "baseline", mesh_shape=None,
             rules_name: str = "baseline", remat=True) -> Dict[str, Any]:
    """Trace one cell on meta; write and return its record."""
    mesh = dry_mesh(multi_pod=multi_pod, shape=mesh_shape)
    n_dev = mesh.size
    rules = strategy_rules(mesh, rules_name)
    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, remat=remat)
    with FlopCounterMode(display=False) as fc:
        out = cell.fn(*cell.args)
    trace_s = time.perf_counter() - t0
    mesh_label = "x".join(str(s) for s in mesh.devices.shape)
    cfg, api = cell.cfg, cell.api
    strat = cell_strategy(mesh, rules, rules_name)
    flops = float(fc.get_total_flops())
    analytic = roofline.cell_flops(cfg, SHAPES[shape_name])["total"]
    rec = {"arch": arch, "shape": shape_name, "tag": tag,
           "mesh": ("pod" + mesh_label) if multi_pod else mesh_label,
           "rules": rules_name, "remat": str(remat),
           "n_devices": n_dev, "device": "meta",
           "trace_s": round(trace_s, 2),
           "memory": {
               "argument_bytes": device_bytes(mesh, rules, cell.in_placed),
               "output_bytes": device_bytes(mesh, rules,
                                            cell.out_placed(out)),
               "temp_bytes": None, "peak_bytes": None},
           "cost": {"flops": flops, "analytic_flops": analytic,
                    "flops_over_analytic": flops / analytic},
           "collectives": {
               "source": "analytic",
               "strategy": dataclasses.asdict(strat),
               "wire_bytes_per_device": roofline.cell_collectives(
                   cfg, SHAPES[shape_name], strat)},
           "num_params": api.num_params(),
           "active_params": api.active_params_per_token()}
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape_name}__{rec['mesh']}__{tag}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=1))
    return rec


def _no_meta_kernel(err: Exception) -> bool:
    """A kernel wrapper refused the meta device: a hand-written kernel
    lies on the cell's path."""
    return isinstance(err, ValueError) and "unsupported device meta" in str(
        err)


def smoke_backends(device=None) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Tiny write through every registered memory backend + parity check
    (on CUDA unless ``device='cpu'``). Returns, per case and backend, the
    report's flips, energy and errors and the stored tensor."""
    from repro_torch import memory, rng
    from repro_torch.core.priority import Priority
    dev = resolve_device(device)
    key = rng.PRNGKey(0)
    cases = [
        ("bf16", torch.from_numpy(rng.normal(rng.PRNGKey(1), (33,))
                                  ).to(torch.bfloat16)),
        ("int8", torch.from_numpy(rng.randint(rng.PRNGKey(2), (129,),
                                              -128, 128)).to(torch.int8)),
    ]
    out: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for label, new in cases:
        new = new.to(dev)
        old = torch.zeros_like(new)
        res = out[label] = {}
        for name in memory.available_backends():
            stored, st = memory.write(key, old, new, level=Priority.LOW,
                                      backend=name)
            h = st.host_dict()
            res[name] = {"flips": h["bits_written"],
                         "energy_pj": h["energy_pj"],
                         "errors": h["bit_errors"], "stored": stored}
            print(f"OK backend={name:10s} dtype={label:5s} "
                  f"flips={h['bits_written']:5d} E={h['energy_pj']:9.1f} pJ "
                  f"errors={h['bit_errors']}")
        modeled = [n for n in res if n != "exact"]
        flips = {n: res[n]["flips"] for n in modeled}
        energy = [res[n]["energy_pj"] for n in modeled]
        if len(set(flips.values())) != 1:
            raise AssertionError(f"{label}: flips differ across backends: "
                                 f"{flips}")
        if max(energy) - min(energy) > 1e-4 * max(energy):
            raise AssertionError(f"{label}: energies differ across backends "
                                 f"by more than 1e-4: {energy}")
    print(f"all {len(memory.available_backends())} backends OK")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke-backends", action="store_true",
                    help="smoke-run every registered repro_torch.memory "
                         "backend and exit (no sweep)")
    ap.add_argument("--device", default=None,
                    help="--smoke-backends' torch device (default cuda; "
                         "'cpu' to ask for the CPU)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--mesh-shape", default=None,
                    help="override intra-pod (data,model), e.g. 64x4")
    ap.add_argument("--rules", default="baseline",
                    help="sharding strategy name (see sharding/rules.py)")
    ap.add_argument("--remat", default="full",
                    choices=("full", "selective", "none"))
    args = ap.parse_args(argv)
    if args.smoke_backends:
        smoke_backends(args.device)
        return
    out_dir = Path(args.out)
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)
    remat = {"full": True, "selective": "selective", "none": False}[args.remat]

    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])
    failures = []
    for arch, shape in cells:
        if not cell_is_runnable(arch, shape):
            print(f"SKIP {arch} x {shape} (not a runnable cell)")
            continue
        base = "x".join(str(s) for s in (mesh_shape or (16, 16)))
        mesh_name = ("pod2x" + base) if args.multi_pod else base
        path = out_dir / f"{arch}__{shape}__{mesh_name}__{args.tag}.json"
        if args.skip_existing and path.exists():
            print(f"CACHED {arch} x {shape} x {mesh_name}")
            continue
        try:
            rec = run_cell(arch, shape, args.multi_pod, out_dir,
                           tag=args.tag, mesh_shape=mesh_shape,
                           rules_name=args.rules, remat=remat)
            print(f"OK {arch} x {shape} x {mesh_name}: "
                  f"trace={rec['trace_s']}s "
                  f"flops={rec['cost']['flops']:.3e} "
                  f"(x{rec['cost']['flops_over_analytic']:.3f} analytic) "
                  f"args/dev={rec['memory']['argument_bytes']}")
        except Exception as e:  # record, keep sweeping
            if _no_meta_kernel(e):
                print(f"SKIP {arch} x {shape} x {mesh_name}: a kernel on "
                      f"the path takes no meta tensor ({e})")
                continue
            failures.append((arch, shape, repr(e)))
            print(f"FAIL {arch} x {shape} x {mesh_name}: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall cells OK")


if __name__ == "__main__":
    main()
