"""Endurance frontier: wear-leveling remap on/off under a hot-row workload
(the counterpart of ``benchmarks/endurance_sweep.py``).

A deliberately hot column-write workload goes through the memory
substrate twice — identity addressing against the rotate wear policy —
and measures what the physical addressing layer
(``repro_torch.memory.address``) buys:

  * **hot-row worst-case wear**: the largest per-physical-row-group write
    count after N steps (rotate must be strictly lower);
  * **time-to-first-worn-row**: steps until some group exhausts the
    endurance budget and goes stuck-at (rotate must survive longer);
  * **remap energy overhead**: the migration writes the leveling costs,
    as a fraction of the data-write energy.

It runs on the memory substrate only (no model), so every count is
deterministic: each step's new data is ``normal(fold_in(PRNGKey(11),
t))`` drawn on the host (bit-exact with ``jax.random.normal``) and moved
to the device. Asserted claims land in ``out["claims"]``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import rng
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device
from repro_torch.memory import (AddressSpec, WritePlan, WriteStats,
                                default_backend)
from repro_torch.reliability import LifetimePlan, make_wear_policy

#: the one ring leaf, named ``v`` so the KV policy writes it at LOW (the
#: reference's plan writes its ``kv`` leaf at LOW by an explicit policy)
_AXES = {"v": ("layers", "batch", "kv_seq", "head_dim")}


def _run_arm(steps: int, shape: Tuple[int, int], *, rotate: bool,
             group_cols: int, budget: int, backend: str,
             device: torch.device) -> Dict[str, float]:
    B, C = 2, shape[1]
    tree = {"v": torch.zeros((1, B, C, shape[0]), dtype=torch.bfloat16,
                             device=device)}
    spec = AddressSpec(group_cols=group_cols, endurance_budget=budget)
    plan = WritePlan.for_tree(tree, device=device, backend=backend,
                              axes=_AXES, address_spec=spec)
    vectors = plan.vectors_for(Priority.LOW)
    lp = LifetimePlan.for_tree(tree, plan)
    # hot_row_wear sets the leveling/overhead tradeoff: rotating every 16
    # hot writes keeps the migration traffic below the data-write energy
    # while still capping per-group wear at about a rotation period
    policy = make_wear_policy("rotate" if rotate else "none",
                              check_interval=4, rotate_step=group_cols,
                              hot_row_wear=16)
    addr = plan.identity_address()
    rotatable = torch.tensor(plan.rotatable(), device=device)
    state = lp.init_state(tree)
    data = tree
    active = torch.ones((B,), dtype=torch.bool, device=device)
    acc = WriteStats.zero(device)

    remap_pj = 0.0
    ttfw = None
    gap = 0
    # the serving scheduler and this benchmark price rotations through
    # the same source: WritePlan.migration_cost
    cost_pj, _ = plan.migration_cost(tree)
    for t in range(1, steps + 1):
        k = rng.fold_in(rng.PRNGKey(11), t)
        new = {p: torch.from_numpy(rng.normal(k, tuple(a.shape))).to(
            a.dtype).to(device) for p, a in data.items()}
        # hot-row traffic: every slot hammers the same 4 ring columns
        pos = torch.full((B,), t % 4, dtype=torch.int64, device=device)
        worn = lp.worn_groups(state)
        data, st = plan.write_columns(k, data, new, pos, vectors,
                                      addr=(addr.shifts, worn))
        state = lp.record_column_write(state, data, pos, active,
                                       addr.shifts)
        acc = acc + st
        wear = state.row_wear().cpu().numpy()
        if ttfw is None and budget > 0 and wear.max() >= budget:
            ttfw = t
        if t % policy.check_interval == 0 and policy.plan_rotation(t, wear):
            addr = addr.rotate(rotatable, policy.rotate_step)
            remap_pj += cost_pj
            # migration re-writes consume endurance too (the gap window)
            state = lp.record_migration(state, data, gap,
                                        policy.rotate_step)
            gap += policy.rotate_step
            policy.record(t, wear)
    h = acc.host_dict()
    wear = state.row_wear().cpu().numpy()
    worn = lp.worn_groups(state)
    return {
        "max_group_wear": float(wear.max()),
        "mean_group_wear": float(wear[wear > 0].mean()) if wear.any()
        else 0.0,
        "time_to_first_worn": float(ttfw if ttfw is not None
                                    else steps + 1),
        "worn_groups": float(worn.sum()) if worn is not None else 0.0,
        "rotations": float(policy.rotations),
        "write_energy_pj": h["energy_pj"],
        "remap_energy_pj": remap_pj,
        "stuck_at_errors": float(h["bit_errors"]),
    }


def run(steps: int = 160, shape: Tuple[int, int] = (8, 64), *,
        group_cols: int = 4, budget: int = 0, backend=None,
        device=None) -> Dict:
    """The frontier: identity addressing against the rotate wear policy
    on the same hot-row workload. ``backend`` defaults to the device's
    (``cuda`` on the card, ``lanes_ref`` on the CPU)."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if budget <= 0:
        budget = max(8, steps // 3)  # both arms can exhaust it un-leveled
    kw = dict(group_cols=group_cols, budget=budget, backend=backend,
              device=dev)
    none = _run_arm(steps, shape, rotate=False, **kw)
    rot = _run_arm(steps, shape, rotate=True, **kw)
    overhead = (rot["remap_energy_pj"]
                / max(rot["write_energy_pj"], 1e-9))
    claims = {
        # the acceptance criterion: leveling strictly lowers worst wear
        "rotate_lowers_max_wear":
            rot["max_group_wear"] < none["max_group_wear"],
        "rotate_survives_longer":
            rot["time_to_first_worn"] > none["time_to_first_worn"],
        "remap_overhead_visible_and_bounded":
            0.0 < overhead < 1.0,
        "unleveled_rows_wear_out": none["worn_groups"] > 0,
    }
    assert all(claims.values()), claims
    return {"steps": steps, "budget": budget, "group_cols": group_cols,
            "backend": backend, "none": none, "rotate": rot,
            "wear_leveling_gain": none["max_group_wear"]
            / max(rot["max_group_wear"], 1.0),
            "remap_overhead_frac": overhead,
            "claims": claims}


def bench_metrics(out: Dict) -> Dict[str, float]:
    """Registration hook for the runner's BENCH_<n>.json report."""
    m = {
        "wear_leveling_gain": out["wear_leveling_gain"],
        "remap_overhead_frac": out["remap_overhead_frac"],
        "max_group_wear_none": out["none"]["max_group_wear"],
        "max_group_wear_rotate": out["rotate"]["max_group_wear"],
        "time_to_first_worn_none": out["none"]["time_to_first_worn"],
        "time_to_first_worn_rotate": out["rotate"]["time_to_first_worn"],
        "rotations": out["rotate"]["rotations"],
        "remap_energy_pj": out["rotate"]["remap_energy_pj"],
        "stuck_at_errors_none": out["none"]["stuck_at_errors"],
    }
    m.update({f"claim.{k}": v for k, v in out["claims"].items()})
    return m
