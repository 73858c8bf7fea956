"""Workload-mix frontier: every serving policy knob across the pressure
ramp (the counterpart of ``benchmarks/workload_mixes.py``).

The ``repro_torch.workload`` mix ramp (mix1 -> mixN ordered by measured
admissions x prompt length / slot dwell, ordering asserted) is replayed
through each policy arm:

  * **baseline**    — EXTENT approximation on, no extra machinery;
  * **floor_high**  — every request floor-raised to HIGH quality;
  * **scrub**       — retention decay on with periodic scrubbing (on the
                      card, the ``scrub`` kernel);
  * **wear_rotate** — wear-leveling rotation of the column map;
  * **prefix**      — the content-addressable prefix cache.

Per (mix, arm) cell the serve report is flattened into one frontier
table (``join_reports``). The claims: pressure shows as rising baseline
energy per step, the HIGH floor costs energy on every mix, the prefix
arm links on the shared-prefix mix, rotation engages at the top of the
ramp, scrubbing runs on every mix.

``adversarial()`` is the prefix x wear stress scenario: a shared-system-
prompt flood under the prefix cache pins one owner's physical columns
hot while an endurance budget counts down; identity addressing lets
those rows go stuck-at, the rotate policy migrates them first.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.reliability import make_scrub_policy, make_wear_policy
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.workload import TraceSource, build_ramp, join_reports
from repro_torch.workload.generators import shared_system_prompt
from repro_torch.workload.replay import flatten_report

CAPACITY = 3

#: the policy arms: ServeConfig overrides + per-run scheduler extras.
#: floor_high shares the baseline engine (the floor is a request-stream
#: property — TraceSource's quality override).
ARMS: Dict[str, Dict[str, Any]] = {
    "baseline": dict(scfg={}, engine="plain"),
    "floor_high": dict(scfg={}, engine="plain", quality="high"),
    "scrub": dict(scfg=dict(retention_scale=1000.0), engine="scrub",
                  scrub=dict(kind="periodic", interval=4)),
    "wear_rotate": dict(
        scfg=dict(wear_policy="rotate", remap_group_cols=4),
        engine="wear",
        wear=dict(check_interval=2, rotate_step=4, hot_row_wear=2)),
    "prefix": dict(scfg=dict(prefix_cache=True, prefix_chunk=8),
                   engine="prefix"),
}


def _scheduler(eng, arm: Dict[str, Any]) -> ContinuousScheduler:
    scrub = (make_scrub_policy(arm["scrub"]["kind"],
                               interval=arm["scrub"]["interval"])
             if "scrub" in arm else None)
    wear = (make_wear_policy("rotate", **arm["wear"])
            if "wear" in arm else None)
    return ContinuousScheduler(eng, capacity=CAPACITY,
                               scrub_policy=scrub, wear_policy=wear)


def frontier(cfg, ramp, arms: Sequence[str], device) -> Dict[str, Any]:
    """The joined (mix, arm) table of ``arms`` over ``ramp``: one slot-ring
    geometry for every cell, so cells compare."""
    max_seq = max(m["trace"].max_seq() for m in ramp)
    max_new = max(m["trace"].max_new_tokens() for m in ramp)
    engines: Dict[str, ServingEngine] = {}
    entries: List[Dict[str, Any]] = []
    for arm_name in arms:
        arm = ARMS[arm_name]
        if arm["engine"] not in engines:
            engines[arm["engine"]] = ServingEngine(cfg, ServeConfig(
                max_seq=max_seq, max_new_tokens=max_new, **arm["scfg"]),
                device=device)
        eng = engines[arm["engine"]]
        for m in ramp:
            report = _scheduler(eng, arm).run(TraceSource(
                m["trace"], cfg, device,
                quality_override=arm.get("quality")))
            entries.append({"mix": m["mix"], "name": m["name"],
                            "pressure": m["pressure"], "arm": arm_name,
                            "report": report})
    return join_reports(entries)


def run(events: int = 6, seed: int = 0, device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    cfg = get_config("qwen2.5-3b").reduced()
    ramp = build_ramp(cfg, seed=seed, n=events)
    assert len(ramp) >= 5, f"ramp too short: {len(ramp)} mixes"
    table = frontier(cfg, ramp, tuple(ARMS), dev)

    def cell(arm: str, mix_name: str) -> Dict[str, float]:
        return next(r for r in table["rows"]
                    if r["arm"] == arm and r["name"] == mix_name)

    def arm_rows(arm: str) -> List[Dict[str, float]]:
        return sorted((r for r in table["rows"] if r["arm"] == arm),
                      key=lambda r: r["mix"])

    base = arm_rows("baseline")
    floor = arm_rows("floor_high")
    bottom, top = base[0], base[-1]
    adv = adversarial(cfg, events=max(events, 6), seed=seed, device=dev)

    out = {
        "ramp": [{"mix": m["mix"], "name": m["name"],
                  "pressure": round(m["pressure"], 4),
                  "events": len(m["trace"])} for m in ramp],
        "table": table,
        "adversarial": adv,
        "claims": {
            "ramp_ge_5_mixes": len(ramp) >= 5,
            "ramp_pressure_monotone": all(
                a["pressure"] < b["pressure"]
                for a, b in zip(ramp, ramp[1:])),
            # pressure manifests: the top mix burns more write energy per
            # serving step than the bottom mix under the same policy
            "pressure_manifests_in_energy_rate":
                top["energy_pj_per_step"] > bottom["energy_pj_per_step"],
            # taking approximation headroom away costs energy on every
            # mix (>= per mix: the flood already runs HIGH), strictly
            # over the ramp
            "high_floor_costs_energy_per_mix": all(
                f["energy_pj"] >= b["energy_pj"] * (1 - 1e-9)
                for f, b in zip(floor, base)),
            "high_floor_costs_energy_total":
                sum(f["energy_pj"] for f in floor)
                > sum(b["energy_pj"] for b in base),
            # the reuse knob only pays where the mix shares prefixes
            "prefix_links_on_shared_mix":
                cell("prefix",
                     "shared_prefix_flood")["linked_admissions"] >= 1,
            # the endurance knob engages at the top of the ramp
            "wear_rotates_at_top_mix":
                cell("wear_rotate",
                     "shared_prefix_flood")["rotations"] >= 1,
            # scrubbing actually ran on every mix
            "scrub_passes_on_all_mixes": all(
                r["scrub_passes"] >= 1 for r in arm_rows("scrub")),
            **{f"adversarial_{k}": v for k, v in adv["claims"].items()},
        },
    }
    for name, ok in out["claims"].items():
        assert ok, (name, out["ramp"])
    return out


def adversarial(cfg=None, events: int = 6, seed: int = 0,
                budget: int = 10, device=None) -> Dict[str, Any]:
    """The prefix x wear stress scenario: a shared-system-prompt flood
    under the prefix cache and a finite endurance budget, wear leveling
    off against on. Every linked admission pins the same owner columns;
    with identity addressing those rows exhaust the budget and go
    stuck-at, the rotate policy migrates the hot prefix first. The
    default budget (10) sits between the two arms' peak wear on the
    default flood (identity 12, rotated 8); everything is seeded, so the
    separation is deterministic."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config("qwen2.5-3b").reduced()
    trace = shared_system_prompt(cfg, events, seed, shared_len=16,
                                 tail_len=4, new_tokens=2,
                                 arrival_every=1)

    def arm(policy: str) -> Dict[str, float]:
        eng = ServingEngine(cfg, ServeConfig(
            max_seq=trace.max_seq() + 4,
            max_new_tokens=trace.max_new_tokens(),
            prefix_cache=True, prefix_chunk=8,
            wear_policy=policy, endurance_budget=budget,
            remap_group_cols=4), device=dev)
        wp = (make_wear_policy("rotate", check_interval=1, rotate_step=4,
                               hot_row_wear=2) if policy == "rotate"
              else None)
        sch = ContinuousScheduler(eng, capacity=CAPACITY, wear_policy=wp)
        return flatten_report(sch.run(TraceSource(trace, cfg, dev)))

    none, rot = arm("none"), arm("rotate")
    return {
        "budget": budget,
        "events": events,
        "none": none,
        "rotate": rot,
        "claims": {
            "links_in_both_arms": (none["linked_admissions"] >= 1
                                   and rot["linked_admissions"] >= 1),
            "unleveled_rows_go_stuck_at": none["worn_groups"] > 0,
            "rotation_prevents_stuck_at": rot["worn_groups"] == 0,
            "rotation_engaged": rot["rotations"] >= 1,
        },
    }


def bench_metrics(out) -> dict:
    rows = out["table"]["rows"]

    def s(arm: str, key: str) -> float:
        return sum(r[key] for r in rows if r["arm"] == arm)

    adv = out["adversarial"]
    base_rows = sorted((r for r in rows if r["arm"] == "baseline"),
                       key=lambda r: r["mix"])
    return {
        "ramp_mixes": float(len(out["ramp"])),
        "pressure_bottom": out["ramp"][0]["pressure"],
        "pressure_top": out["ramp"][-1]["pressure"],
        "baseline_energy_rate_bottom":
            base_rows[0]["energy_pj_per_step"],
        "baseline_energy_rate_top": base_rows[-1]["energy_pj_per_step"],
        "high_floor_energy_overhead":
            s("floor_high", "energy_pj") / max(1e-12,
                                               s("baseline", "energy_pj"))
            - 1.0,
        "prefix_linked_admissions": s("prefix", "linked_admissions"),
        "wear_rotations_total": s("wear_rotate", "rotations"),
        "scrub_passes_total": s("scrub", "scrub_passes"),
        "adversarial_worn_groups_none": adv["none"]["worn_groups"],
        "adversarial_worn_groups_rotate": adv["rotate"]["worn_groups"],
        "adversarial_rotations": adv["rotate"]["rotations"],
        "ramp_monotone": out["claims"]["ramp_pressure_monotone"],
    }
