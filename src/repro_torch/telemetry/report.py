"""One rendering path for the serve report.

Before this module, ``launch/serve.py`` hand-assembled its printed
report from the scheduler's summary dict section by section — so a field
added in the scheduler needed a parallel edit in the launcher or it
silently never surfaced. ``render_report`` is now the single renderer:
every known section keeps its exact established line format (CI lanes
grep these lines), and any summary key the renderer does NOT know is
printed through a generic fallback instead of being dropped. Adding a
section to the scheduler's report therefore shows up in the launcher
output by default; giving it a pretty format is optional.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

#: summary keys with a dedicated renderer below
_HANDLED = ("requests", "total", "extent_table", "prefix", "lifetime",
            "wear", "telemetry", "sharding")
#: summary keys folded into the header / totals lines (not standalone)
_INLINE = ("streams", "pool", "clock_steps", "decode_steps", "bursts")


def _header_lines(report: Dict[str, Any]) -> List[str]:
    return [f"served {len(report['requests'])} requests in "
            f"{report['clock_steps']} steps "
            f"({report['bursts']} compiled decode bursts, pool "
            f"{report['pool']['capacity']} slots, peak occupancy "
            f"{report['pool']['peak_occupancy']})"]


def _request_lines(report: Dict[str, Any]) -> List[str]:
    out = []
    for rid in sorted(report["requests"]):
        r = report["requests"][rid]
        out.append(
            f"  req {rid} app={str(r['app_id']):10s} q={r['quality']:5s} "
            f"arrived {r['arrival_step']:3d} queued {r['queue_steps']:2d} "
            f"latency {r['latency_steps']:3d} tokens {r['n_tokens']:3d} "
            f"E={r['energy_pj']/1e3:8.1f} nJ BER={r['ber']:.2e}")
    return out


def _extent_lines(report: Dict[str, Any], opts: Dict[str, Any]
                  ) -> List[str]:
    tot = report["total"]
    tbl = report["extent_table"]
    backend = opts.get("backend", "?")
    label = ("KV energy (all streams)" if "lifetime" in report
             else "KV write energy")
    out = [f"{label} {tot['energy_pj']/1e6:.3f} uJ "
           f"(backend={backend}), "
           f"skip-rate {tot['write_skip_rate']:.3f}, "
           f"BER {tot['ber_realized']:.2e}"]
    if opts.get("soft_error_ber", 0.0) > 0:
        hardened = opts.get("soft_error_hardened", True)
        out.append(f"soft errors: {tot['soft_strikes']} strikes at "
                   f"BER {opts['soft_error_ber']:.1e} "
                   f"({'hardened' if hardened else 'unhardened'} driver)")
    # headline = SERVE-scope traffic only: folding background scrub
    # lookups (near-100% hits) into the hit rate is exactly the
    # double-counting the scope accumulator exists to prevent
    srv = tbl.get("scopes", {}).get(
        "serve", {"hits": tbl["hits"], "misses": tbl["misses"],
                  "evictions": tbl["evictions"]})
    n_srv = srv["hits"] + srv["misses"]
    out.append(f"EXTENT table (serve): {srv['hits']} hits / "
               f"{srv['misses']} misses "
               f"(hit rate {srv['hits'] / n_srv if n_srv else 0.0:.2f}), "
               f"{srv['evictions']} evictions")
    for scope, c in sorted(tbl.get("scopes", {}).items()):
        if scope != "serve":
            out.append(f"  [{scope}] {c['hits']} hits / "
                       f"{c['misses']} misses")
    return out


def _prefix_lines(report: Dict[str, Any]) -> List[str]:
    p = report["prefix"]
    return [
        f"prefix cache (chunk {p['chunk']}, table "
        f"{p['table_size']}): hits={p['hits']} "
        f"misses={p['misses']} (hit rate {p['hit_rate']:.2f}), "
        f"{p['linked_admissions']} linked admissions "
        f"({p['linked_cols']} cols), {p['stale_drops']} stale "
        f"drops, {p['evictions']} evictions",
        f"  write energy saved {p['write_energy_saved_pj']/1e3:.1f}"
        f" nJ - cow {p['cow_energy_pj']/1e3:.1f} nJ "
        f"({p['cow_events']} events) - cam search "
        f"{p['cam_energy_pj']/1e3:.3f} nJ = net "
        f"{p['net_energy_saved_pj']/1e3:.1f} nJ"]


def _lifetime_lines(report: Dict[str, Any]) -> List[str]:
    lt = report["lifetime"]
    return [f"lifetime ledger @ {lt['ambient_k']:.0f} K "
            f"(dwell {lt['dwell_s_per_step']:.0f} s/step, "
            f"policy {lt['scrub_policy']}): "
            f"write {lt['write_energy_pj']/1e6:.3f} uJ + "
            f"scrub {lt['scrub_energy_pj']/1e6:.3f} uJ + "
            f"remap {lt['remap_energy_pj']/1e6:.3f} uJ = "
            f"{lt['lifetime_energy_pj']/1e6:.3f} uJ; "
            f"{lt['retention_flips']} retention flips, "
            f"{lt['residual_decayed_bits']} still decayed after "
            f"{lt['scrub_passes']} scrub passes"]


def _wear_lines(report: Dict[str, Any]) -> List[str]:
    w = report["wear"]
    return [f"wear leveling (policy {w['policy']}, group "
            f"{w['group_cols']} cols, budget "
            f"{w['endurance_budget'] or 'unbounded'}): "
            f"rotations={w['rotations']}, "
            f"max group wear {w['max_group_wear']}, "
            f"worn groups {w['worn_groups']}, "
            f"remap {w['remap_energy_pj']/1e6:.3f} uJ"]


def _sharding_lines(report: Dict[str, Any]) -> List[str]:
    s = report["sharding"]
    out = [f"sharding: {s['shards']} dies x {s['slots_per_die']} slots "
           f"({s['mesh_devices']} device"
           f"{'s' if s['mesh_devices'] != 1 else ''})"]
    for d in s["dies"]:
        line = (f"  die {d['die']}: slots [{d['slots'][0]},"
                f"{d['slots'][1]}) ambient {d['ambient_k']:.0f} K "
                f"E={d['energy_pj']/1e3:.1f} nJ "
                f"flips={d['flips']:.0f} errors={d['errors']:.0f} "
                f"scrubs={d['scrub_passes']}")
        if "decayed_bits" in d:
            line += f" decayed={d['decayed_bits']}"
        if "max_group_wear" in d:
            line += f" wear={d['max_group_wear']}"
        out.append(line)
    return out


def _telemetry_lines(report: Dict[str, Any]) -> List[str]:
    t = report["telemetry"]
    return [f"telemetry: {t['events']} events, {t['spans']} spans, "
            f"{t['metrics']['drains']} instrument drains "
            f"({t['drains_per_event']:.2f}/event)"]


def _fallback_lines(report: Dict[str, Any]) -> List[str]:
    """Every summary key without a dedicated renderer still surfaces —
    compact but lossless, so new scheduler sections are visible by
    default instead of silently dropped."""
    out = []
    for key in report:
        if key in _HANDLED or key in _INLINE:
            continue
        out.append(f"[{key}] "
                   + json.dumps(report[key], sort_keys=True, default=str))
    return out


def render_report(report: Dict[str, Any], **opts: Any) -> List[str]:
    """Render a ``ContinuousScheduler.run`` summary as printable lines.

    Options: ``backend`` (label in the energy line), ``show_extent``
    (the totals/table block), ``soft_error_ber`` /
    ``soft_error_hardened`` (the soft-error line).
    """
    lines = _header_lines(report)
    lines += _request_lines(report)
    if opts.get("show_extent", True):
        lines += _extent_lines(report, opts)
    if "prefix" in report:
        lines += _prefix_lines(report)
    if "lifetime" in report:
        lines += _lifetime_lines(report)
    if "wear" in report:
        lines += _wear_lines(report)
    if "sharding" in report:
        lines += _sharding_lines(report)
    if "telemetry" in report:
        lines += _telemetry_lines(report)
    lines += _fallback_lines(report)
    return lines
