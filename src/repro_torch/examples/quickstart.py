"""Quickstart: the EXTENT approximate-memory subsystem in one run.

  PYTHONPATH=src python -m repro_torch.examples.quickstart \
      [--device cuda|cpu] [--backend NAME] [--scrub-policy periodic]
      [--ambient-k 350] [--retention-scale 10000] [--wear-policy rotate]

The counterpart of ``examples/quickstart.py``. Walks the stack bottom
up: WER physics, the four driver levels, the memory substrate (one write
API, every registered backend), a memory region, a priority-tagged tree,
the reliability time axis (retention decay and scrub passes at
``--ambient-k``, scheduled by ``--scrub-policy``) and, with
``--wear-policy rotate``, wear leveling over the physical address map.
Without ``--backend`` section 3 sweeps the registry: on the card
``cuda`` (the kernel) with the rest, on the CPU every backend but
``cuda``, whose kernel needs the card. Sections 4, 5, 7 and 8 use the
chosen backend, or the device's (``cuda`` on the card, ``lanes_ref`` on
the CPU).
"""
import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch import memory, rng
from repro_torch.core import Priority, default_driver, tag_pytree, wer_bit
from repro_torch.device import resolve_device
from repro_torch.reliability import make_scrub_policy, retention_flip_p


def _normal(key, shape, dtype, device) -> torch.Tensor:
    """``jax.random.normal(key, shape).astype(dtype)``, drawn on the host."""
    return torch.from_numpy(rng.normal(key, shape)).to(dtype).to(device)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                    "cpu")
    ap.add_argument("--backend", default=None,
                    choices=memory.available_backends(),
                    help="one repro_torch.memory backend (default: sweep "
                         "the registry)")
    ap.add_argument("--scrub-policy", default="periodic",
                    choices=("none", "periodic", "wear_aware",
                             "quality_floor"),
                    help="scrub scheduling policy of the reliability demo")
    ap.add_argument("--ambient-k", type=float, default=350.0,
                    help="die temperature (kelvin) of the reliability demo")
    ap.add_argument("--retention-scale", type=float, default=10_000.0,
                    help="modelled dwell seconds per demo step")
    ap.add_argument("--wear-policy", default="none",
                    choices=("none", "rotate"),
                    help="wear-leveling demo: rotate the logical->physical "
                         "column map when hot-row wear concentrates")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    backends = ([args.backend] if args.backend else
                [b for b in memory.available_backends()
                 if dev.type == "cuda" or b != "cuda"])
    demo = args.backend or memory.default_backend(dev)

    print("== 1. WER physics (paper Eq. 1) ==")
    for i_rel in (1.2, 1.5, 1.8):
        print(f"  WER(10ns, I/Ic={i_rel}, delta=60) = "
              f"{float(wer_bit(10e-9, i_rel, 60.0)):.3e}")

    print("\n== 2. the four driver levels (Table 1 calibration) ==")
    for lv in default_driver():
        print(f"  {lv.name:12s} code={lv.code:02b} wer01={lv.wer_0to1:.2e} "
              f"e01={lv.e_0to1_pj:.2f}pJ lat={lv.latency_ns:.2f}ns")

    print(f"\n== 3. the memory substrate: one write API, every backend "
          f"({dev.type}) ==")
    key = rng.PRNGKey(0)
    old = torch.zeros((256, 256), dtype=torch.bfloat16, device=dev)
    new = _normal(rng.PRNGKey(1), (256, 256), torch.bfloat16, dev)
    for name in backends:
        stored, st = memory.write(key, old, new, level=Priority.LOW,
                                  backend=name)
        h = st.host_dict()
        err = torch.mean(torch.abs(stored.to(torch.float32)
                                   - new.to(torch.float32)))
        print(f"  {name:10s}: energy={h['energy_pj']/1e3:7.1f} nJ  "
              f"flips={h['bits_written']:6d}  errors={h['bit_errors']:5d}  "
              f"mean|err|={float(err):.5f}")

    print(f"\n== 4. level sweep: the levels are operands "
          f"(backend={demo}) ==")
    for level in (Priority.LOW, Priority.MID, Priority.EXACT):
        _, st = memory.write(key, old, new, level=level, backend=demo)
        h = st.host_dict()
        print(f"  {level.name:6s}: energy={h['energy_pj']/1e3:7.1f} nJ  "
              f"BER={h['ber_realized']:.2e}")

    print("\n== 5. a memory region ==")
    region = memory.MemoryRegion.create(
        {"kv": {"k": old, "v": old}}, level=Priority.LOW, backend=demo)
    region = region.write(rng.PRNGKey(2), {"kv": {"k": new, "v": new}})
    region = region.write(rng.PRNGKey(3), {"kv": {"k": new, "v": new}})
    rep = region.report()
    print(f"  2 writes (2nd redundant): E={rep['energy_pj']/1e3:.1f} nJ "
          f"skip-rate={rep['write_skip_rate']:.3f} "
          f"backend={rep['backend']}")

    print("\n== 6. priority tagging (the software API, Fig. 10/11) ==")
    state = {"weights": new, "kv": {"k": old, "v": old},
             "moments": {"m": old, "v2": old}}
    tags = tag_pytree(state, lambda path, leaf: (
        Priority.LOW if "moments" in str(path[0]) else
        Priority.MID if "kv" in str(path[0]) else Priority.EXACT))
    print(" ", {k: ({kk: t.name for kk, t in v.items()}
                    if isinstance(v, dict) else v.name)
                for k, v in tags.items()})

    print(f"\n== 7. reliability: retention decay + scrubbing "
          f"@ {args.ambient_k:.0f} K (policy={args.scrub_policy}) ==")
    p_low = retention_flip_p(Priority.LOW, args.ambient_k,
                             args.retention_scale)
    print(f"  LOW-plane decay p per step "
          f"({args.retention_scale:.0f} s dwell): {p_low:.2e}")
    region = memory.MemoryRegion.create(
        {"v": torch.zeros((128, 128), dtype=torch.bfloat16, device=dev)},
        level=Priority.LOW, backend=demo, ambient_k=args.ambient_k,
        retention_scale=args.retention_scale)
    region = region.write(rng.PRNGKey(4), {"v": _normal(
        rng.PRNGKey(5), (128, 128), torch.bfloat16, dev)})
    policy = make_scrub_policy(args.scrub_policy, interval=4)
    levels = region.plan.leaf_levels
    for step in range(1, 13):
        region = region.age(rng.fold_in(rng.PRNGKey(6), step))
        if policy.plan_pass(step, levels) is not None:
            region = region.scrub(rng.fold_in(rng.PRNGKey(7), step))
            policy.record(step)
    rep = region.report()
    print(f"  12 steps, {policy.passes} scrub passes: "
          f"{rep.get('retention_flips', 0)} retention flips, "
          f"{rep.get('residual_decayed_bits', 0)} still decayed")
    print(f"  lifetime ledger: write {rep['energy_pj']/1e3:.1f} nJ + "
          f"scrub {rep.get('scrub_energy_pj', 0.0)/1e3:.1f} nJ = "
          f"{rep.get('lifetime_energy_pj', rep['energy_pj'])/1e3:.1f} nJ")

    if args.wear_policy != "none":
        print(f"\n== 8. wear leveling: the logical->physical remap "
              f"(policy={args.wear_policy}) ==")
        from repro_torch.memory import AddressSpec, WritePlan
        from repro_torch.reliability import LifetimePlan, make_wear_policy
        tree = {"kv": torch.zeros((1, 2, 32, 8), dtype=torch.bfloat16,
                                  device=dev)}
        axes = {"kv": ("layers", "batch", "kv_seq", "head_dim")}
        spec = AddressSpec(group_cols=4, endurance_budget=0)
        plan = WritePlan.for_tree(tree, device=dev, backend=demo,
                                  policy=lambda p, leaf: Priority.LOW,
                                  axes=axes, address_spec=spec)
        vectors = plan.vectors_for(Priority.LOW)
        lp = LifetimePlan.for_tree(tree, plan)
        # rotate by a whole row group, so the hot column moves to fresh
        # physical rows
        wear_policy = make_wear_policy(args.wear_policy, check_interval=4,
                                       rotate_step=spec.group_cols,
                                       hot_row_wear=8)
        addr = plan.identity_address()
        life = lp.init_state(tree)
        data = tree
        hot = torch.zeros((2,), dtype=torch.int64, device=dev)  # column 0
        active = torch.ones((2,), dtype=torch.bool, device=dev)
        rotatable = torch.tensor(plan.rotatable(), device=dev)
        for step in range(1, 33):
            k = rng.fold_in(rng.PRNGKey(8), step)
            new_data = {n: _normal(k, tuple(a.shape), a.dtype, dev)
                        for n, a in data.items()}
            worn = lp.worn_groups(life)
            data, _ = plan.write_columns(k, data, new_data, hot, vectors,
                                         addr=(addr.shifts, worn))
            life = lp.record_column_write(life, data, hot, active,
                                          addr.shifts)
            if step % wear_policy.check_interval == 0:
                wear = life.row_wear().cpu().numpy()
                if wear_policy.plan_rotation(step, wear):
                    addr = addr.rotate(rotatable, wear_policy.rotate_step)
                    wear_policy.record(step, wear)
        wear = life.row_wear().cpu().numpy()
        print(f"  32 hot-column writes, {wear_policy.rotations} rotations: "
              f"max group wear {int(wear.max())} "
              f"(no leveling would be 32), shifts="
              f"{np.asarray(addr.shifts.cpu()).tolist()}")


if __name__ == "__main__":
    main()
