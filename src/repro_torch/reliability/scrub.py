"""Scrub passes: corrective re-writes of decayed bits over a cache tree.

The counterpart of ``repro.reliability.scrub.scrub_tree`` for the serving
slice. A pass drives ``Backend.leaf_scrub`` (the CUDA scrub kernel or its
twin, chosen by the same registry name as the write path) over the
approximate leaves, against the decay masks ``LifetimePlan.advance``
keeps:

  * every decayed bit is re-written through the EXTENT driver at the
    leaf's (floor-composed) level — the re-write pays write-path energy
    through ``WriteStats`` (callers book it to a separate stream) and can
    itself fail with the level's WER: failed corrections stay decayed in
    the residual mask and are retried next pass;
  * a leaf with a sequence axis can be scrubbed in a window of ``cols``
    ring columns starting at ``cursor``, so one full-cache scrub spreads
    over many passes. The window is gathered contiguous, scrubbed — the
    counter hash runs over the flat lane index of the GATHERED window, as
    the reference does — and scattered back;
  * ``enabled`` gates leaves per pass (the policies of ``policy.py``);
  * with the addressing layer (``addr=(shifts, worn)``), the window's
    cursor walks **physical** rows: the window maps through the inverse
    rotation to the logical columns those rows back now, so one turn of
    the cursor covers every physical row once however often the
    wear-leveler rotated in between. Worn (stuck-at) rows cannot be
    re-driven: their decayed bits are taken out of the corrective mask
    (no energy, no flips) and stay in the residual. Scrubbed columns
    book row-group scrub wear (``window_group_counts``);
  * ``slot_mask`` ((B,) bool) scopes a pass to some slot rows: the
    sharded scheduler's extra passes over one hot die. Out-of-die slots
    are held out like worn rows (no energy, decay kept in the residual)
    and book no scrub wear.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.memory import WriteStats, rng_streams
from repro_torch.memory import address as A
from repro_torch.memory.plan import BATCH_AXIS
from repro_torch.reliability.lifetime import LifetimePlan, LifetimeState


def scrub_tree(key: np.ndarray, tree: Any, state: LifetimeState,
               life_plan: LifetimePlan, vectors: Sequence, *,
               enabled: Optional[Tuple[bool, ...]] = None,
               cols: Optional[int] = None, cursor: int = 0,
               addr: Optional[Tuple[torch.Tensor,
                                    Optional[torch.Tensor]]] = None,
               slot_mask: Optional[torch.Tensor] = None
               ) -> Tuple[Any, LifetimeState, WriteStats]:
    """One scrub pass. ``vectors`` is the WRITE plan's per-leaf operand
    tuple (``WritePlan.vectors_for(floor)``): scrubs re-write at write
    prices. ``cols``/``cursor`` select the window mode (host ints; the
    cursor is a physical row when ``addr`` carries remap shifts).
    ``addr`` is the addressing pair ``(shifts, worn)`` (see
    ``WritePlan.write``); identity shifts with no worn rows reproduce
    the pass without it bit for bit. ``slot_mask`` ((B,) bool on the
    device) limits the pass to the slots it selects; all-true is the
    whole-pool pass.

    Returns (scrubbed tree, state', WriteStats): the scrubbed spans'
    masks become the residual masks, the per-leaf scrub counters (and,
    with an address layer, the per-row-group ones) advance, and the
    pass's stats reduce into one WriteStats."""
    plan = life_plan.plan
    spec = plan.address_spec
    shifts, worn = addr if addr is not None else (None, None)
    flat = T.leaves(tree)
    if enabled is None:
        enabled = tuple(lvl is not None for lvl in plan.leaf_levels)
    masks = list(state.masks)
    out = []
    acc = WriteStats.zero(plan.device)
    scrubbed = []
    row_scrub = state.row_scrub_count
    if spec is not None:
        row_scrub = row_scrub.clone()
    for i, leaf in enumerate(flat):
        if (plan.leaf_levels[i] is None or not enabled[i]
                or masks[i] is None):
            out.append(leaf)
            scrubbed.append(0)
            continue
        k = rng.fold_in(key, rng_streams.SCRUB_OFFSET + i)
        ax = plan.leaf_seq_axis[i]
        windowed = (cols is not None and ax is not None
                    and cols < leaf.shape[ax])
        if windowed:
            C = leaf.shape[ax]
            idx = (torch.arange(cols, dtype=torch.int64, device=leaf.device)
                   + cursor) % C
            if shifts is not None:
                # the cursor walks physical rows: scrub the logical
                # columns they back now
                idx = A.logical_col(idx, shifts[i], C)
            w_leaf = leaf.index_select(ax, idx)
            w_mask = masks[i].index_select(ax, idx)
        else:
            idx = None
            w_leaf, w_mask = leaf, masks[i]
        stuck = None
        if worn is not None and spec is not None:
            stuck = A.worn_element_mask(
                worn[i], shifts[i], w_mask.shape, ax, BATCH_AXIS, spec,
                cols=idx, n_cols=None if ax is None else leaf.shape[ax])
        if slot_mask is not None:
            # out-of-die slots are held out of this pass like worn rows
            shape = [1] * w_mask.dim()
            shape[BATCH_AXIS] = -1
            excl = ~slot_mask.reshape(shape)
            stuck = excl if stuck is None else stuck | excl
        if stuck is not None:
            # rows that cannot (or must not) be re-driven: their decayed
            # bits are held out of the corrective write (zero-mask bits
            # are free) and stay decayed in the residual
            zero = torch.zeros_like(w_mask)
            held = torch.where(stuck, w_mask, zero)
            w_mask = torch.where(stuck, zero, w_mask)
        s_leaf, residual, st = plan.backend.leaf_scrub(k, w_leaf, w_mask,
                                                       vectors[i])
        if stuck is not None:
            residual = residual | held
        if windowed:
            out.append(leaf.index_copy(ax, idx, s_leaf))
            masks[i] = masks[i].index_copy(ax, idx, residual)
        else:
            out.append(s_leaf)
            masks[i] = residual
        acc = acc + st
        scrubbed.append(1)
        if spec is not None:
            # row-group scrub wear: one re-write per covered column per
            # slot row, in physical space
            B, G = leaf.shape[BATCH_AXIS], row_scrub.shape[1]
            if ax is None:
                inc = torch.zeros((G,), dtype=torch.int64,
                                  device=row_scrub.device)
                inc[:B] = 1
            else:
                inc = A.window_group_counts(
                    cursor if windowed else 0,
                    cols if windowed else leaf.shape[ax], leaf.shape[ax],
                    B, G, spec, row_scrub.device)
            if slot_mask is not None:
                # only the covered slots' groups (slot-major: group g
                # backs slot g // gc)
                gc = 1 if ax is None else spec.col_groups(leaf.shape[ax])
                sl = torch.arange(G, device=inc.device) // gc
                covered = slot_mask[sl.clamp(0, B - 1)] & (sl < B)
                inc = torch.where(covered, inc, torch.zeros_like(inc))
            row_scrub[i] += inc
    done = torch.tensor(scrubbed, dtype=torch.int64, device=plan.device)
    state2 = dataclasses.replace(
        state, masks=tuple(masks), scrub_count=state.scrub_count + done,
        row_scrub_count=row_scrub,
        last_scrub_step=torch.where(done > 0, state.step,
                                    state.last_scrub_step))
    return plan.unflatten(out), state2, acc


def scrub_span_args(stats: WriteStats, policy, *, cols: int,
                    floor, resident: Sequence[int]) -> dict:
    """Telemetry attribution of one scrub pass's background span: the
    policy, the window width, the floor the re-writes were driven at and
    the co-resident requests. ``stats.energy_pj`` stays a device
    reference: the tracer lands it at finalize, never here."""
    return {**policy.describe(), "cols": int(cols or 0),
            "floor": getattr(floor, "name", str(floor)),
            "energy_pj": stats.energy_pj,
            "resident": list(resident)}
