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
  * ``enabled`` gates leaves per pass (the policies of ``policy.py``).

Scrubbing physical rows through a remap (``addr=``) and die-masked
passes (``slot_mask=``) belong to the address and sharding slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.memory import WriteStats, rng_streams
from repro_torch.reliability.lifetime import LifetimePlan, LifetimeState


def scrub_tree(key: np.ndarray, tree: Any, state: LifetimeState,
               life_plan: LifetimePlan, vectors: Sequence, *,
               enabled: Optional[Tuple[bool, ...]] = None,
               cols: Optional[int] = None, cursor: int = 0
               ) -> Tuple[Any, LifetimeState, WriteStats]:
    """One scrub pass. ``vectors`` is the WRITE plan's per-leaf operand
    tuple (``WritePlan.vectors_for(floor)``): scrubs re-write at write
    prices. ``cols``/``cursor`` select the window mode (host ints).

    Returns (scrubbed tree, state', WriteStats): the scrubbed spans'
    masks become the residual masks, the per-leaf scrub counters advance,
    and the pass's stats reduce into one WriteStats."""
    plan = life_plan.plan
    flat = T.leaves(tree)
    if enabled is None:
        enabled = tuple(lvl is not None for lvl in plan.leaf_levels)
    masks = list(state.masks)
    out = []
    acc = WriteStats.zero(plan.device)
    scrubbed = []
    for i, leaf in enumerate(flat):
        if (plan.leaf_levels[i] is None or not enabled[i]
                or masks[i] is None):
            out.append(leaf)
            scrubbed.append(0)
            continue
        k = rng.fold_in(key, rng_streams.SCRUB_OFFSET + i)
        ax = plan.leaf_seq_axis[i]
        if cols is not None and ax is not None and cols < leaf.shape[ax]:
            idx = (torch.arange(cols, dtype=torch.int64, device=leaf.device)
                   + cursor) % leaf.shape[ax]
            s_win, residual, st = plan.backend.leaf_scrub(
                k, leaf.index_select(ax, idx),
                masks[i].index_select(ax, idx), vectors[i])
            out.append(leaf.index_copy(ax, idx, s_win))
            masks[i] = masks[i].index_copy(ax, idx, residual)
        else:
            s_leaf, masks[i], st = plan.backend.leaf_scrub(
                k, leaf, masks[i], vectors[i])
            out.append(s_leaf)
        acc = acc + st
        scrubbed.append(1)
    done = torch.tensor(scrubbed, dtype=torch.int64, device=plan.device)
    state2 = dataclasses.replace(
        state, masks=tuple(masks), scrub_count=state.scrub_count + done,
        last_scrub_step=torch.where(done > 0, state.step,
                                    state.last_scrub_step))
    return T.unflatten(list(plan.paths), out), state2, acc
