"""WritePlan: resolve-once write policy for a tree of memory regions.

The counterpart of ``repro.memory.plan.WritePlan`` for the serving slice.
Built once per cache structure, it captures

  * which leaves go through the approximate driver, at which static
    level (K@MID, V@LOW, recurrent state EXACT);
  * the device driver operands for every (leaf, quality floor) — a floor
    change between bursts swaps operands, nothing is rebuilt;
  * the RNG layout: leaf ``i`` (in sorted-key order) writes with
    ``fold_in(key, i)``, and the lane write hashes flat lane indices;
  * the column-scoped decode write: a leaf with a sequence axis writes
    only the ring column at ``pos % C`` per slot, and the counter hash
    runs over the flat lane index *of the gathered column tensor* — as the
    reference does — so the column is gathered, written and scattered
    back (a fused in-place version is later work).

Effective level = max(static policy, floor); EXACT leaves bypass the
driver. Address remapping, column aliasing and the soft-error hook are
later slices.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.core import write_driver
from repro_torch.core.priority import (Priority, bitplane_priorities,
                                       kv_cache_policy)
from repro_torch.kernels.extent_write import ops as xops
from repro_torch.memory.backends import Backend, LeafVectors, get_backend
from repro_torch.memory.stats import WriteStats


#: cache leaves carry the request/slot dimension at axis 1
BATCH_AXIS = 1


@functools.lru_cache(maxsize=512)
def leaf_vectors(dtype: torch.dtype, level: Priority, device: torch.device
                 ) -> LeafVectors:
    """Resolve one (element dtype, effective level) pair to device
    operands, once per process and device."""
    table = write_driver.level_table()
    codes = bitplane_priorities(dtype, Priority.coerce(level))
    thr01, thr10, e01, e10 = xops.level_vectors(dtype,
                                                Priority.coerce(level))

    def dev(a):
        return torch.from_numpy(np.array(a)).to(device)

    return LeafVectors(
        thr01=dev(thr01.view(np.int32)), thr10=dev(thr10.view(np.int32)),
        le01=dev(e01), le10=dev(e10),
        lat_max=dev(np.float32(table["lat"][codes].max())))


def _approximate(leaf, tag: Priority) -> bool:
    """Floating-point leaves that are not EXACT go through the driver."""
    return leaf.dtype.is_floating_point and tag != Priority.EXACT


@dataclasses.dataclass
class WritePlan:
    backend: Backend
    paths: Tuple[Tuple[Any, ...], ...]
    leaf_levels: Tuple[Optional[Priority], ...]
    leaf_seq_axis: Tuple[Optional[int], ...]
    device: torch.device
    floor_vectors: Dict[Priority, Tuple[Optional[LeafVectors], ...]]

    @classmethod
    def for_tree(cls, tree: Any, *, device, backend: str,
                 axes: Any) -> "WritePlan":
        """Resolve ``kv_cache_policy`` over ``tree`` (leaves need only
        ``dtype``) for the registry backend ``backend``. ``axes`` is a
        same-structure tree of logical-axis tuples; leaves whose tuple
        holds ``"kv_seq"`` get the column-scoped decode write."""
        device = torch.device(device)
        flat = T.flatten(tree)
        levels = []
        for path, leaf in flat:
            tag = Priority.coerce(kv_cache_policy(path, leaf))
            levels.append(tag if _approximate(leaf, tag) else None)
        seq_axis = tuple(ax.index("kv_seq") if "kv_seq" in ax else None
                         for _, ax in T.flatten(axes))
        floor_vectors = {
            floor: tuple(
                leaf_vectors(leaf.dtype, max(lvl, floor), device)
                if lvl is not None else None
                for (_, leaf), lvl in zip(flat, levels))
            for floor in Priority}
        return cls(backend=get_backend(backend),
                   paths=tuple(p for p, _ in flat),
                   leaf_levels=tuple(levels), leaf_seq_axis=seq_axis,
                   device=device, floor_vectors=floor_vectors)

    def vectors_for(self, floor: Priority
                    ) -> Tuple[Optional[LeafVectors], ...]:
        """Per-leaf operands for one quality floor (LOW = static policy)."""
        return self.floor_vectors[Priority.coerce(floor)]

    def _flat(self, old_tree, new_tree):
        flat_old = T.flatten(old_tree)
        assert tuple(p for p, _ in flat_old) == self.paths
        return [o for _, o in flat_old], T.leaves(new_tree)

    def write(self, key: np.ndarray, old_tree: Any, new_tree: Any,
              vectors: Sequence) -> Tuple[Any, WriteStats]:
        """Diff-write a full tree (or a row subset of the same structure)
        with the per-leaf operands ``vectors`` (``vectors_for``); returns
        (stored_tree, WriteStats)."""
        olds, news = self._flat(old_tree, new_tree)
        stored = []
        acc = WriteStats.zero(self.device)
        for i, (o, n, lvl) in enumerate(zip(olds, news, self.leaf_levels)):
            if lvl is None:
                stored.append(n)
                continue
            s, st = self.backend.leaf_write(rng.fold_in(key, i), o, n,
                                            vectors[i])
            stored.append(s)
            acc = acc + st
        return T.unflatten(list(self.paths), stored), acc

    def write_columns(self, key: np.ndarray, old_tree: Any, new_tree: Any,
                      pos: torch.Tensor, vectors: Sequence
                      ) -> Tuple[Any, WriteStats]:
        """Column-scoped decode diff-write: sequence-axis leaves write only
        the ring column at ``pos % C`` per slot (``pos`` is the (B,)
        int64 position vector); the accounting equals a full diff because
        everything outside the column is unchanged."""
        olds, news = self._flat(old_tree, new_tree)
        stored = []
        acc = WriteStats.zero(self.device)
        for i, (o, n, lvl) in enumerate(zip(olds, news, self.leaf_levels)):
            if lvl is None:
                stored.append(n)
                continue
            ax = self.leaf_seq_axis[i]
            k_i = rng.fold_in(key, i)
            if ax is None:
                s, st = self.backend.leaf_write(k_i, o, n, vectors[i])
                stored.append(s)
                acc = acc + st
                continue
            C = o.shape[ax]
            ishape = [1] * o.dim()
            ishape[BATCH_AXIS] = pos.shape[0]
            gshape = o.shape[:ax] + (1,) + o.shape[ax + 1:]
            idx = (pos % C).reshape(ishape).expand(gshape)
            o_col = torch.gather(o, ax, idx)
            n_col = torch.gather(n, ax, idx)
            s_col, st = self.backend.leaf_write(k_i, o_col, n_col,
                                                vectors[i])
            stored.append(n.scatter(ax, idx, s_col))
            acc = acc + st
        return T.unflatten(list(self.paths), stored), acc

