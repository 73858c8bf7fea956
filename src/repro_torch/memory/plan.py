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
    back (a fused in-place version is later work);
  * the optional post-write soft-error hook (radiation upsets at
    ``soft_error_ber``; the hardened driver protects sign/exponent
    planes): leaf ``i`` strikes with ``fold_in(key, SOFT_ERROR_OFFSET +
    i)`` over the tensor the backend just wrote (the gathered column in
    a decode write), counted in ``WriteStats.soft_strikes``;
  * column aliasing for the prefix cache (``alias_cols``): a slot's
    leading linked ring columns keep their stored bits, so the write
    skips them at zero cost; ``alias_saving`` prices what that saves;
  * the optional physical addressing layer (``address_spec``,
    ``memory.address``): ``write`` and ``write_columns`` take
    ``addr=(shifts, worn)``; elements backed by worn physical row
    groups are stuck-at — the gate runs *before* the backend's write, so
    they keep their stored bits (zero energy under CMP) and the flips
    they lost are added to ``WriteStats.errors``. The backend's
    arguments and its flat-index hash do not change, so identity shifts
    with no worn rows equal ``addr=None`` bit for bit.
    ``migration_cost`` prices one wear-leveling rotation.

Effective level = max(static policy, floor); EXACT leaves bypass the
driver.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.core import write_driver
from repro_torch.core.approx_store import soft_error_strikes
from repro_torch.core.priority import (Priority, bitplane_priorities, bits_of,
                                       int_type, kv_cache_policy)
from repro_torch.kernels.extent_write import ops as xops
from repro_torch.memory import address as A
from repro_torch.memory.backends import (Backend, LeafVectors,
                                         default_backend, get_backend)
from repro_torch.memory.rng_streams import SOFT_ERROR_OFFSET
from repro_torch.memory.stats import WriteStats, popcount


#: cache leaves carry the request/slot dimension at axis 1
BATCH_AXIS = 1


@functools.lru_cache(maxsize=512)
def leaf_vectors(dtype: torch.dtype, level: Priority, device: torch.device
                 ) -> LeafVectors:
    """Resolve one (element dtype, effective level) pair to device
    operands, once per process and device: the per-bit-plane vectors
    (the level table indexed by the bit-plane policy) and, for 1-, 2- and
    4-byte elements, the lane quadruple."""
    level = Priority.coerce(level)
    table = write_driver.level_table()
    codes = bitplane_priorities(dtype, level)

    def dev(a):
        return torch.from_numpy(np.array(a)).to(device)

    lanes = (None,) * 4
    if dtype.itemsize in (1, 2, 4):
        thr01, thr10, e01, e10 = xops.level_vectors(dtype, level)
        lanes = (dev(thr01.view(np.int32)), dev(thr10.view(np.int32)),
                 dev(e01), dev(e10))
    return LeafVectors(
        wer01=dev(table["wer01"][codes]), wer10=dev(table["wer10"][codes]),
        eb01=dev(table["e01"][codes]), eb10=dev(table["e10"][codes]),
        lat=dev(table["lat"][codes]),
        lat_max=dev(np.float32(table["lat"][codes].max())),
        thr01=lanes[0], thr10=lanes[1], le01=lanes[2], le10=lanes[3])


def _approximate(leaf, tag: Priority) -> bool:
    """The engine's rule: floating-point leaves that are not EXACT go
    through the driver; integer and EXACT-pinned leaves bypass it."""
    return leaf.dtype.is_floating_point and tag != Priority.EXACT


def _stuck_gate(old: torch.Tensor, new: torch.Tensor, worn: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stuck-at gating of worn physical rows: elements under ``worn``
    keep their stored value, and every bit the write would have changed
    there counts as a failed write. Returns (gated new, lost bits as a
    0-d int64). The gated new equals the old on worn rows, so the CMP
    write that follows charges no flips and no energy there."""
    it = int_type(old.dtype)
    d = old.view(it) ^ new.view(it)
    lost = popcount(torch.where(worn, d, torch.zeros_like(d)))
    return torch.where(worn, old, new), lost


@dataclasses.dataclass
class WritePlan:
    backend: Backend
    paths: Tuple[Tuple[Any, ...], ...]
    treedef: T.TreeDef
    leaf_levels: Tuple[Optional[Priority], ...]
    leaf_seq_axis: Tuple[Optional[int], ...]
    device: torch.device
    floor_vectors: Dict[Priority, Tuple[Optional[LeafVectors], ...]]
    soft_error_ber: float = 0.0
    soft_error_hardened: bool = True
    #: the physical addressing layer; None = no remap and no stuck-at
    #: gating, the plain data path
    address_spec: Optional[A.AddressSpec] = None

    @classmethod
    def for_tree(cls, tree: Any, *, device, backend: str,
                 policy: Callable[..., Any] = kv_cache_policy,
                 axes: Any = None, soft_error_ber: float = 0.0,
                 soft_error_hardened: bool = True,
                 address_spec: Optional[A.AddressSpec] = None,
                 approx_if: Callable[[Any, Priority], bool] = _approximate
                 ) -> "WritePlan":
        """Resolve ``policy(path, leaf)`` over ``tree`` (leaves need only
        ``dtype``) for the registry backend ``backend``; ``approx_if(leaf,
        tag)`` decides which leaves go through the driver. ``axes`` is
        None (no column-scoped leaf) or a same-structure tree of
        logical-axis tuples; leaves whose tuple holds ``"kv_seq"`` get
        the column-scoped decode write. ``soft_error_ber > 0`` turns the
        post-write upset hook on; ``address_spec`` the addressing
        layer."""
        device = torch.device(device)
        flat, treedef = T.flatten_with_def(tree)
        levels = []
        for path, leaf in flat:
            tag = Priority.coerce(policy(path, leaf))
            levels.append(tag if approx_if(leaf, tag) else None)
        if axes is None:
            seq_axis = (None,) * len(flat)
        else:
            seq_axis = tuple(
                ax.index("kv_seq")
                if isinstance(ax, tuple) and "kv_seq" in ax else None
                for ax in treedef.flatten_up_to(axes))
        floor_vectors = {
            floor: tuple(
                leaf_vectors(leaf.dtype, max(lvl, floor), device)
                if lvl is not None else None
                for (_, leaf), lvl in zip(flat, levels))
            for floor in Priority}
        return cls(backend=get_backend(backend),
                   paths=tuple(p for p, _ in flat), treedef=treedef,
                   leaf_levels=tuple(levels), leaf_seq_axis=seq_axis,
                   device=device, floor_vectors=floor_vectors,
                   soft_error_ber=soft_error_ber,
                   soft_error_hardened=soft_error_hardened,
                   address_spec=address_spec)

    def unflatten(self, leaves: Sequence[Any]) -> Any:
        """A tree of the plan's structure from its flat leaves."""
        return self.treedef.unflatten(list(leaves))

    def vectors_for(self, floor: Priority
                    ) -> Tuple[Optional[LeafVectors], ...]:
        """Per-leaf operands for one quality floor (LOW = static policy)."""
        return self.floor_vectors[Priority.coerce(floor)]

    def _price_ring_cols(self, tree: Any, cols: int, per_slot: bool
                         ) -> Tuple[float, int]:
        """Host constants (energy_pj, bits) of driving ``cols`` ring
        columns of every ring leaf — of ONE slot (``per_slot``) or of
        all slots — every bit priced at the mean of the static 0->1/1->0
        per-plane write prices (host arithmetic on the level table, as
        the reference computes it)."""
        table = write_driver.level_table()
        pj, bits = 0.0, 0
        for (_, leaf), lvl, ax in zip(T.flatten(tree), self.leaf_levels,
                                      self.leaf_seq_axis):
            if lvl is None or ax is None:
                continue
            C = leaf.shape[ax]
            rows = leaf.numel() // C
            if per_slot:
                rows //= leaf.shape[BATCH_AXIS]
            elems = rows * min(int(cols), C)
            codes = bitplane_priorities(leaf.dtype, lvl)
            eb = (table["e01"][codes] + table["e10"][codes]) / 2.0
            pj += float(elems) * float(eb.sum())
            bits += elems * bits_of(leaf.dtype)
        return pj, bits

    def alias_saving(self, tree: Any, cols: int) -> Tuple[float, int]:
        """Host constants (energy_pj, bits) of driving ``cols`` leading
        ring columns of ONE slot across the sequence-axis leaves: the
        full-drive cost of the columns a prefix link skips. The
        scheduler books both a link's saving and a copy-on-write's charge
        through it, so the two cancel exactly."""
        return self._price_ring_cols(tree, cols, per_slot=True)

    def migration_cost(self, tree: Any) -> Tuple[float, int]:
        """Host constants (energy_pj, bits) of ONE start-gap migration:
        one ``group_cols``-wide row group of every slot of every ring
        leaf copied through the controller's row buffer, priced as
        ``alias_saving`` prices a column. The one source of the remap
        pricing."""
        assert self.address_spec is not None, "plan has no address layer"
        return self._price_ring_cols(tree, self.address_spec.group_cols,
                                     per_slot=False)

    # ------------------------------------------------------ address layer
    def rotatable(self) -> Tuple[bool, ...]:
        """Per leaf: does the wear-leveling rotation apply? Only
        approximate leaves with a ring axis have columns to rotate."""
        return tuple(lvl is not None and ax is not None
                     for lvl, ax in zip(self.leaf_levels,
                                        self.leaf_seq_axis))

    def identity_address(self) -> A.AddressState:
        """The identity permutation of this plan's leaves, on its device
        (bit-identical to no address layer)."""
        return A.AddressState.identity(len(self.leaf_levels), self.device)

    def _worn_elem(self, i: int, leaf: torch.Tensor, shifts, worn
                   ) -> Optional[torch.Tensor]:
        """Stuck-at mask of leaf ``i`` under the address operands,
        broadcastable to it; None when gating is off."""
        if worn is None or self.address_spec is None:
            return None
        return A.worn_element_mask(worn[i], shifts[i], leaf.shape,
                                   self.leaf_seq_axis[i], BATCH_AXIS,
                                   self.address_spec)

    def _gated_write(self, key, i, o, n, lv, wm):
        """``_leaf_write`` behind the stuck-at gate ``wm`` (None: none);
        the lost flips join the write's errors."""
        lost = None
        if wm is not None:
            n, lost = _stuck_gate(o, n, wm)
        s, st = self._leaf_write(key, i, o, n, lv)
        if lost is not None:
            st = dataclasses.replace(st, errors=st.errors + lost)
        return s, st

    def _flat(self, old_tree, new_tree):
        flat_old = T.flatten(old_tree)
        assert tuple(p for p, _ in flat_old) == self.paths
        return [o for _, o in flat_old], T.leaves(new_tree)

    def _leaf_write(self, key: np.ndarray, i: int, old: torch.Tensor,
                    new: torch.Tensor, lv: LeafVectors
                    ) -> Tuple[torch.Tensor, WriteStats]:
        """One leaf through the backend, then the optional soft-error
        hook: the one place the per-leaf RNG schedule lives."""
        stored, st = self.backend.leaf_write(rng.fold_in(key, i), old, new,
                                             lv)
        if self.soft_error_ber > 0.0:
            stored, strikes = soft_error_strikes(
                rng.fold_in(key, SOFT_ERROR_OFFSET + i), stored,
                self.soft_error_ber, self.soft_error_hardened)
            st = dataclasses.replace(st,
                                     soft_strikes=st.soft_strikes + strikes)
        return stored, st

    def alias_keep(self, i: int, leaf: torch.Tensor,
                    alias_cols: Optional[torch.Tensor]
                    ) -> Optional[torch.Tensor]:
        """Column-alias mask of leaf ``i``, broadcastable to it: True on
        the leading ``alias_cols[slot]`` ring columns, which are *linked*
        to columns resident elsewhere (``serve.prefix``). None when
        aliasing is off or the leaf has no ring axis."""
        ax = self.leaf_seq_axis[i]
        if alias_cols is None or ax is None:
            return None
        ishape = [1] * leaf.dim()
        ishape[BATCH_AXIS] = alias_cols.shape[0]
        cshape = [1] * leaf.dim()
        cshape[ax] = leaf.shape[ax]
        col = torch.arange(leaf.shape[ax], device=leaf.device)
        return col.reshape(cshape) < alias_cols.reshape(ishape)

    def write(self, key: np.ndarray, old_tree: Any, new_tree: Any,
              vectors: Sequence,
              alias_cols: Optional[torch.Tensor] = None,
              addr: Optional[Tuple[torch.Tensor,
                                   Optional[torch.Tensor]]] = None
              ) -> Tuple[Any, WriteStats]:
        """Diff-write a full tree (or a row subset of the same structure)
        with the per-leaf operands ``vectors`` (``vectors_for``); returns
        (stored_tree, WriteStats).

        ``alias_cols`` is the prefix cache's optional (B,) int64 column
        alias: slot ``b``'s leading ``alias_cols[b]`` ring columns keep
        the stored (old) bits, so the write skips them — zero energy,
        flips and WER there. Every other element stores what the
        unaliased call stores (the RNG hashes flat element indices), and
        an all-zero alias equals ``alias_cols=None`` bit for bit.

        ``addr`` is the optional addressing pair ``(shifts (L,) int64,
        worn (L, G) bool or None)``: elements backed by worn physical
        row groups are stuck-at (they keep the old bits, and the flips
        they lost are booked to ``errors``)."""
        shifts, worn = addr if addr is not None else (None, None)
        olds, news = self._flat(old_tree, new_tree)
        stored = []
        acc = WriteStats.zero(self.device)
        for i, (o, n, lvl) in enumerate(zip(olds, news, self.leaf_levels)):
            if lvl is None:
                stored.append(n)
                continue
            keep = self.alias_keep(i, o, alias_cols)
            if keep is not None:
                n = torch.where(keep, o, n)
            s, st = self._gated_write(key, i, o, n, vectors[i],
                                      self._worn_elem(i, o, shifts, worn))
            stored.append(s)
            acc = acc + st
        return self.unflatten(stored), acc

    def write_columns(self, key: np.ndarray, old_tree: Any, new_tree: Any,
                      pos: torch.Tensor, vectors: Sequence,
                      alias_cols: Optional[torch.Tensor] = None,
                      addr: Optional[Tuple[torch.Tensor,
                                           Optional[torch.Tensor]]] = None
                      ) -> Tuple[Any, WriteStats]:
        """Column-scoped decode diff-write: sequence-axis leaves write only
        the ring column at ``pos % C`` per slot (``pos`` is the (B,)
        int64 position vector); the accounting equals a full diff because
        everything outside the column is unchanged. With ``alias_cols``
        a slot whose column lies in its linked prefix (``pos <
        alias_cols``) keeps its stored bits. With ``addr`` (see
        ``write``) the column's address maps through the rotation to its
        physical row group, and a slot whose group is worn has its column
        write inhibited; the hash still runs over the gathered column's
        flat index, which does not depend on the address."""
        shifts, worn = addr if addr is not None else (None, None)
        gate = worn is not None and self.address_spec is not None
        olds, news = self._flat(old_tree, new_tree)
        stored = []
        acc = WriteStats.zero(self.device)
        for i, (o, n, lvl) in enumerate(zip(olds, news, self.leaf_levels)):
            if lvl is None:
                stored.append(n)
                continue
            ax = self.leaf_seq_axis[i]
            if ax is None:
                s, st = self._gated_write(
                    key, i, o, n, vectors[i],
                    self._worn_elem(i, o, shifts, worn))
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
            if alias_cols is not None:
                keep = (pos < alias_cols).reshape(ishape)
                n_col = torch.where(keep, o_col, n_col)
            wm = (A.worn_slot_mask(worn[i], pos, shifts[i], C,
                                   self.address_spec).reshape(ishape)
                  if gate else None)
            s_col, st = self._gated_write(key, i, o_col, n_col, vectors[i],
                                          wm)
            stored.append(n.scatter(ax, idx, s_col))
            acc = acc + st
        return self.unflatten(stored), acc

    # ------------------------------------------------------ shape metadata
    def approx_bits(self, tree: Any) -> int:
        """Bits of the approximate leaves: static shape metadata."""
        return sum(leaf.numel() * bits_of(leaf.dtype)
                   for leaf, lvl in zip(T.leaves(tree), self.leaf_levels)
                   if lvl is not None)

    def decode_bits(self, tree: Any) -> int:
        """Approximate bits one decode step addresses: the written ring
        column of each sequence-axis leaf, whole leaves otherwise."""
        total = 0
        for leaf, lvl, ax in zip(T.leaves(tree), self.leaf_levels,
                                 self.leaf_seq_axis):
            if lvl is None:
                continue
            n = leaf.numel() if ax is None else leaf.numel() // leaf.shape[ax]
            total += n * bits_of(leaf.dtype)
        return total


def write(key: np.ndarray, old: torch.Tensor, new: torch.Tensor, *,
          level=Priority.LOW, backend: Optional[str] = None
          ) -> Tuple[torch.Tensor, WriteStats]:
    """Single-tensor EXTENT write through a registered backend (default:
    the kernel on a CUDA device, the twin on the CPU) at ``level`` (a
    Priority, its int or its name). Returns (stored, WriteStats)."""
    lv = leaf_vectors(old.dtype, Priority.coerce(level), old.device)
    be = get_backend(backend or default_backend(old.device))
    return be.leaf_write(key, old, new, lv)
