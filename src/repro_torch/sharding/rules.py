"""Logical-axis -> mesh-axis sharding rules (the counterpart of
``repro.sharding.rules``).

Every parameter, activation and cache dimension carries a logical axis
name; one rules table maps names to mesh axes. An assignment that does
not divide the dimension's size falls back to replication. ``spec_for``
returns the entries the reference's ``PartitionSpec`` holds, as a tuple.

Strategy (the reference's):
  * batch               -> (pod?, data)      data parallel
  * embed (d_model)     -> data              FSDP weight sharding
  * mlp / vocab / heads -> model             tensor parallel
  * kv_seq (cache ctx)  -> model             context-parallel KV
  * expert              -> model             expert parallel
  * exp_cap             -> data              MoE capacity over DP

The port trains over the ``data`` axis of a (data=N, model=1) mesh,
one process a device (``DataShards``): each leaf keeps a 1/N block of
the one dimension its spec puts on ``data`` (``data_dim``; the embed
dimension under ``baseline``), or all of itself where the spec puts
nothing there (norm scales, biases, every dense leaf under
``serve_tp_only`` and ``serve_moe_2d``, a dimension the axis does not
divide). ``make_constrain`` is the identity there and refuses a mesh
whose ``model`` axis spans more than one device: tensor parallelism is
a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Dict, FrozenSet, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.device import rank_and_world
from repro_torch.models.layers import gather_slices, no_constrain
from repro_torch.sharding.mesh import Mesh, NamedSharding
from repro_torch.train.optimizer import OptState

Axis = Union[None, str, Tuple[str, ...]]


def default_rules(mesh: Mesh) -> Dict[str, Axis]:
    dp: Axis = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    return {
        "batch": dp,
        "vocab": "model",
        "embed": "data",
        "heads": "model",
        "kv_heads": None,     # GQA counts rarely divide TP; kv_seq carries it
        "kv_seq": "model",
        "head_dim": None,
        "mlp": "model",
        "expert": "model",
        "expert_mlp": None,   # serve_moe_2d shards this over data
        "exp_cap": "data",
        "expert_logits": None,
        "ssm_heads": "model",
        "ssm_state2": None,
        # RG-LRU gate matrices are (R, R): the input dim rides `mlp`, so
        # the output dim stays replicated (both on `model` is a dup spec)
        "rnn_gate": None,
        "vision": None,
        "layers": None,
        "norm_scale": None,
        "bias": None,
        "conv": None,
    }


def strategy_rules(mesh: Mesh, strategy: str = "baseline"
                   ) -> Dict[str, Axis]:
    """Named rule variants:

      baseline       FSDP params over data + TP over model
      serve_tp_only  params resident (TP-sharded only); batch DP over data
      serve_moe_2d   dense weights TP-resident, expert FFNs 2D-sharded
                     (expert x expert_mlp)
    """
    rules = default_rules(mesh)
    if strategy == "baseline":
        return rules
    if strategy == "serve_tp_only":
        rules["embed"] = None
        return rules
    if strategy == "serve_moe_2d":
        rules["embed"] = None
        rules["expert_mlp"] = "data"
        return rules
    raise KeyError(f"unknown rules strategy {strategy!r}")


def _axis_size(mesh: Mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape[axis]
    return int(np.prod([mesh.shape[a] for a in axis]))


def spec_for(mesh: Mesh, rules: Dict[str, Axis],
             logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Tuple[Axis, ...]:
    """The spec's entries, one per dimension; an assignment that does
    not divide the dimension falls back to replication (None). A tuple of
    one mesh axis is that axis, as ``PartitionSpec`` normalises it."""
    entries = []
    for i, name in enumerate(logical):
        ax = rules.get(name) if name is not None else None
        if ax is not None and shape is not None:
            if shape[i] % _axis_size(mesh, ax) != 0:
                ax = None
        if isinstance(ax, tuple) and len(ax) == 1:
            ax = ax[0]
        entries.append(ax)
    return tuple(entries)


def make_constrain(mesh: Mesh, rules: Dict[str, Axis]):
    """``constrain(t, logical_axes)`` for the model code: the identity on
    a (data=N, model=1) mesh, where each rank's activations are its own
    batch rows and each weight is made whole where it is used
    (``DataShards.gather``). A mesh with another axis over more than one
    device raises."""
    wide = {a: n for a, n in mesh.shape.items() if a != "data" and n > 1}
    if wide:
        raise NotImplementedError(
            f"a {mesh.shape} mesh: the port trains over the data axis "
            f"only; tensor parallelism over {sorted(wide)} is a later "
            "slice")
    return no_constrain


def data_dim(spec: Sequence[Axis]) -> Optional[int]:
    """The one dimension ``spec`` puts on the ``data`` axis, or None."""
    hits = [i for i, e in enumerate(spec) if e == "data"
            or (isinstance(e, tuple) and "data" in e)]
    if len(hits) > 1:
        raise ValueError(f"{spec} shards {len(hits)} dimensions over data")
    return hits[0] if hits else None


@dataclasses.dataclass
class DataShards:
    """A params tree over the ``data`` axis of the running process
    group. ``dims`` is the params tree's structure with, at each leaf,
    the dimension of which this rank holds block ``mesh.rank`` of N, or
    None where every rank holds the whole leaf; ``flat_dims`` the same
    in leaf order; ``stacks`` the top-level subtrees whose leaves lead
    with a ``layers`` axis (``layer_stacks``), which the model gathers
    a layer at a time."""
    mesh: Mesh
    dims: Any
    flat_dims: List[Optional[int]]
    stacks: Optional[FrozenSet[str]] = None

    def __post_init__(self):
        make_constrain(self.mesh, {})
        rank, world = rank_and_world()
        if not dist.is_initialized() or world != self.mesh.size \
                or rank != self.mesh.rank:
            raise RuntimeError(
                f"a {self.mesh.shape} mesh at rank {self.mesh.rank} needs "
                f"a process group of {self.mesh.size} ranks; this process "
                f"is rank {rank} of {world}")

    @property
    def n(self) -> int:
        return self.mesh.shape["data"]

    def sharded(self) -> List[bool]:
        """Per leaf in leaf order: whether it is held as a slice."""
        return [d is not None for d in self.flat_dims]

    def keep(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf ``i`` (a copy, so the whole leaf can
        go), or the leaf itself when replicated or on one rank: the
        ``keep`` of ``ModelApi.init``."""
        d = self.flat_dims[i]
        if d is None or self.n == 1:
            return leaf
        return leaf.chunk(self.n, d)[self.mesh.rank].clone()

    def gather(self, name: str, tree: Any) -> Any:
        """The model's gather hook: the subtree ``params[name]`` whole
        (for a stack, one layer of it, as ``unstack`` took it apart)."""
        if self.stacks is None:
            raise ValueError("DataShards built without the logical axes: "
                             "use data_shards")
        return gather_slices(tree, self.dims[name],
                             1 if name in self.stacks else 0)

    def sync_grads(self, grads: Any) -> None:
        """Sum the replicated leaves' gradients over the ranks, in place
        (the sharded leaves' sums come from ``GatherSlice``'s
        reduce-scatter)."""
        for g, sh in zip(T.leaves(grads), self.sharded()):
            if not sh:
                dist.all_reduce(g)

    def state_dims(self) -> Dict[str, Any]:
        """``dims`` over a ``{"params", "opt"}`` checkpoint state: the
        moments lie as their parameters, the step is whole."""
        return {"params": self.dims,
                "opt": OptState(None, self.dims, self.dims)}


def data_dims(mesh: Mesh, rules: Dict[str, Axis], axes_tree: Any,
              shapes_tree: Any) -> Tuple[Any, List[Optional[int]]]:
    """Each leaf's ``data_dim`` under ``rules``: (the params tree's
    structure holding them, the same in leaf order)."""
    flat, tdef = T.flatten_with_def(tree_shardings(mesh, rules, axes_tree,
                                                   shapes_tree))
    dims = [data_dim(s.spec) for _, s in flat]
    return tdef.unflatten(dims), dims


def layer_stacks(axes_tree: Dict[str, Any]) -> FrozenSet[str]:
    """The top-level names of a params tree's logical axes whose every
    leaf leads with ``layers``; a subtree whose leaves disagree raises."""
    out = set()
    for name, sub in axes_tree.items():
        lead = {axes[0] == "layers" if axes else False
                for axes in _axes_leaves(sub)}
        if len(lead) != 1:
            raise ValueError(f"{name}: some leaves are layer stacks, "
                             "some are not")
        if lead.pop():
            out.add(name)
    return frozenset(out)


def _axes_leaves(tree: Any) -> List[Tuple]:
    if _is_axes(tree):
        return [tree]
    return [a for k in sorted(tree) for a in _axes_leaves(tree[k])]


def data_shards(mesh: Mesh, rules: Dict[str, Axis], axes_tree: Any,
                shapes_tree: Any) -> DataShards:
    """The ``DataShards`` of a params tree (its logical axes and shapes)
    under ``rules``, on this process's rank of the group."""
    return DataShards(mesh, *data_dims(mesh, rules, axes_tree, shapes_tree),
                      stacks=layer_stacks(axes_tree))


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_shardings(mesh: Mesh, rules: Dict[str, Axis], axes_tree: Any,
                   shapes_tree: Any) -> Any:
    """A tree of logical-axes tuples and the same tree of shapes -> the
    tree of ``NamedSharding``s (dicts walked, axes tuples the leaves)."""
    if _is_axes(axes_tree):
        return NamedSharding(mesh, spec_for(mesh, rules, axes_tree,
                                            shapes_tree))
    assert sorted(axes_tree) == sorted(shapes_tree), (
        sorted(axes_tree), sorted(shapes_tree))
    return {k: tree_shardings(mesh, rules, axes_tree[k], shapes_tree[k])
            for k in axes_tree}
