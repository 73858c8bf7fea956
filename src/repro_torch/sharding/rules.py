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

The port trains over a (data=D, model=M) mesh of processes, one a
device (``MeshShards``): each leaf keeps block d of D of the one
dimension its spec puts on ``data`` (the embed dimension under
``baseline``: FSDP) and block m of M of the one it puts on ``model``
(heads, mlp, vocab: Megatron-style tensor parallelism of the dense
family, ``models.layers.ModelAxis``), and all of itself on an axis its
spec does not use (norm scales, ``wk``/``wv`` and their biases over
``model``, every dense leaf over ``data`` under ``serve_tp_only`` and
``serve_moe_2d``, a dimension the axis does not divide).
``make_constrain`` is the identity there; it refuses a ``pod`` axis and
tensor parallelism of a model with experts or of the hybrid, ssm, vlm
and audio families, which are later slices.
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
from repro_torch.models.layers import (ModelAxis, all_gather_dim,
                                       gather_slices, no_constrain)
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


def make_constrain(mesh: Mesh, rules: Dict[str, Axis], cfg=None):
    """``constrain(t, logical_axes)`` for the model code: the identity on
    a (data=D, model=M) mesh, where each rank's activations are its data
    row's batch rows (whole over ``model``), each weight is made whole
    over ``data`` where it is used (``MeshShards.gather``) and the dense
    family's tensor-parallel blocks are explicit (``ModelAxis``). A
    ``pod`` axis over more than one device raises, and so does a model
    axis over more than one device for ``cfg`` (a ``ModelConfig``) with
    experts or of another family than dense."""
    if mesh.shape.get("pod", 1) > 1:
        raise NotImplementedError(
            f"a {mesh.shape} mesh: the port trains over (data, model); a "
            "pod axis is a later slice")
    if mesh.shape.get("model", 1) > 1 and cfg is not None and (
            cfg.num_experts or cfg.family != "dense"):
        what = ("its experts" if cfg.num_experts
                else f"the {cfg.family} family")
        raise NotImplementedError(
            f"a {mesh.shape} mesh: tensor parallelism of {cfg.name} ({what}) "
            "over the model axis is a later slice (the MoE's expert "
            "parallelism, then the hybrid, ssm, vlm and audio families)")
    return no_constrain


def axis_dim(spec: Sequence[Axis], axis: str) -> Optional[int]:
    """The one dimension ``spec`` puts on mesh axis ``axis``, or None."""
    hits = [i for i, e in enumerate(spec) if e == axis
            or (isinstance(e, tuple) and axis in e)]
    if len(hits) > 1:
        raise ValueError(f"{spec} shards {len(hits)} dimensions over "
                         f"{axis}")
    return hits[0] if hits else None


@dataclasses.dataclass(frozen=True, eq=False)
class Cut:
    """Where one leaf lies on a (data, model) ``mesh``: the dimension of
    which a rank holds block d of D (``data``) and the one of which it
    holds block m of M (``model``), None where the leaf is whole along
    that axis."""
    data: Optional[int]
    model: Optional[int]
    mesh: Mesh

    def _axes(self):
        """(axis name, dimension) of each axis that cuts the leaf, model
        first."""
        return [(a, d) for a, d in (("model", self.model),
                                    ("data", self.data)) if d is not None]

    @property
    def cut(self) -> bool:
        return bool(self._axes())

    def block(self, whole: torch.Tensor, rank: Optional[int] = None
              ) -> torch.Tensor:
        """``rank``'s (default this rank's) block of the whole leaf: a
        view, or the leaf itself where every cut axis has one rank."""
        for a, d in self._axes():
            n = self.mesh.shape[a]
            if n > 1:
                whole = whole.chunk(n, d)[self.mesh.index(a, rank)]
        return whole

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf from this rank's block: gathered over the model
        group, then the data group (every rank of both takes part)."""
        for a, d in self._axes():
            x = all_gather_dim(x, d, self.mesh.groups[a])
        return x

    def counted(self) -> bool:
        """Whether this rank's block is the one of its kind a whole-tree
        sum counts: index 0 along each axis that does not cut it."""
        return all(self.mesh.index(a) == 0 for a, d in
                   (("data", self.data), ("model", self.model))
                   if d is None)

    def max_(self, t: torch.Tensor, rows: bool = False) -> None:
        """``t`` (this rank's block's statistic), in place, the maximum
        over the ranks holding the other blocks; ``rows``: ``t`` has one
        entry per row of dimension 0, so an axis that cuts dimension 0
        holds other rows and is skipped."""
        for a, d in self._axes():
            if not (rows and d == 0):
                dist.all_reduce(t, op=dist.ReduceOp.MAX,
                                group=self.mesh.groups[a])


def leaf_cuts(mesh: Mesh, rules: Dict[str, Axis], axes_tree: Any,
              shapes_tree: Any) -> Tuple[Any, List[Cut]]:
    """Each leaf's ``Cut`` under ``rules``: (the params tree's structure
    holding them, the same in leaf order)."""
    flat, tdef = T.flatten_with_def(tree_shardings(mesh, rules, axes_tree,
                                                   shapes_tree))
    cuts = [Cut(axis_dim(s.spec, "data"), axis_dim(s.spec, "model"), mesh)
            for _, s in flat]
    return tdef.unflatten(cuts), cuts


@dataclasses.dataclass
class MeshShards:
    """A params tree over the (data, model) mesh of the running process
    group. ``cfg`` is the model's config; ``dims`` the params tree's
    structure with each leaf's ``Cut``; ``flat_dims`` the same in leaf
    order; ``stacks`` the top-level subtrees whose leaves lead with a
    ``layers`` axis (``layer_stacks``), which the model gathers a layer
    at a time."""
    mesh: Mesh
    cfg: Any
    dims: Any
    flat_dims: List[Cut]
    stacks: FrozenSet[str]

    def __post_init__(self):
        make_constrain(self.mesh, {}, self.cfg)
        rank, world = rank_and_world()
        if not dist.is_initialized() or world != self.mesh.size \
                or rank != self.mesh.rank or self.mesh.groups is None:
            raise RuntimeError(
                f"a {self.mesh.shape} mesh at rank {self.mesh.rank} needs "
                f"a process group of {self.mesh.size} ranks; this process "
                f"is rank {rank} of {world}")
        self._data_dims = T.tree_map(lambda c: c.data, self.dims)

    @property
    def n(self) -> int:
        """D, the data axis's ranks."""
        return self.mesh.shape["data"]

    @property
    def data_group(self):
        return self.mesh.groups["data"]

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        """The dense family's tensor-parallel context (None for the other
        families, which run whole over a model axis of one): which of
        the heads, mlp and vocabulary blocks the rules cut."""
        if self.cfg.family != "dense" or self.cfg.num_experts:
            return None
        d = self.dims
        return ModelAxis(self.mesh.groups["model"], self.mesh.index("model"),
                         self.mesh.shape["model"],
                         heads=d["layers"]["attn"]["wq"].model is not None,
                         mlp=d["layers"]["mlp"]["wi_gate"].model is not None,
                         vocab=d["embed"]["embedding"].model is not None)

    def sharded(self) -> List[bool]:
        """Per leaf in leaf order: whether it is held as a block."""
        return [c.cut for c in self.flat_dims]

    def counted(self) -> List[bool]:
        """Per leaf in leaf order: ``Cut.counted`` (``global_norm``)."""
        return [c.counted() for c in self.flat_dims]

    def keep(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf ``i`` (a copy, so the whole leaf can
        go), or the leaf itself when this rank holds all of it: the
        ``keep`` of ``ModelApi.init``."""
        b = self.flat_dims[i].block(leaf)
        return leaf if b is leaf else b.clone()

    def gather(self, name: str, tree: Any) -> Any:
        """The model's gather hook: the subtree ``params[name]`` whole over
        the data axis (for a stack, one layer of it, as ``unstack`` took
        it apart); its model blocks stay this rank's."""
        return gather_slices(tree, self._data_dims[name],
                             1 if name in self.stacks else 0,
                             self.data_group)

    def sync_grads(self, grads: Any) -> None:
        """Sum over the data group, in place, the gradients of the leaves
        whole over ``data`` (the data-sharded leaves' sums come from
        ``GatherSlice``'s reduce-scatter). Over ``model`` every gradient
        arrives summed: the tensor-parallel blocks' own are the rank's,
        and a leaf whole over ``model`` feeds a cut block only through
        ``CopyToModel``."""
        for g, c in zip(T.leaves(grads), self.flat_dims):
            if c.data is None:
                dist.all_reduce(g, group=self.data_group)

    def state_dims(self) -> Dict[str, Any]:
        """``dims`` over a ``{"params", "opt"}`` checkpoint state: the
        moments lie as their parameters, the step is whole."""
        return {"params": self.dims,
                "opt": OptState(None, self.dims, self.dims)}


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


def mesh_shards(mesh: Mesh, rules: Dict[str, Axis], api) -> MeshShards:
    """The ``MeshShards`` of a ``ModelApi``'s parameters under ``rules``,
    on this process's rank of the group."""
    axes = api.param_axes()
    return MeshShards(mesh, api.cfg,
                      *leaf_cuts(mesh, rules, axes, api.param_shapes()),
                      stacks=layer_stacks(axes))


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
