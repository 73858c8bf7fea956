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

The port runs on one device: ``make_constrain`` is the identity on a
mesh whose every axis has size 1 and refuses any other, so a program
laid out for several devices cannot run silently unsharded.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.models.layers import no_constrain
from repro_torch.sharding.mesh import Mesh, NamedSharding

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
    a mesh of one device (every axis size 1). A mesh over more devices
    raises here: the port has no multi-device sharding."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"sharding over a {mesh.shape} mesh of {mesh.size} devices: "
            "the port runs on one device")
    return no_constrain


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
