"""Shared layers and the parameter-descriptor machinery (dense family).

Parameters keep the JAX package's layouts — ``ParamDesc(shape, axes)``
trees with a leading ``layers`` axis — so a tree converted from the JAX
package (``repro_torch.convert``) drops in unchanged. ``init_from_descs``
draws from a ``torch.Generator`` with the reference's per-descriptor
scale rule (std = scale / sqrt(fan_in)); its numbers differ from JAX's.

Training runs its layer stacks through ``unstack`` (one ``unbind`` per
stacked leaf, whose backward stacks the L per-layer gradients once) and
its remat units through ``remat_wrap``. Over the ``data`` axis of a
process group a leaf may be held as a slice of one dimension; the
model's ``gather(name, subtree)`` hook (``no_gather`` on one process)
makes it whole where it is used, through ``GatherSlice``, whose backward
reduce-scatters the gradient back onto the slice.

Over the ``model`` axis (``ModelAxis``) the dense family is tensor
parallel, Megatron-style, wherever the rules cut a block: a rank holds
its share of the attention heads, the MLP's hidden units and the
vocabulary. ``CopyToModel`` (identity forward, all-reduce backward)
leads into a cut block and ``ReduceFromModel`` (all-reduce forward,
identity backward) sums its row-parallel product out of it; the
embedding looks up the rank's vocabulary rows and sums, the logits are
the rank's vocabulary columns. Every model-axis collective adds one to
``model_collectives()``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_from_descs(seed: int, descs: Any, dtype: torch.dtype,
                    device: torch.device,
                    keep: Optional[Callable[[int, torch.Tensor],
                                            torch.Tensor]] = None) -> Any:
    """Materialize a descriptor tree on ``device``: norm scales 1 and
    biases 0 (as the reference initialises them), weights normal * std,
    drawn in float32 a bounded chunk at a time. ``keep(i, leaf)`` gives
    what is kept of leaf ``i`` (a rank's slice), so no more than one
    whole leaf exists at a time."""
    keep = keep or (lambda i, w: w)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat, tdef = T.flatten_with_def(descs)
    out = []
    for _, d in flat:
        if d.axes and d.axes[-1] in ("norm_scale", "bias"):
            fill = 1.0 if d.axes[-1] == "norm_scale" else 0.0
            out.append(keep(len(out), torch.full(d.shape, fill, dtype=dtype,
                                                 device=device)))
            continue
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(1, fan_in))
        w = torch.empty(d.shape, dtype=dtype, device=device)
        rows = max(1, (1 << 27) // max(1, math.prod(d.shape[1:])))
        for r0 in range(0, d.shape[0], rows):
            chunk = w[r0:r0 + rows]
            chunk.copy_(torch.randn(chunk.shape, generator=gen,
                                    device=device, dtype=torch.float32)
                        * std)
        out.append(keep(len(out), w))
    return tdef.unflatten(out)


def param_count(descs: Any) -> int:
    return sum(math.prod(d.shape) for d in T.leaves(descs))


def no_constrain(t, spec):
    """The sharding constraint of a one-device program: the identity
    (``sharding.rules.make_constrain`` returns it)."""
    return t


def no_gather(name: str, tree: Any) -> Any:
    """The parameter gather of a one-process program: the identity."""
    return tree


#: the collectives under their current names (older torch has only the
#: ``*_tensor`` ones)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The slices of one tensor over ``group`` (default: the whole
    group), its rank ``r``'s ``x`` at block ``r`` of dimension ``dim``: a
    new contiguous tensor."""
    n = dist.get_world_size(group)
    out = x.new_empty(n * x.numel())
    _ALL_GATHER(out, x.reshape(-1), group=group)
    shape = x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:]
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def reduce_scatter_dim(g: torch.Tensor, dim: int, group=None
                       ) -> torch.Tensor:
    """The sum over ``group`` of ``g`` (whole on every rank), cut to this
    rank's block of dimension ``dim``."""
    n = dist.get_world_size(group)
    parts = g.reshape(g.shape[:dim] + (n, g.shape[dim] // n)
                      + g.shape[dim + 1:]).movedim(dim, 0)
    out = g.new_empty(parts.shape[1:])
    _REDUCE_SCATTER(out.view(-1), parts.reshape(-1), group=group)
    return out


class GatherSlice(torch.autograd.Function):
    """Forward: all-gather a slice along ``dim`` over ``group``;
    backward: reduce-scatter (sum) the whole gradient onto the slice."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def gather_slices(tree: Any, dims: Any, lead: int = 0, group=None) -> Any:
    """Each leaf of ``tree`` whole over ``group``: a leaf whose entry in
    ``dims`` (a tree of the same structure) is a dimension is gathered
    along it less ``lead`` (1 for the layers of a stack ``unstack`` took
    apart), a leaf whose entry is None passes through."""
    return T.tree_map(
        lambda x, d: (x if d is None
                      else GatherSlice.apply(x, d - lead, group)),
        tree, dims)


# ---------------------------------------------------------------------------
# the model axis: tensor parallelism of the dense family

_MODEL_COLLECTIVES = [0]


def model_collectives() -> int:
    """Collectives issued on a model axis since the last
    ``reset_model_collectives``."""
    return _MODEL_COLLECTIVES[0]


def reset_model_collectives() -> None:
    _MODEL_COLLECTIVES[0] = 0


def _model_all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                      ) -> torch.Tensor:
    """``t`` reduced over ``group`` into a new tensor."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    _MODEL_COLLECTIVES[0] += 1
    return out


class CopyToModel(torch.autograd.Function):
    """Into a tensor-parallel block: the identity forward, the gradient
    summed over the model group backward (each rank's consumers see part
    of the block)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g, ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    """Out of a tensor-parallel block: the ranks' partial sums added
    forward, the (replicated) gradient passed through backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _model_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The ``model`` axis of a (data, model) mesh as the dense forward
    sees it: this rank's process subgroup along it, its index ``index``
    of ``size``, and which blocks the rules cut over it (``heads``: the
    attention's query heads, with ``wq``, ``bq`` and ``wo``; ``mlp``:
    the MLP's hidden units; ``vocab``: the embedding's rows and the
    unembedding's columns). A block the rules do not cut runs whole on
    every rank, as on one process."""
    group: Any
    index: int
    size: int
    heads: bool
    mlp: bool
    vocab: bool

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return CopyToModel.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return ReduceFromModel.apply(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the group (no gradient)."""
        return _model_all_reduce(x.detach(), self.group, dist.ReduceOp.MAX)

    def local(self, ids: torch.Tensor, n_local: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids into this rank's block of ``n_local`` of a cut dimension,
        clamped into it; whether each id lies in the block)."""
        rel = ids - self.index * n_local
        hit = (rel >= 0) & (rel < n_local)
        return rel.clamp(0, n_local - 1), hit


def specs_from_descs(descs: Any) -> Any:
    """Descriptor tree -> the same tree of logical-axes tuples."""
    return T.tree_map(lambda d: d.axes, descs)


def shapes_from_descs(descs: Any) -> Any:
    """Descriptor tree -> the same tree of shape tuples."""
    return T.tree_map(lambda d: d.shape, descs)


#: the products the ``"selective"`` policy saves: matrix products without
#: batch dimensions (every ``x @ W`` of the models reaches aten as ``mm``
#: on the flattened rows), JAX's ``dots_with_no_batch_dims_saveable``;
#: ``bmm`` (attention's einsums, the MoE experts) is recomputed, as JAX
#: recomputes a dot with batch dimensions
SELECTIVE_SAVE = (torch.ops.aten.mm.default,)


def _selective_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in SELECTIVE_SAVE
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn: Callable, remat) -> Callable:
    """Remat policy of a layer-group body (the reference's ``remat_wrap``).

    True/'full'  -> ``torch.utils.checkpoint``: the group's inputs are
                    kept, everything else recomputed in the backward
    'selective'  -> checkpoint that also keeps ``SELECTIVE_SAVE``'s
                    outputs (the matmuls against the weights)
    False        -> no checkpoint (every activation kept)
    """
    if remat is True or remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if remat == "selective":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            preserve_rng_state=False, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts,
                _selective_policy))
    if remat is False:
        return fn
    raise ValueError(f"unknown remat policy {remat!r}")


def unstack(stack: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A tree of per-layer stacks (leading ``layers`` axis) -> one tree
    per layer, each leaf a view. One ``unbind`` per leaf: its backward
    stacks the L gradients once (indexing layer by layer would build a
    full-size zero gradient per layer)."""
    flat, tdef = T.flatten_with_def(stack)
    cols = [torch.unbind(leaf, 0) for _, leaf in flat]
    return [tdef.unflatten([c[l] for c in cols])
            for l in range(len(cols[0]))]


def layer_at(stack: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l`` of a tree of per-layer stacks (leading ``layers``
    axis): the same tree with every leaf indexed at ``l``."""
    return {k: (layer_at(v, l) if isinstance(v, dict) else v[l])
            for k, v in stack.items()}


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    if theta <= 0.0:
        return x
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoid_positions(seq_len: int, d_model: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position encodings (seq_len, d_model) in
    float32, [sin | cos] over ``d_model // 2`` frequencies whose exponent
    divides by ``max(1, half - 1)``, as in the reference."""
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    return sinusoid_at(pos, d_model)


def sinusoid_at(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """The encodings of the positions ``pos`` (any shape): (..., d_model)
    float32."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=pos.device) / max(1, half - 1))
    ang = pos.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mlp_descs(cfg: ModelConfig, layers: int) -> Dict[str, ParamDesc]:
    L, D, Fd = layers, cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamDesc((L, D, Fd), ("layers", "embed", "mlp")),
        "wi_up": ParamDesc((L, D, Fd), ("layers", "embed", "mlp")),
        "wo": ParamDesc((L, Fd, D), ("layers", "mlp", "embed")),
    }


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              act: str = "silu", axis: Optional[ModelAxis] = None
              ) -> torch.Tensor:
    """The gated MLP; over a ``ModelAxis`` that cuts ``mlp``,
    column-parallel ``wi_gate``/``wi_up`` and row-parallel ``wo``."""
    cut = axis is not None and axis.mlp
    if cut:
        x = axis.copy_in(x)
    gate = x @ p["wi_gate"]
    up = x @ p["wi_up"]
    g32 = gate.float()
    a = F.silu(g32) if act == "silu" else F.gelu(g32, approximate="tanh")
    out = (a.to(x.dtype) * up) @ p["wo"]
    return axis.reduce_out(out) if cut else out


def embed_descs(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    emb_scale = math.sqrt(cfg.vocab_size / cfg.d_model)
    d = {"embedding": ParamDesc((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"), scale=emb_scale)}
    if not cfg.tie_embeddings:
        d["unembedding"] = ParamDesc((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    return d


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig,
                 axis: Optional[ModelAxis] = None) -> torch.Tensor:
    """The tokens' embedding rows; over a ``ModelAxis`` that cuts
    ``vocab`` each rank looks up the tokens in its rows, zeros the
    others and the ranks' rows are summed (exact: one term is not
    zero)."""
    if axis is not None and axis.vocab:
        rows, hit = axis.local(tokens, p["embedding"].shape[0])
        emb = axis.reduce_out(torch.where(hit[..., None],
                                          p["embedding"][rows], 0.0))
    else:
        emb = p["embedding"][tokens]
    if cfg.tie_embeddings:
        # the scale rounds to the compute dtype first, as in the reference
        emb = emb * float(torch.tensor(math.sqrt(cfg.d_model),
                                       dtype=emb.dtype))
    return emb


def unembed(p, h: torch.Tensor, cfg: ModelConfig,
            axis: Optional[ModelAxis] = None) -> torch.Tensor:
    """Logits in float32: exact for float32 models; for bfloat16 the
    product accumulates in float32 inside the matmul and rounds once.
    Over a ``ModelAxis`` that cuts ``vocab``: this rank's columns of the
    vocabulary, softcapped elementwise."""
    if axis is not None and axis.vocab:
        h = axis.copy_in(h)
    if cfg.tie_embeddings:
        logits = h @ p["embedding"].t()
    else:
        logits = h @ p["unembedding"]
    return softcap(logits.float(), cfg.final_logit_softcap)
