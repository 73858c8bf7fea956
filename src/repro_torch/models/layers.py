"""Shared layers and the parameter-descriptor machinery (dense family).

Parameters keep the JAX package's layouts — ``ParamDesc(shape, axes)``
trees with a leading ``layers`` axis — so a tree converted from the JAX
package (``repro_torch.convert``) drops in unchanged. ``init_from_descs``
draws from a ``torch.Generator`` with the reference's per-descriptor
scale rule (std = scale / sqrt(fan_in)); its numbers differ from JAX's.

Training runs its layer stacks through ``unstack`` (one ``unbind`` per
stacked leaf, whose backward stacks the L per-layer gradients once) and
its remat units through ``remat_wrap``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Tuple

import torch
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
                    device: torch.device) -> Any:
    """Materialize a descriptor tree on ``device``: norm scales 1 and
    biases 0 (as the reference initialises them), weights normal * std,
    drawn in float32 a bounded chunk at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat, tdef = T.flatten_with_def(descs)
    out = []
    for _, d in flat:
        if d.axes and d.axes[-1] in ("norm_scale", "bias"):
            fill = 1.0 if d.axes[-1] == "norm_scale" else 0.0
            out.append(torch.full(d.shape, fill, dtype=dtype, device=device))
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
        out.append(w)
    return tdef.unflatten(out)


def param_count(descs: Any) -> int:
    return sum(math.prod(d.shape) for d in T.leaves(descs))


def no_constrain(t, spec):
    """The sharding constraint of a one-device program: the identity
    (``sharding.rules.make_constrain`` returns it)."""
    return t


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
              act: str = "silu") -> torch.Tensor:
    gate = x @ p["wi_gate"]
    up = x @ p["wi_up"]
    g32 = gate.float()
    a = F.silu(g32) if act == "silu" else F.gelu(g32, approximate="tanh")
    return (a.to(x.dtype) * up) @ p["wo"]


def embed_descs(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    emb_scale = math.sqrt(cfg.vocab_size / cfg.d_model)
    d = {"embedding": ParamDesc((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"), scale=emb_scale)}
    if not cfg.tie_embeddings:
        d["unembedding"] = ParamDesc((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    return d


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    emb = p["embedding"][tokens]
    if cfg.tie_embeddings:
        # the scale rounds to the compute dtype first, as in the reference
        emb = emb * float(torch.tensor(math.sqrt(cfg.d_model),
                                       dtype=emb.dtype))
    return emb


def unembed(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits in float32: exact for float32 models; for bfloat16 the
    product accumulates in float32 inside the matmul and rounds once."""
    if cfg.tie_embeddings:
        logits = h @ p["embedding"].t()
    else:
        logits = h @ p["unembedding"]
    return softcap(logits.float(), cfg.final_logit_softcap)
