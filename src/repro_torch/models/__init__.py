"""Model API of the port over every family of the reference: dense
and moe (the transformer; moe with mixture-of-experts FFNs), hybrid
(recurrentgemma), ssm (mamba2), vlm (llava: the transformer behind a
projected image) and audio (whisper, encoder-decoder). ``prefill`` and
``forward_hidden`` take the whole batch dict for vlm (``image_embeds``)
and audio (``frames``), the tokens for the others.

Training: ``forward_hidden`` (final-norm hidden states and the aux
losses), ``logits`` of any slice of them, and the descriptor-derived
trees ``param_axes`` / ``param_shapes``. ``batch_shapes`` gives a shape
cell's input (shape, dtype) pairs; token ids are int64 (torch's index
type; the reference's are int32)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import rglru, ssm, transformer, vlm, whisper
from repro_torch.models.layers import (init_from_descs, no_constrain,
                                       no_gather, param_count,
                                       shapes_from_descs, specs_from_descs,
                                       unembed)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}

#: family -> the module serving it
_FAMILIES = {"dense": transformer, "moe": transformer, "hybrid": rglru,
             "ssm": ssm, "vlm": vlm, "audio": whisper}
#: families whose prefill takes the whole batch (multimodal leaves)
_BATCH_PREFILL = ("vlm", "audio")


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in _FAMILIES:
            raise ValueError(self.cfg.family)

    @property
    def _module(self):
        return _FAMILIES[self.cfg.family]

    @property
    def param_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.param_dtype)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.compute_dtype)

    def descs(self):
        return self._module.descs(self.cfg)

    def init(self, seed: int, device, keep=None) -> Dict[str, Any]:
        """The seeded parameters; ``keep(i, leaf)``: what is kept of leaf
        ``i`` (``init_from_descs``)."""
        return init_from_descs(seed, self.descs(), self.param_dtype,
                               torch.device(device), keep)

    def param_axes(self):
        return specs_from_descs(self.descs())

    def param_shapes(self):
        return shapes_from_descs(self.descs())

    def num_params(self) -> int:
        return param_count(self.descs())

    def active_params_per_token(self) -> int:
        """For MODEL_FLOPS = 6 * N_active * D accounting: the MoE layers
        count their ``experts_per_token`` experts only."""
        total = self.num_params()
        cfg = self.cfg
        if not cfg.num_experts:
            return total
        per_expert = 3 * cfg.d_model * cfg.d_ff * cfg.num_layers
        return (total - per_expert * cfg.num_experts
                + per_expert * cfg.experts_per_token)

    def forward_hidden(self, params, batch: Dict[str, torch.Tensor], *,
                       remat=True, constrain=no_constrain, gather=no_gather,
                       moe_group=None, model_axis=None):
        """(hidden states (B, S_total, D), aux dict) of a training batch;
        the transformer families' aux holds ``lb_loss``, and with experts
        ``dropped``. ``gather(name, subtree)`` makes the leaves of a
        data-sharded tree whole where each family uses them;
        ``moe_group`` (a ``moe.TokenGroup``) reaches a model with
        experts, whose dispatch then serves the group's rows;
        ``model_axis`` (a ``layers.ModelAxis``) cuts the dense family
        over the model axis."""
        kw = dict(remat=remat, constrain=constrain, gather=gather)
        if moe_group is not None and self.cfg.num_experts:
            kw["moe_group"] = moe_group
        if model_axis is not None:
            kw["model_axis"] = model_axis
        if self.cfg.family in _BATCH_PREFILL:
            return self._module.hidden_forward(params, batch, self.cfg, **kw)
        return self._module.hidden_forward(params, batch["tokens"], self.cfg,
                                           **kw)

    def logits(self, params, h: torch.Tensor, model_axis=None
               ) -> torch.Tensor:
        """float32 logits of hidden states (B, S, D); over a
        ``model_axis`` that cuts the vocabulary, this rank's columns."""
        if self.cfg.family == "audio":
            return whisper.logits_fn(params, h, self.cfg)
        return unembed(params["embed"], h, self.cfg, model_axis)

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_seq: int):
        if self.cfg.family in _BATCH_PREFILL:
            return self._module.prefill(params, batch, self.cfg, max_seq)
        return self._module.prefill(params, batch["tokens"], self.cfg,
                                    max_seq)

    def init_cache(self, batch_size: int, max_seq: int, device):
        return self._module.init_cache(self.cfg, batch_size, max_seq,
                                       self.compute_dtype, device)

    def decode_step(self, params, token, cache, pos, max_seq: int):
        return self._module.decode_step(params, token, cache, pos, self.cfg,
                                        max_seq)

    def cache_axes(self):
        return self._module.cache_axes(self.cfg)

    def batch_shapes(self, shape: ShapeConfig
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Train/prefill inputs of a shape cell: name -> (shape, dtype).
        audio: ``frames`` over the cell's length and ``dec`` decoder
        tokens (the length when training, else max(64, S // 512)); vlm:
        the image tokens lead, ``n_txt = S - num_image_tokens`` text
        tokens, labels over all S positions."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i64 = torch.int64
        train = shape.kind == "train"
        if cfg.family == "audio":
            dec = S if train else max(64, S // 512)
            out = {"frames": ((B, S, cfg.d_model), self.compute_dtype),
                   "tokens": ((B, dec), i64)}
            if train:
                out["labels"] = ((B, dec), i64)
            return out
        if cfg.family == "vlm":
            n_txt = S - cfg.num_image_tokens
            assert n_txt > 0, (S, cfg.num_image_tokens)
            out = {"image_embeds": ((B, cfg.num_image_tokens,
                                     cfg.vision_dim), self.compute_dtype),
                   "tokens": ((B, n_txt), i64)}
            if train:
                out["labels"] = ((B, S), i64)
            return out
        out = {"tokens": ((B, S), i64)}
        if train:
            out["labels"] = ((B, S), i64)
        return out

    def batch_axes(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        return {name: ("batch",) + (None,) * (len(shp) - 1)
                for name, (shp, _) in self.batch_shapes(shape).items()}

    def prompt_len(self, batch: Dict[str, torch.Tensor]) -> int:
        """Cache columns a prompt fills: the vlm's image columns lead its
        tokens."""
        extra = self.cfg.num_image_tokens if self.cfg.family == "vlm" else 0
        return batch["tokens"].shape[1] + extra


def get_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg)
