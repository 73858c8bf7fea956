"""Model API of the port over every family the reference serves: dense
and moe (the transformer; moe with mixture-of-experts FFNs), hybrid
(recurrentgemma), ssm (mamba2), vlm (llava: the transformer behind a
projected image) and audio (whisper, encoder-decoder). ``prefill`` takes
the whole batch dict for vlm (``image_embeds``) and audio (``frames``),
the tokens for the others."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, ssm, transformer, vlm, whisper
from repro_torch.models.layers import init_from_descs, param_count

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

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

    def init(self, seed: int, device) -> Dict[str, Any]:
        return init_from_descs(seed, self.descs(), self.param_dtype,
                               torch.device(device))

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

    def prompt_len(self, batch: Dict[str, torch.Tensor]) -> int:
        """Cache columns a prompt fills: the vlm's image columns lead its
        tokens."""
        extra = self.cfg.num_image_tokens if self.cfg.family == "vlm" else 0
        return batch["tokens"].shape[1] + extra


def get_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg)
