"""LLaVA-NeXT-style VLM, vlm family: projected patch embeddings ahead of
the transformer LM.

The counterpart of ``repro.models.vlm``. As in the reference the vision
tower and anyres tiling are a stub: the batch carries precomputed patch
embeddings ``image_embeds`` (B, num_image_tokens, vision_dim); the
multimodal projector (two layers, tanh GELU in float32) and the LM run
here. The cache, decode step and cache axes are the transformer's; the
image columns lead each row of the KV ring, and the training forward's
hidden states (and labels) span the image positions too.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import ParamDesc, no_constrain
from repro_torch.models.transformer import (cache_axes, decode_step,  # noqa: F401
                                            init_cache)


def descs(cfg: ModelConfig) -> Dict[str, Any]:
    d = transformer.descs(cfg)
    d["projector"] = {
        "w1": ParamDesc((cfg.vision_dim, cfg.d_model), ("vision", "embed")),
        "b1": ParamDesc((cfg.d_model,), ("bias",)),
        "w2": ParamDesc((cfg.d_model, cfg.d_model), ("embed", None)),
        "b2": ParamDesc((cfg.d_model,), ("bias",)),
    }
    return d


def project(params, image_embeds: torch.Tensor, dtype) -> torch.Tensor:
    """(B,N,vision_dim) -> (B,N,d_model) in ``dtype``."""
    p = params["projector"]
    h = image_embeds.to(dtype) @ p["w1"]
    h = F.gelu((h + p["b1"]).float(), approximate="tanh").to(dtype)
    return h @ p["w2"] + p["b2"]


def hidden_forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   *, remat=True, constrain=no_constrain):
    """The training forward: the projected image ahead of the tokens."""
    img = project(params, batch["image_embeds"],
                  getattr(torch, cfg.compute_dtype))
    return transformer.hidden_forward(params, batch["tokens"], cfg,
                                      extra_embeds=img, remat=remat,
                                      constrain=constrain)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_seq: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    img = project(params, batch["image_embeds"],
                  getattr(torch, cfg.compute_dtype))
    return transformer.prefill(params, batch["tokens"], cfg, max_seq,
                               extra_embeds=img)
