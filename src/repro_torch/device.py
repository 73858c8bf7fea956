"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda``, and a missing CUDA device is an error —
the port never falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on a CUDA device unless "
            "the CPU is asked for explicitly (device='cpu' / --device cpu)")
    return dev
