"""JAX parameter tree (as numpy arrays) -> the port's parameter tree.

The port keeps the JAX package's parameter layouts, so conversion is a
leaf-wise copy: ``params_from_jax(jax.tree.map(np.asarray, params))``.
bfloat16 leaves (numpy's ml_dtypes extension type) cross as their 16-bit
patterns.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as T


def _leaf(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def params_from_jax(tree_of_numpy: Any, device="cpu") -> Any:
    return T.tree_map(lambda a: _leaf(a, device), tree_of_numpy)
