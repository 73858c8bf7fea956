"""CUDA wrapper for the hand-written kv_quant kernel (csrc/kv_quant.cu).

The kernel replaces ``repro.kernels.kv_quant.kernel.kv_quant_kernel``
(the Pallas TPU kernel). It is built with ``nvcc`` into a shared library
with a plain C interface at first use (``kernels.build``) and bound with
``ctypes``; the C function returns ``cudaGetLastError()`` and the wrapper
raises if that is not 0.

Bound by integer issue, not memory: each element is read once (2 or 4
bytes) and its int8 payload written once (a bfloat16 K or V leaf of
recurrentgemma-2b's served cache is 16.8 M elements, 0.015 ms at
3.35 TB/s), but every set payload bit costs a counter-hash draw, about
4 an element. The kernel reads 16-byte vectors and draws every plane of
every element with compile-time plane constants (csrc/kv_quant.cu says
why).

``kv_quant_cuda`` (the ``KvQuantCuda`` instance) is what
``ops.kv_quant_store`` calls, on the flat tensor. For CPU tensors it pads
to whole 64 x 128 blocks and runs the twin (``ref.kv_quant_ref``) — the
only case in which it does; for CUDA tensors it launches the kernel,
which reads the flat tensor as it is (at any element offset) and treats
the padding as zeros, or raises. ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.kv_quant import ref as R

_BLOCK_ELEMS = R.BLOCK[0] * R.BLOCK[1]


def pad_rows(flat: torch.Tensor) -> torch.Tensor:
    """Flat tensor -> (R, 128) float32 rows zero-padded to whole 64-row
    blocks: the reference wrapper's layout."""
    pad = (-flat.numel()) % _BLOCK_ELEMS
    x = torch.cat([flat.float(), flat.new_zeros(pad, dtype=torch.float32)])
    return x.reshape(-1, R.BLOCK[1])


class KvQuantCuda:
    """Callable wrapper: ``(flat, seed, thr)`` -> ``(stored int8 (n,),
    scales (blocks, 1) f32, errors (blocks, 1) int32)`` for a flat
    float32 or bfloat16 tensor of n elements."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            lib_path, _ = B.build("kv_quant")
            fn = ctypes.CDLL(str(lib_path)).kv_quant_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, flat: torch.Tensor, seed: int, thr: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n = flat.numel()
        if flat.device.type == "cpu":
            stored, scales, errors = R.kv_quant_ref(pad_rows(flat), seed,
                                                    thr)
            return stored.reshape(-1)[:n], scales, errors
        if flat.device.type != "cuda":
            raise ValueError(f"kv_quant: unsupported device {flat.device}")
        if (flat.dim() != 1 or not flat.is_contiguous() or n == 0
                or flat.dtype not in (torch.float32, torch.bfloat16)):
            raise ValueError("kv_quant: a non-empty contiguous 1-D float32 "
                             "or bfloat16 tensor")
        if (thr.device != flat.device or thr.dtype != torch.int32
                or thr.shape != (8,)):
            raise ValueError(f"kv_quant: thr must be (8,) int32 on "
                             f"{flat.device}")
        fn = self._load()
        blocks = -(-n // _BLOCK_ELEMS)
        stored = torch.empty((n,), dtype=torch.int8, device=flat.device)
        scales = torch.empty((blocks, 1), dtype=torch.float32,
                             device=flat.device)
        errors = torch.empty((blocks, 1), dtype=torch.int32,
                             device=flat.device)
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = fn(flat.data_ptr(), n, int(seed) & 0xFFFFFFFF, thr.data_ptr(),
                stored.data_ptr(), scales.data_ptr(), errors.data_ptr(),
                int(flat.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"kv_quant kernel launch failed: CUDA error "
                               f"{rc}")
        self.launches += 1
        return stored, scales, errors


kv_quant_cuda = KvQuantCuda()
