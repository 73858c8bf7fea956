"""CUDA wrapper for the hand-written local_attention kernel
(csrc/local_attention.cu).

The kernel replaces
``repro.kernels.local_attention.kernel.local_attention_kernel`` (the
Pallas TPU kernel). It is built with ``nvcc`` into a shared library with
a plain C interface at first use (``kernels.build``) and bound with
``ctypes``; the C function returns a CUDA error code and the wrapper
raises if it is not 0.

Bound by operations at the hybrid prefill's shape: 4 x H x h FLOP per
live (query, key) pair, about 4.3e10 FLOP for recurrentgemma-2b's
3072-token prompt, against about 35 MB of traffic. bfloat16 inputs run
on the tensor cores (``mma.sync``, float32 accumulation, probabilities
kept to 16 significant bits for p.v); float32 inputs on the CUDA cores.

``local_attention_cuda`` (the ``LocalAttentionCuda`` instance) is what
``ops.local_attention`` calls. For CPU tensors it runs the plain version
(``ref.local_attention_ref``) — the only case in which it does; for CUDA
tensors it launches the kernel or raises. ``launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.local_attention import ref as R

_DTYPES = (torch.float32, torch.bfloat16)


class LocalAttentionCuda:
    """Callable wrapper: ``(q, k, v, *, window, softcap)`` -> attention
    output, the same contract as ``ref.local_attention_ref``."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            lib_path, _ = B.build("local_attention")
            fn = ctypes.CDLL(str(lib_path)).local_attention_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 *, window: int, softcap: float = 0.0) -> torch.Tensor:
        if q.device.type == "cpu":
            return R.local_attention_ref(q, k, v, window=window,
                                         softcap=softcap)
        if q.device.type != "cuda":
            raise ValueError(f"local_attention: unsupported device "
                             f"{q.device}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if (t.device != q.device or t.dtype != q.dtype
                    or not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(f"local_attention: {name} must be a "
                                 f"contiguous, 16-byte aligned {q.dtype} "
                                 f"tensor on {q.device}")
        if q.dtype not in _DTYPES:
            raise ValueError(f"local_attention: dtype {q.dtype} (float32 "
                             f"or bfloat16)")
        Bn, S, H, h = q.shape
        if h % 4 or h > 256:
            raise ValueError(f"local_attention: head width {h} (a multiple "
                             f"of 4, at most 256)")
        fn = self._load()
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                Bn, S, H, k.shape[2], h, int(window), h ** -0.5,
                float(softcap), int(q.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"local_attention kernel launch failed: CUDA "
                               f"error {rc}")
        self.launches += 1
        return out


local_attention_cuda = LocalAttentionCuda()
