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
3072-token prompt (0.0434 ms at the H100's dense bf16 rate; 0.065 ms with
the p.v products doubled by the split p below), against about 35 MB of
traffic.

Three kernels (``ROUTES``), one per (dtype, h) as ``route`` says and the
C dispatch does:

* ``wgmma_tma`` — bfloat16 at h 64, 128, 256 (the served model's 256):
  a persistent, warp-specialised kernel, one TMA producer warp and two
  consumer warpgroups on ``wgmma`` taking the tensor cores in turns. At
  h 256 the consumer warpgroups split the output columns, at 64 and 128
  the query rows (registers: the 64 x 256 float32 output fits only
  split).
* ``mma_sync`` — bfloat16 at any other width (``chip_smoke.py``'s cases
  use 80, 32 and 16): ``mma.sync`` m16n8k16, which takes any multiple of
  4 by padding to a power of two, where the wgmma kernel's 64-column TMA
  boxes need h to be 64, 128 or 256.
* ``cuda_cores`` — float32: FMAs on the CUDA cores, since the tensor
  cores would round float32 inputs.

Both bf16 kernels accumulate in float32 and keep the probabilities to 16
significant bits for p.v (p = hi + lo, two bf16 products).

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
#: the kernels of csrc/local_attention.cu, by the number its C dispatch
#: gives them
ROUTES = ("cuda_cores", "mma_sync", "wgmma_tma")
#: head widths the wgmma/TMA kernel is built for
WGMMA_WIDTHS = (64, 128, 256)


def route(dtype: torch.dtype, h: int) -> str:
    """The kernel the C dispatch (``route`` in csrc/local_attention.cu)
    launches for ``dtype`` and head width ``h``: float32 on the CUDA
    cores; bfloat16 through wgmma fed by TMA at h 64, 128 and 256, and
    through mma.sync at every other width."""
    if dtype != torch.bfloat16:
        return "cuda_cores"
    return "wgmma_tma" if h in WGMMA_WIDTHS else "mma_sync"


class LocalAttentionCuda:
    """Callable wrapper: ``(q, k, v, *, window, softcap)`` -> attention
    output, the same contract as ``ref.local_attention_ref``."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            lib_path, _ = B.build("local_attention")
            lib = ctypes.CDLL(str(lib_path))
            fn = lib.local_attention_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self.c_route = lib.local_attention_route
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
