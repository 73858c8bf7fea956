"""CUDA wrapper for the hand-written extent_write kernel (csrc/extent_write.cu).

The kernel replaces ``repro.kernels.extent_write.kernel.extent_write_kernel``
(the Pallas TPU kernel). It is built with ``nvcc`` into a shared library
with a plain C interface at first use (``kernels.build``) and bound
with ``ctypes`` — pointers and the stream pass as ``c_void_p``; the C
function returns ``cudaGetLastError()`` and the wrapper raises if that
is not 0.

Its byte bound is 12 bytes per lane (read old and new, write stored)
against the card's 3.35 TB/s, but at admission sizes the integer ALU
bounds it: each flipped plane costs a hash of about a dozen integer
operations. A warp queues its flipped (lane, plane) pairs and shares
them out evenly among its threads. The decode column write (~18k lanes per leaf at batch 4 for
qwen2.5-3b) is bound by launch latency instead.

``extent_write_cuda`` (the ``ExtentWriteCuda`` instance) is what the
``cuda`` backend calls. For CPU tensors it runs the plain twin
(``ref.extent_write_ref``) — the only case in which it does; for CUDA
tensors it launches the kernel or raises. ``launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.extent_write import ref as R


class ExtentWriteCuda:
    """Callable wrapper: ``(old_u, new_u, seed, thr01, thr10, e01, e10)``
    -> ``(stored, {energy_pj, flips01, flips10, errors})`` over flat int32
    lane vectors, the same contract as ``ref.extent_write_ref``."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            lib_path, _ = B.build("extent_write")
            lib = ctypes.CDLL(str(lib_path))
            fn = lib.extent_write_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._threads = lib.extent_write_threads()
            self._fn = fn
        return self._fn

    def __call__(self, old_u: torch.Tensor, new_u: torch.Tensor, seed: int,
                 thr01: torch.Tensor, thr10: torch.Tensor,
                 e01: torch.Tensor, e10: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if old_u.device.type == "cpu":
            return R.extent_write_ref(old_u, new_u, seed, thr01, thr10,
                                      e01, e10)
        if old_u.device.type != "cuda":
            raise ValueError(f"extent_write: unsupported device "
                             f"{old_u.device}")
        dev = old_u.device
        for name, t, dt, n in (("old", old_u, torch.int32, None),
                               ("new", new_u, torch.int32, None),
                               ("thr01", thr01, torch.int32, 32),
                               ("thr10", thr10, torch.int32, 32),
                               ("e01", e01, torch.float32, 32),
                               ("e10", e10, torch.float32, 32)):
            if t.device != dev or t.dtype != dt or not t.is_contiguous():
                raise ValueError(f"extent_write: {name} must be a "
                                 f"contiguous {dt} tensor on {dev}")
            if n is not None and t.shape != (n,):
                raise ValueError(f"extent_write: {name} must have shape "
                                 f"({n},), got {tuple(t.shape)}")
        if old_u.shape != new_u.shape or old_u.dim() != 1:
            raise ValueError("extent_write: old/new must be equal 1-D lanes")
        n = old_u.numel()
        if n >= 2 ** 32:
            raise ValueError("extent_write: lane index must fit 32 bits")
        fn = self._load()
        grid = max(1, min(B.MAX_GRID, -(-n // self._threads)))
        stored = torch.empty_like(new_u)
        part_e = torch.empty((grid,), dtype=torch.float32, device=dev)
        part_c = torch.empty((3, grid), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(old_u.data_ptr(), new_u.data_ptr(), stored.data_ptr(), n,
                int(seed) & 0xFFFFFFFF, thr01.data_ptr(), thr10.data_ptr(),
                e01.data_ptr(), e10.data_ptr(), part_e.data_ptr(),
                part_c.data_ptr(), grid, stream)
        if rc != 0:
            raise RuntimeError(f"extent_write kernel launch failed: CUDA "
                               f"error {rc}")
        self.launches += 1
        counts = part_c.to(torch.int64).sum(dim=1)
        return stored, {"energy_pj": part_e.sum(), "flips01": counts[0],
                        "flips10": counts[1], "errors": counts[2]}


extent_write_cuda = ExtentWriteCuda()

