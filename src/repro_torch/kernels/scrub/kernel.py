"""CUDA wrapper for the hand-written scrub kernel (csrc/scrub.cu).

The kernel replaces ``repro.kernels.scrub.kernel.scrub_kernel`` (the
Pallas TPU kernel). It is built with ``nvcc`` into a shared library with
a plain C interface at first use (``kernels.build``) and bound with
``ctypes``; the C function returns ``cudaGetLastError()`` and the
wrapper raises if that is not 0.

Bound by 16 bytes per lane (read stored and mask, write scrubbed and
residual) against the card's 3.35 TB/s where decay masks are sparse, as
in serving: a warp trip whose lanes hold no decayed bit copies them, one
with a few draws them bit by bit. Under a dense mask (a checkpoint
restore's) the draws bound: the warp walks the set planes of its masks'
OR and draws every lane at each. ``scrub_grid`` (C) picks the grid and
the kernel's vectors a thread from the lane count.

The kernel writes per-block partials, a (grid, 65) int32 tensor: each
row a block's 0->1 re-writes of planes 0..31, its 1->0 re-writes of
planes 0..31 and its failed re-writes. The wrapper turns them into the
stats with the twin's own ``ref.stats_from_partials`` (int64 sums over
the blocks, then the float64 per-plane energy rounded once to float32),
so on one device a scrub's energy equals the twin's bit for bit and a
call is deterministic.

``scrub_cuda`` (the ``ScrubCuda`` instance) is what the ``cuda``
backend's ``leaf_scrub`` calls. For CPU tensors it runs the plain twin
(``ref.scrub_ref``) — the only case in which it does; for CUDA tensors
it launches the kernel or raises. ``launches`` counts kernel launches
and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.scrub import ref as R


class ScrubCuda:
    """Callable wrapper: ``(stored_u, mask_u, seed, thr01, thr10, e01,
    e10)`` -> ``(scrubbed, residual, {energy_pj, flips01, flips10,
    errors})`` over flat int32 lane vectors, the same contract as
    ``ref.scrub_ref``."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            lib_path, _ = B.build("scrub")
            lib = ctypes.CDLL(str(lib_path))
            fn = lib.scrub_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_uint32,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.scrub_grid.argtypes = [ctypes.c_int64, ctypes.c_int]
            lib.scrub_grid.restype = ctypes.c_int
            self._grid = lib.scrub_grid
            lib.scrub_vecs.argtypes = [ctypes.c_int64]
            lib.scrub_vecs.restype = ctypes.c_int
            self._vecs = lib.scrub_vecs
            self._sparse_bits = lib.scrub_sparse_bits()
            self._parts = lib.scrub_parts()
            self._fn = fn
        return self._fn

    def __call__(self, stored_u: torch.Tensor, mask_u: torch.Tensor,
                 seed: int, thr01: torch.Tensor, thr10: torch.Tensor,
                 e01: torch.Tensor, e10: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Dict[str, torch.Tensor]]:
        if stored_u.device.type == "cpu":
            return R.scrub_ref(stored_u, mask_u, seed, thr01, thr10, e01,
                               e10)
        if stored_u.device.type != "cuda":
            raise ValueError(f"scrub: unsupported device {stored_u.device}")
        dev = stored_u.device
        for name, t, dt, n in (("stored", stored_u, torch.int32, None),
                               ("mask", mask_u, torch.int32, None),
                               ("thr01", thr01, torch.int32, 32),
                               ("thr10", thr10, torch.int32, 32),
                               ("e01", e01, torch.float32, 32),
                               ("e10", e10, torch.float32, 32)):
            if t.device != dev or t.dtype != dt or not t.is_contiguous():
                raise ValueError(f"scrub: {name} must be a contiguous {dt} "
                                 f"tensor on {dev}")
            if n is not None and t.shape != (n,):
                raise ValueError(f"scrub: {name} must have shape ({n},), "
                                 f"got {tuple(t.shape)}")
        if stored_u.shape != mask_u.shape or stored_u.dim() != 1:
            raise ValueError("scrub: stored/mask must be equal 1-D lanes")
        n = stored_u.numel()
        if n >= 2 ** 32:
            raise ValueError("scrub: lane index must fit 32 bits")
        fn = self._load()
        # the lanes before stored's first 16-byte boundary: the kernel's
        # vectors follow that grid
        lead = (stored_u.data_ptr() // 4) % 4
        grid = self._grid(n, lead)
        if grid <= 0:
            raise RuntimeError("scrub: the device's resident blocks could "
                               "not be queried")
        scrubbed = torch.empty_like(stored_u)
        residual = torch.empty_like(mask_u)
        parts = torch.empty((grid, self._parts), dtype=torch.int32,
                            device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(stored_u.data_ptr(), mask_u.data_ptr(), scrubbed.data_ptr(),
                residual.data_ptr(), n, lead, int(seed) & 0xFFFFFFFF,
                thr01.data_ptr(), thr10.data_ptr(), parts.data_ptr(), grid,
                stream)
        if rc != 0:
            raise RuntimeError(f"scrub kernel launch failed: CUDA error "
                               f"{rc}")
        self.launches += 1
        return scrubbed, residual, R.stats_from_partials(parts, e01, e10)


scrub_cuda = ScrubCuda()
