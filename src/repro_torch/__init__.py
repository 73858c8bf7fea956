"""repro_torch — the PyTorch/CUDA port of the EXTENT serving system.

A second package beside ``repro`` (the JAX reference, which stays as it
is). Its layout mirrors ``repro``'s so every module has its counterpart:
``configs``, ``core``, ``memory``, ``kernels``, ``models``, ``serve``,
``workload``, ``telemetry`` and ``launch``, plus ``rng`` (the host-side
threefry key schedule) and ``convert`` (the JAX parameter tree → torch).

The port imports torch, numpy and the standard library only. Entry points
run on CUDA unless ``device="cpu"`` is asked for.
"""
