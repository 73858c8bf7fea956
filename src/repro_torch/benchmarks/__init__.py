"""Twins of the reference's benchmarks (``benchmarks/``), each
``run(..., device=None)`` with the reference module's signature and
result keys, on the card unless the caller asks for the CPU: the paper's
Table 1 and Figs. 2, 6, 12, 13, 14 and 15/16, and the serving stack's
``kernel_bench``, ``serving_energy``, ``endurance_sweep``,
``prefix_reuse``, ``workload_mixes``, ``telemetry_overhead`` and
``shard_scaling``. ``python -m repro_torch.benchmarks.run`` runs them."""
