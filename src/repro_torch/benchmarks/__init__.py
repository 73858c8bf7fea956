"""Twins of the reference's paper benchmarks (``benchmarks/``): Table 1
and Figs. 2, 6, 12, 14 and 15/16, each ``run(..., device=None)`` with the
reference module's signature and result keys, on the card unless the
caller asks for the CPU. ``python -m repro_torch.benchmarks.run`` runs
them."""
