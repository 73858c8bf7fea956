"""Twins of the reference's benchmarks (``benchmarks/``), each
``run(..., device=None)`` with the reference module's signature and
result keys, on the card unless the caller asks for the CPU: the paper's
Table 1 and Figs. 2, 6, 12, 13, 14 and 15/16, and the serving stack's
``kernel_bench``, ``serving_energy``, ``endurance_sweep``,
``prefix_reuse``, ``workload_mixes``, ``telemetry_overhead`` and
``shard_scaling``. ``python -m repro_torch.benchmarks.run`` runs them;
each also runs alone, ``python -m repro_torch.benchmarks.<name>``, with
the reference module's flags plus ``--device``, and prints what the
reference's ``main`` prints."""
import argparse


def arg_parser(doc: str, fast: bool = False) -> argparse.ArgumentParser:
    """A benchmark module's command line: ``--fast`` where the reference
    module takes it, and ``--device`` (cuda, the default, or cpu)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    if fast:
        ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap
