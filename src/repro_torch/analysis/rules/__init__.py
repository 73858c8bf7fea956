"""Rule registry: importing this package registers every rule with the
engine (see ``repro_torch.analysis.engine.register_rule``). New rules: add
a module here, import it below, give it fixture coverage in
tests/test_torch_analysis.py (one true positive, one true negative, one
waiver case)."""
from repro_torch.analysis.rules import host_sync  # noqa: F401
from repro_torch.analysis.rules import metrics_discipline  # noqa: F401
from repro_torch.analysis.rules import operand_discipline  # noqa: F401
from repro_torch.analysis.rules import registry_discipline  # noqa: F401
from repro_torch.analysis.rules import rng_streams  # noqa: F401
from repro_torch.analysis.rules import shard_locality  # noqa: F401
from repro_torch.analysis.rules import tree_carry  # noqa: F401
