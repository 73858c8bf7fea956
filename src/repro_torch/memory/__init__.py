"""repro_torch.memory — the EXTENT write-path substrate of the port.

``WritePlan`` (resolve-once policy), the backend registry (``lanes_ref``,
``cuda``, ``exact``) and the device-resident ``WriteStats``.
"""
from repro_torch.memory.backends import (  # noqa: F401
    Backend, LeafVectors, available_backends, default_backend, get_backend,
    register_backend)
from repro_torch.memory.plan import WritePlan, leaf_vectors  # noqa: F401
from repro_torch.memory.stats import WriteStats  # noqa: F401
