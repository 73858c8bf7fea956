"""repro_torch.memory — the EXTENT write-path substrate of the port.

``WritePlan`` (resolve-once policy), the single-tensor ``write``, the
backend registry (``oracle``, ``lanes_ref``, ``cuda``, ``exact``), the
device-resident ``WriteStats``, the physical addressing layer
(``AddressSpec``, ``AddressState``) and ``MemoryRegion``, a tree of
tensors that is written, ages and is scrubbed in approximate memory.
"""
from repro_torch.memory.address import (  # noqa: F401
    AddressSpec, AddressState)
from repro_torch.memory.backends import (  # noqa: F401
    Backend, LeafVectors, available_backends, default_backend, get_backend,
    register_backend)
from repro_torch.memory.plan import (  # noqa: F401
    WritePlan, leaf_vectors, write)
from repro_torch.memory.region import MemoryRegion  # noqa: F401
from repro_torch.memory.stats import WriteStats  # noqa: F401
